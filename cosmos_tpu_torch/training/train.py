"""The training step (counterpart of ``cosmos_tpu/training/train.py``
``_build_step``).

One call of the step function does, in the reference's order:

  - the student's forward and the loss of the step's mode: COSMOS
    (``COSMOSLoss`` against the EMA teacher's forward on the 2 global crops
    and the first 2 caption views, ``torch.no_grad``), plain CLIP
    (``ClipLoss`` over every view), SigLIP (``SigLipLoss``), distillation
    (``DistillClipLoss`` against a frozen second model's forward on the same
    views) or CoCa (``CoCaLoss`` on one view: the first global crop and the
    first caption, with the captioner's labels); every self-attention that
    JAX sends to its kernel through K1 and K2 on the card;
  - the backward, once, or over ``accum_freq`` micro-batches: the plain
    CLIP step accumulates OpenCLIP's exact way (``_accum_exact``), COSMOS
    and SigLIP average the micro-batches' gradients;
  - under a ``torch.distributed`` process group, the mean of the trainable
    gradients, the loss and every metric across ranks (JAX's ``pmean``
    over the data axis of its ``shard_map``), in one collective;
  - the EMA update ``k + (1 - m)(q - k)`` from the PRE-update student;
  - AdamW over the trainable parameters with the gain/bias/LN/logit-scale
    weight-decay exemption, its LR taken from the schedule at the number of
    updates so far, after global-norm clipping of the trainable gradients;
  - the clamps of ``logit_scale`` and ``distill_logit_scale`` to
    ``[0, ln 100]`` on the student and the teacher.

The batch is views-leading, as in the JAX package: ``global_images``
``[2, B, H, W, 3]``, ``local_images`` ``[n, B, h, w, 3]`` (optional),
``texts`` ``[k, B, L]``, with a leading ``[A, ...]`` micro-batch axis when
``accum_freq`` is A > 1; uint8 images are normalised on the device.  Under
a process group B is this rank's block of the global batch: the losses
gather the features of every rank (``losses/contrastive.py``), and every
rank ends the step with the same student, teacher and optimizer state.

Beyond data parallelism (``make_train_step_gspmd``, JAX's GSPMD step, with
``create_train_state_gspmd`` or ``create_train_state_fsdp``): the student
and the teacher sharded over a mesh (``parallel/mesh.py``), tensor-parallel
over its model axis (``parallel/tp.py``) or ZeRO-3 over its data axis
(``parallel/fsdp.py``), or both.  Each model group holds one block of the
global batch; the loss gathers the features over the data axis's group, so
it is the global batch's, as JAX's GSPMD step computes it; FSDP's
reduce-scatter averages the gradients it shards, and the step averages the
others over the data axis; the EMA update runs on the local shards; the
clipping norm and the grad-norm metric are the whole gradient's.  On a
multislice mesh (``make_train_step`` with ``mesh``) the loss gathers within
the slice and then across slices (``gather_scope``), and every mean spans
all ranks.

LiT locking (``frozen_mask``, ``freeze``) is the reference's: frozen
parameters take no gradient (``requires_grad=False``) and are not in the
optimizer, so clipping, the grad-norm metric, the optimizer's state and the
cross-rank mean see the trainable parameters only.  Patch dropout draws
from a CPU ``torch.Generator`` seeded from (``seed``, 17, step[, rank][,
micro-batch]), JAX's keying of its stream, but not its bits; the rank
enters only in a world of more than one.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..losses.contrastive import (ClipLoss, CoCaLoss, COSMOSLoss,
                                  DistillClipLoss, SigLipLoss)
from ..models.config import is_coca
from ..models.convert import model_name_map
from ..parallel import distributed
from ..parallel.fsdp import is_fsdp_managed
from ..parallel.mesh import (DATA_AXIS, MODEL_AXIS, SLICE_AXIS, axis_group,
                             batch_sharding)

LN100 = 4.605170185988092  # ln(100)
_NO_DECAY = ("ln", "bias", "logit_scale", "bn")


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: not for tensors
    of fewer than 2 dims, nor for names holding ``ln``, ``bias``,
    ``logit_scale`` or ``bn`` (the JAX package's rule, applied to the
    port's names).  A timm tower's ``cls_token`` ``[1, 1, W]`` counts as
    the 1-D ``class_embedding`` it is in the JAX tree."""
    return {name: p.ndim >= 2 and not name.endswith("cls_token")
            and not any(t in name.lower() for t in _NO_DECAY)
            for name, p in model.named_parameters()}


_STEM = ("conv1_kernel", "conv1_bias", "class_embedding",
         "positional_embedding", "ln_pre")


def frozen_mask(model: nn.Module, lock_image: bool = False,
                lock_text: bool = False, unlocked_groups: int = 0,
                text_unlocked_layers: int = 0,
                text_freeze_layer_norm: Optional[bool] = None
                ) -> Dict[str, bool]:
    """Parameter name -> True where LiT locking freezes it (the JAX
    package's ``frozen_mask``, applied to each parameter's path in the
    weight bridge's name map).

    ``unlocked_groups`` > 0 keeps the last n image-tower groups trainable:
    group 1 is ``visual.proj``, group 2 the last block and ``ln_post``,
    groups 3.. the blocks before it, group ``layers + 2`` the stem
    (``conv1``, the class and position embeddings, ``ln_pre``); more
    groups than that raise.  ``text_unlocked_layers`` > 0 keeps the last n
    text blocks, ``ln_final`` and ``text_projection`` trainable.
    ``text_freeze_layer_norm``: None (the default) freezes the locked text
    tower's LayerNorms, as the reference's native tower does; False leaves
    every text LayerNorm (``ln_*``) trainable.

    An HF text tower (BERT family) follows the reference's module list:
    ``[embeddings, *encoder.layer][:-n]`` frozen (all of them for n = 0),
    the pooler and the projection head never; its LayerNorms stay
    trainable unless ``text_freeze_layer_norm`` is True.  A T5, DistilBERT,
    ALBERT, GPT-2, OPT, Llama, Mistral or Gemma tower has no
    ``encoder.layer`` and ``lock_text`` raises, as in JAX.

    A timm-family or ModifiedResNet tower has no groups: ``lock_image``
    freezes all of it, and ``unlocked_groups`` > 0 raises, as in JAX."""
    vit = hasattr(model.visual, "transformer")
    v_layers = len(model.visual.transformer.resblocks) if vit else 0
    hf = getattr(model, "text_cfg", None) is not None and model.text_cfg.is_hf
    # CoCa keeps its text tower under ``text``
    t_layers = 0 if hf else len(
        getattr(model, "text", model).transformer.resblocks)
    paths = {key: path for key, path, _ in model_name_map(model)}
    if not vit:
        # every parameter of the tower sits under the tree's "visual"
        paths.update({name: ("visual",) for name, _ in
                      model.visual.named_parameters(prefix="visual")})
    unlocked_layers, text_unlocked = set(), set()
    proj_unlocked = lnpost_unlocked = stem_unlocked = False
    if lock_image and unlocked_groups > 0:
        if not vit:
            raise ValueError(
                "--lock-image-unlocked-groups needs a ViT image tower "
                "(per-group unlocking is undefined for this tower)")
        if unlocked_groups > v_layers + 2:
            raise ValueError(
                f"--lock-image-unlocked-groups {unlocked_groups} exceeds the "
                f"{v_layers + 2} lock groups of this tower")
        proj_unlocked = True
        lnpost_unlocked = unlocked_groups >= 2
        stem_unlocked = unlocked_groups >= v_layers + 2
        unlocked_layers = {f"resblocks_{v_layers - 1 - i}"
                           for i in range(min(unlocked_groups - 1, v_layers))}
    if lock_text and text_unlocked_layers > 0:
        text_unlocked = {f"resblocks_{t_layers - 1 - i}"
                         for i in range(min(text_unlocked_layers, t_layers))}
    freeze_ln = True if text_freeze_layer_norm is None \
        else text_freeze_layer_norm
    hf_frozen = None
    if lock_text and hf:
        # DistilBERT and the decoder LMs have no encoder, ALBERT's encoder
        # no layer list
        encoder = getattr(model.text.transformer, "encoder", None)
        layer = getattr(encoder, "layer", None)
        if layer is None:
            raise NotImplementedError(
                "--lock-text on an HF text tower needs the standard "
                "encoder.layer module layout (bert/roberta-family); this "
                "checkpoint's layout is not recognized")
        modules = ["embeddings"] + [str(i) for i in range(len(layer))]
        hf_frozen = set(modules[:-text_unlocked_layers]
                        if text_unlocked_layers else modules)

    def mark_hf(names) -> bool:
        """JAX's HF branch, on the tree path ``text/hf/...``."""
        if len(names) < 2 or names[1] != "hf":
            return False
        frozen = False
        if "embeddings" in names:
            frozen = "embeddings" in hf_frozen
        elif "layer" in names:
            li = names.index("layer")
            frozen = li + 1 < len(names) and names[li + 1] in hf_frozen
        if frozen and not text_freeze_layer_norm and "LayerNorm" in names:
            return False
        return frozen

    def mark(names) -> bool:
        top = names[0]
        if lock_image and top == "visual":
            return not ((proj_unlocked and "proj" in names)
                        or (lnpost_unlocked and "ln_post" in names)
                        or (stem_unlocked and any(n in _STEM for n in names))
                        or any(n in unlocked_layers for n in names))
        if lock_text and top == "text" and hf_frozen is not None:
            return mark_hf(names)
        if lock_text and top == "text":
            if text_unlocked_layers > 0 and any(
                    n in text_unlocked or n == "ln_final"
                    or n.startswith("text_projection") for n in names):
                return False
            return freeze_ln or not any(n.startswith("ln_") for n in names)
        return False

    out = {}
    for name, _ in model.named_parameters():
        if name not in paths:
            raise ValueError(f"{name}: no path in the weight bridge's map")
        out[name] = mark(paths[name])
    return out


def freeze(model: nn.Module, mask: Dict[str, bool]) -> None:
    """``requires_grad_(False)`` for the parameters ``mask`` marks, True for
    the others."""
    for name, p in model.named_parameters():
        p.requires_grad_(not mask[name])


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor, the tensor itself otherwise."""
    return t.to_local() if _is_dtensor(t) else t


def global_norm(tensors) -> torch.Tensor:
    """The 2-norm of the whole of ``tensors``, sharded or not (optax's
    ``global_norm`` of sharded leaves): a DTensor's local squares are summed
    over the groups of the mesh dims it is sharded on, a replicated tensor
    counts once."""
    import torch.distributed as dist

    plain, sharded = [], {}
    for t in tensors:
        sq = _local(t).float().pow(2).sum()
        if not _is_dtensor(t):
            plain.append(sq)
            continue
        dims = tuple(i for i, p in enumerate(t.placements) if p.is_shard())
        key = (id(t.device_mesh), dims)
        sharded.setdefault(key, (t.device_mesh, dims, []))[2].append(sq)
    parts = plain
    for mesh, dims, sqs in sharded.values():
        s = torch.stack(sqs).sum()
        for d in dims:
            dist.all_reduce(s, group=mesh.get_group(d))
        parts.append(s)
    device = parts[0].device
    return torch.stack([p.to(device) for p in parts]).sum().sqrt()


def _clip_sharded_(params, max_norm: float) -> None:
    """``clip_grad_norm_`` over the whole gradient of sharded ``params``:
    the same coefficient, ``max_norm / (norm + 1e-6)`` capped at 1."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    coef = torch.clamp(max_norm / (global_norm(grads) + 1e-6), max=1.0)
    for g in grads:
        local = _local(g)
        local.mul_(coef.to(local.device))


# the key of a sharded optimizer's param group that names the group it was
# cut from (``_split_sharded``; ``checkpoint.host_state`` merges them back)
WHOLE_GROUP = "whole_group"


def _split_sharded(groups) -> list:
    """Param groups of sharded parameters cut in two, their DTensors and
    their tensors (AdamW's foreach kernels take one kind or the other), each
    part keyed by ``WHOLE_GROUP``; a group with neither stays, empty."""
    out = []
    for i, g in enumerate(groups):
        kinds = ([p for p in g["params"] if _is_dtensor(p) == kind]
                 for kind in (True, False))
        parts = [q for q in kinds if q] or [[]]
        out += [dict(g, params=q, **{WHOLE_GROUP: i}) for q in parts]
    return out


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose LR is ``lr_schedule(updates so far)`` at every step (0
    on the first update, the count optax's schedule sees), with optional
    global-norm gradient clipping before the update.  Over sharded
    parameters each group is cut into its DTensors and its tensors
    (``_split_sharded``)."""

    def __init__(self, params: Sequence[Dict[str, Any]],
                 lr_schedule: Callable[[int], float],
                 grad_clip_norm: Optional[float] = None, **kwargs: Any):
        groups = [dict(g, params=list(g["params"])) for g in params]
        if any(_is_dtensor(p) for g in groups for p in g["params"]):
            groups = _split_sharded(groups)
        super().__init__(groups, lr=float(lr_schedule(0)), **kwargs)
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.num_updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.lr_schedule(self.num_updates))
        for group in self.param_groups:
            group["lr"] = lr
        params = [p for g in self.param_groups for p in g["params"]]
        sharded = any(_is_dtensor(p) for p in params)
        if self.grad_clip_norm is not None:
            if sharded:
                _clip_sharded_(params, self.grad_clip_norm)
            else:
                torch.nn.utils.clip_grad_norm_(params, self.grad_clip_norm)
        loss = super().step(closure)
        self.num_updates += 1
        return loss


def create_optimizer(
    model: nn.Module,
    lr_schedule: Callable[[int], float],
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    weight_decay: float = 0.2,
    grad_clip_norm: Optional[float] = None,
) -> ScheduledAdamW:
    """AdamW over two param groups, decayed (``wd_mask``) and not, of the
    parameters that require a gradient (call ``freeze`` first)."""
    mask = wd_mask(model)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]],
         "weight_decay": 0.0},
    ]
    return ScheduledAdamW(groups, lr_schedule, grad_clip_norm,
                          betas=(beta1, beta2), eps=eps)


@dataclasses.dataclass
class TrainStepConfig:
    # the step's mode: COSMOS, SigLIP, distillation or CoCa (at most one),
    # or none of them for the plain CLIP step
    cosmos: bool = True
    siglip: bool = False
    distill: bool = False
    coca: bool = False
    coca_caption_loss_weight: float = 2.0
    coca_contrastive_loss_weight: float = 1.0
    coca_pad_id: int = 0
    local_loss: bool = False
    # through the features' all-gather across ranks (see ClipLoss)
    gather_with_grad: bool = True
    # multislice: 'global' negatives across slices, or 'slice'-local
    gather_scope: str = "global"
    momentum_teacher: float = 0.999
    fix_momentum: bool = True
    momentum_schedule: Optional[Callable[[int], float]] = None
    lr_schedule: Optional[Callable[[int], float]] = None  # for the metric
    input_dtype: torch.dtype = torch.float32
    image_mean: Tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)
    # micro-batches per update, stacked on a leading axis of the batch:
    # the plain CLIP step accumulates exactly (the big batch's gradient),
    # COSMOS and SigLIP average the micro-batches' gradients
    accum_freq: int = 1
    # parameter name -> frozen (``frozen_mask``); the step freezes them
    frozen: Optional[Dict[str, bool]] = None
    # base seed of the patch-dropout stream
    seed: int = 0
    log_grad_norm: bool = False


@dataclasses.dataclass
class TrainState:
    step: int
    student: nn.Module
    teacher: nn.Module
    optimizer: torch.optim.Optimizer


def _teacher(model: nn.Module, teacher: Optional[nn.Module]) -> nn.Module:
    return (copy.deepcopy(model) if teacher is None
            else teacher).requires_grad_(False)


def create_train_state(model: nn.Module, optimizer: torch.optim.Optimizer,
                       teacher: Optional[nn.Module] = None) -> TrainState:
    """Student, its EMA teacher (``teacher``, or a copy of the student;
    it takes no gradient) and the optimizer."""
    return TrainState(step=0, student=model,
                      teacher=_teacher(model, teacher), optimizer=optimizer)


def _clamp_logit_scales(model: nn.Module) -> None:
    for name in ("logit_scale", "distill_logit_scale"):
        p = getattr(model, name, None)
        if p is not None:
            p.clamp_(0.0, LN100)


def _views(x: torch.Tensor, v: int) -> torch.Tensor:
    """[V*B, ...] views-major -> [V, B, ...]."""
    return x.reshape(v, x.shape[0] // v, *x.shape[1:])


def patch_drop_generator(seed: int, step: int, micro: Optional[int] = None,
                         rank=None) -> torch.Generator:
    """The CPU generator of the student's patch dropout at ``step`` on
    ``rank`` (and micro-batch ``micro`` of the exact accumulation): seeded
    from (seed, 17, step[, rank], micro), where 17 tags the stream apart
    from the other uses of the seed, as JAX folds its key (and the device's
    index on the data axis).  ``rank`` None is a one-process run; a tuple
    folds several indices (on a multislice mesh: the data index, then the
    slice index, JAX's order)."""
    ranks = () if rank is None else (
        tuple(rank) if isinstance(rank, tuple) else (rank,))
    key = (seed % 2 ** 63, 17, step, *ranks,
           0 if micro is None else micro + 1)
    state = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def _trainable(model: nn.Module):
    return [p for p in model.parameters() if p.grad is not None]


def _trainable_grads(model: nn.Module):
    return [p.grad for p in _trainable(model)]


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: TrainStepConfig,
                    dist_model: Optional[nn.Module] = None,
                    mesh=None, global_batch: bool = False
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Dict[str, Any]]:
    """Returns ``step(state, batch) -> metrics``, which updates the state's
    student, teacher and optimizer in place and advances ``state.step``.
    ``dist_model``: the frozen model of ``cfg.distill``, kept out of the
    state (never updated, averaged or saved).  ``mesh`` (None: the default
    process group as the data axis): a ('data',), ('slice', 'data') or
    ('data', 'model') mesh of ``parallel/mesh.py``; the losses gather over
    its data axis (and across slices), the step averages over the ranks
    that hold other blocks of the batch, and the patch-dropout stream folds
    in the data index, so the ranks of one model group drop the same
    patches.  ``global_batch`` (the GSPMD step's): the loss is the global
    batch's, as JAX's GSPMD step computes it: CoCa's caption cross-entropy
    is the mean over the global batch's unpadded tokens, not the mean of
    the data ranks' means.

    Metrics: ``loss``, the mode's losses (COSMOS: ``clip_loss``,
    ``distill_loss``; CLIP and SigLIP: ``contrastive_loss``; distillation:
    ``contrastive_loss``, ``distill_loss``; CoCa: ``contrastive_loss``,
    ``caption_loss``) and ``logit_scale`` as detached
    0-d tensors on the model's device (reading one syncs the host),
    ``momentum`` and ``lr`` as floats, and ``grad_norm`` when
    ``cfg.log_grad_norm``."""
    if sum((cfg.cosmos, cfg.siglip, cfg.distill, cfg.coca)) > 1:
        raise ValueError(
            "cosmos / siglip / distill / coca train modes are exclusive")
    if cfg.distill and dist_model is None:
        raise ValueError("cfg.distill needs the frozen dist_model module")
    if cfg.accum_freq > 1 and (cfg.distill or cfg.coca):
        # CoCa's accumulation would need the caption CE's denominators split
        raise ValueError("accum_freq > 1 unsupported with distill/coca")
    if cfg.coca != is_coca(model):
        raise ValueError("the CoCa step takes a CoCa model, and a CoCa "
                         "model trains in the CoCa step only")
    if cfg.accum_freq < 1:
        raise ValueError(f"accum_freq must be >= 1, got {cfg.accum_freq}")
    if cfg.cosmos and getattr(model, "distill_logit_scale", None) is None:
        raise ValueError("the COSMOS step needs a model built with "
                         "cosmos=True, output_all=True, attentional_pool=True")
    slice_group = axis_group(mesh, SLICE_AXIS)
    if mesh is not None and SLICE_AXIS in mesh.mesh_dim_names and cfg.siglip:
        raise ValueError("siglip is unsupported on a multislice "
                         "('slice','data') mesh")
    if cfg.frozen is not None:
        freeze(model, cfg.frozen)
        held = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if any(id(p) in held for n, p in model.named_parameters()
               if cfg.frozen[n]):
            raise ValueError("the optimizer holds frozen parameters: build "
                             "it after freeze(model, mask)")
    if dist_model is not None:
        dist_model.requires_grad_(False).eval()
    gather = dict(local_loss=cfg.local_loss,
                  gather_with_grad=cfg.gather_with_grad,
                  group=axis_group(mesh, DATA_AXIS), slice_group=slice_group,
                  gather_scope=cfg.gather_scope)
    if cfg.cosmos:
        loss_fn_obj = COSMOSLoss(**gather)
    elif cfg.siglip:
        loss_fn_obj = SigLipLoss()
    elif cfg.distill:
        loss_fn_obj = DistillClipLoss(**gather)
    elif cfg.coca:
        loss_fn_obj = CoCaLoss(
            caption_loss_weight=cfg.coca_caption_loss_weight,
            clip_loss_weight=cfg.coca_contrastive_loss_weight,
            pad_id=cfg.coca_pad_id, global_tokens=global_batch, **gather)
    else:
        loss_fn_obj = ClipLoss(**gather)
    device = next(model.parameters()).device
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32,
                        device=device) * 255.0
    inv_std = 1.0 / (torch.tensor(cfg.image_std, dtype=torch.float32,
                                  device=device) * 255.0)
    patch_drop = model.visual.patch_dropout > 0.0
    accum = cfg.accum_freq
    # each block of the batch draws its own patch-dropout stream in a world
    # of several; the mean of the gradients and metrics spans the ranks of
    # the other blocks: the data axis (every rank on a multislice mesh)
    mean_group = None
    if mesh is None:
        rank = distributed.rank() if distributed.world_size() > 1 else None
    else:
        names = mesh.mesh_dim_names
        index, count = batch_sharding(mesh)
        rank = None if count == 1 else (
            (mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(SLICE_AXIS))
            if SLICE_AXIS in names else index)
        if MODEL_AXIS in names:
            mean_group = axis_group(mesh, DATA_AXIS)

    def prep_images(x) -> torch.Tensor:
        """uint8 [..., H, W, 3] -> normalised ``input_dtype``."""
        x = torch.as_tensor(x).to(device, non_blocking=True)
        if x.dtype == torch.uint8:
            return ((x.float() - mean) * inv_std).to(cfg.input_dtype)
        return x.to(cfg.input_dtype)

    def unpack(mb):
        """(global crops, local crops or None, captions) flattened views-
        major, and their view counts and batch."""
        g = torch.as_tensor(mb["global_images"])
        vg, b = g.shape[0], g.shape[1]
        g_flat = prep_images(g.reshape(vg * b, *g.shape[2:]))
        loc = mb.get("local_images")
        l_flat, vl = None, 0
        if loc is not None:
            loc = torch.as_tensor(loc)
            vl = loc.shape[0]
            l_flat = prep_images(loc.reshape(vl * b, *loc.shape[2:]))
        t = torch.as_tensor(mb["texts"]).to(device, non_blocking=True)
        k = t.shape[0]
        return g_flat, l_flat, t.reshape(k * b, t.shape[2]), vg + vl, k, b

    def generator(step: int, micro: Optional[int] = None):
        return patch_drop_generator(cfg.seed, step, micro, rank) \
            if patch_drop else None

    def loss_fn(mb, teacher, step: int):
        """(total loss, {the mode's losses, logit_scale}) of one batch."""
        g_flat, l_flat, t_flat, vi, k, b = unpack(mb)
        gen = generator(step)
        if cfg.cosmos:
            if k < 2:
                # the teacher distills against two global caption views
                raise ValueError(
                    f"COSMOS training needs >= 2 caption views, got k={k}")
            s_out = model(g_flat, t_flat, l_flat, batch_size=b,
                          patch_drop=gen)
            with torch.no_grad():
                t_out = teacher(g_flat, t_flat[:2 * b])
                if hasattr(teacher, "reshard"):
                    # FSDP keeps the root's weights gathered after a
                    # forward, for the backward the teacher never runs
                    teacher.reshard()
            losses = loss_fn_obj(
                s_image_features=_views(s_out["image_features"], vi),
                s_text_features=_views(s_out["text_features"], k),
                logit_scale=s_out["logit_scale"],
                t_image_features=_views(t_out["image_features"], 2),
                t_text_features=_views(t_out["text_features"], 2),
                distill_logit_scale=s_out["distill_logit_scale"],
                s_img_crossmodal_features=_views(
                    s_out["img_crossmodal_features"], vi),
                s_txt_crossmodal_features=_views(
                    s_out["txt_crossmodal_features"], k),
                output_dict=True)
        elif cfg.coca:
            # one view: the decoder's CE is per caption, and the reference
            # recipe trains CoCa on plain (not multi-crop) transforms
            s_out = model(g_flat[:b], t_flat[:b], output_labels=True,
                          patch_drop=gen)
            losses = loss_fn_obj(s_out["image_features"],
                                 s_out["text_features"], s_out["logits"],
                                 s_out["labels"], s_out["logit_scale"],
                                 output_dict=True)
        else:
            s_out = model(g_flat, t_flat, l_flat, patch_drop=gen)
            img = _views(s_out["image_features"], vi)
            txt = _views(s_out["text_features"], k)
            if cfg.siglip:
                losses = loss_fn_obj(img[0], txt[0], s_out["logit_scale"],
                                     s_out.get("logit_bias"),
                                     output_dict=True)
            elif cfg.distill:
                with torch.no_grad():
                    d_out = dist_model(g_flat, t_flat, l_flat)
                losses = loss_fn_obj(
                    img, txt, s_out["logit_scale"],
                    _views(d_out["image_features"], vi),
                    _views(d_out["text_features"], k),
                    d_out["logit_scale"], output_dict=True)
            else:
                losses = loss_fn_obj(img, txt, s_out["logit_scale"],
                                     output_dict=True)
        total = sum(losses.values())
        return total, dict(losses, logit_scale=s_out["logit_scale"])

    def features(mb, step: int, micro: int):
        """(image views, text views, logit_scale) of one micro-batch: the
        eval-style forward, with the micro-batch's patch-dropout draw."""
        g_flat, l_flat, t_flat, vi, k, _ = unpack(mb)
        s_out = model(g_flat, t_flat, l_flat, patch_drop=generator(step,
                                                                   micro))
        return (_views(s_out["image_features"], vi),
                _views(s_out["text_features"], k), s_out["logit_scale"])

    def accum_exact(batch, step: int):
        """OpenCLIP's exact accumulation for the contrastive loss: pass 1
        caches every micro-batch's features without a gradient; pass 2
        re-forwards each micro-batch, with pass 1's patch-dropout draw, and
        takes the loss against the whole batch of negatives, so the summed
        gradients are the big batch's.  The logit scale and bias see the
        whole loss in every pass: their gradients are divided by A.
        Returns the last pass's loss and metrics."""
        micro = [{k: v[m] for k, v in batch.items()} for m in range(accum)]
        with torch.no_grad():
            cached = [features(mb, step, m)[:2] for m, mb in enumerate(micro)]
        img_cache = torch.cat([c[0] for c in cached], dim=1)   # [V, A*B, D]
        txt_cache = torch.cat([c[1] for c in cached], dim=1)
        for m, mb in enumerate(micro):
            img_m, txt_m, scale = features(mb, step, m)
            b = img_m.shape[1]

            def splice(cache, part):
                return torch.cat([cache[:, :m * b], part,
                                  cache[:, (m + 1) * b:]], dim=1)

            losses = loss_fn_obj(splice(img_cache, img_m),
                                 splice(txt_cache, txt_m), scale,
                                 output_dict=True)
            total = sum(losses.values())
            total.backward()
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.grad is not None and ("logit_scale" in name
                                           or "logit_bias" in name):
                    p.grad.div_(accum)
        return total, dict(losses, logit_scale=scale)

    def accum_mean(batch, teacher, step: int):
        """Each micro-batch's own loss and backward; the gradients, losses
        and metrics averaged over the A micro-batches."""
        total, aux = 0.0, {}
        for m in range(accum):
            t, a = loss_fn({k: v[m] for k, v in batch.items()}, teacher, step)
            t.backward()
            total = total + t.detach()
            aux = {k: aux.get(k, 0.0) + v.detach() for k, v in a.items()}
        with torch.no_grad():
            torch._foreach_mul_(_trainable_grads(model), 1.0 / accum)
        return total / accum, {k: v / accum for k, v in aux.items()}

    def step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the train state holds another model or "
                             "optimizer than this step was made for")
        student, teacher, opt = model, state.teacher, optimizer
        opt.zero_grad(set_to_none=True)
        if accum > 1:
            lead = torch.as_tensor(batch["global_images"]).shape[0]
            if lead != accum:
                raise ValueError(f"accum_freq {accum} needs [A, V, B, ...] "
                                 f"batches, got A={lead}")
            if cfg.cosmos or cfg.siglip:
                total, aux = accum_mean(batch, teacher, state.step)
            else:
                total, aux = accum_exact(batch, state.step)
        else:
            total, aux = loss_fn(batch, teacher, state.step)
            total.backward()
        # a trainable parameter the loss does not reach (an HF tower's
        # pooler under mean pooling) takes a zero gradient, so that AdamW
        # still decays it, as optax's does (a sharded one a zero shard)
        for p in student.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)

        params = list(student.parameters())
        metrics: Dict[str, Any] = {
            "loss": total.detach(),
            **{k: v.detach() for k, v in aux.items()}}
        grads = _trainable_grads(student)
        # JAX's pmean of the gradients and metrics over the data axis; the
        # identity without a process group.  FSDP's reduce-scatter has
        # averaged the gradients it shards already
        distributed.all_reduce_mean_(
            [_local(g) for p, g in zip(_trainable(student), grads)
             if not is_fsdp_managed(p)] + list(metrics.values()),
            group=mean_group)
        if cfg.log_grad_norm:
            if any(_is_dtensor(g) for g in grads):
                metrics["grad_norm"] = global_norm(grads)
            else:
                metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                    [torch.linalg.vector_norm(g.float()) for g in grads]))

        if cfg.fix_momentum or cfg.momentum_schedule is None:
            momentum = float(cfg.momentum_teacher)
        else:
            momentum = float(cfg.momentum_schedule(state.step))
        with torch.no_grad():
            # EMA from the pre-update student: k + (1 - m)(q - k), on the
            # local shards where the two are sharded alike
            torch._foreach_lerp_([_local(p) for p in teacher.parameters()],
                                 [_local(p) for p in params], 1.0 - momentum)
        opt.step()
        with torch.no_grad():
            _clamp_logit_scales(student)
            _clamp_logit_scales(teacher)

        metrics["momentum"] = momentum
        if cfg.lr_schedule is not None:
            metrics["lr"] = float(cfg.lr_schedule(state.step))
        state.step += 1
        return metrics

    return step


def make_train_step_gspmd(model: nn.Module, optimizer: torch.optim.Optimizer,
                          mesh, cfg: TrainStepConfig,
                          dist_model: Optional[nn.Module] = None
                          ) -> Callable[[TrainState, Dict[str, Any]],
                                        Dict[str, Any]]:
    """The step of a model sharded over ``mesh`` (JAX's
    ``make_train_step_gspmd``): tensor-parallel over a model axis, FSDP over
    the data axis, or both (``create_train_state_gspmd``,
    ``create_train_state_fsdp``).  The loss is the global batch's, through
    the data axis's gather (CoCa's caption cross-entropy over the global
    batch's tokens); JAX's three refusals hold, with its messages."""
    if cfg.siglip:
        raise ValueError(
            "siglip's ppermute ring needs the 1-D shard_map step")
    if cfg.local_loss:
        raise ValueError(
            "local_loss is a per-device concept; the GSPMD step computes "
            "global logits — leave it False")
    if cfg.accum_freq > 1:
        raise ValueError("accum_freq > 1 unsupported in the GSPMD step")
    return make_train_step(model, optimizer, cfg, dist_model, mesh=mesh,
                           global_batch=True)


def _sharded_state(model: nn.Module, make_optimizer, shard,
                   teacher: Optional[nn.Module]) -> TrainState:
    teacher = _teacher(model, teacher)
    shard(model)
    shard(teacher)
    return TrainState(step=0, student=model, teacher=teacher,
                      optimizer=make_optimizer(model))


def create_train_state_gspmd(model: nn.Module, make_optimizer, mesh,
                             teacher: Optional[nn.Module] = None
                             ) -> TrainState:
    """Student and EMA teacher (``teacher``, or a copy of the student)
    tensor-parallel over ``mesh``'s model axis (``parallel/tp.py``), in
    place, and ``make_optimizer(student)`` over the sharded parameters,
    whose Adam moments take their placement (JAX's
    ``create_train_state_gspmd``)."""
    from ..parallel.tp import shard_params_tp

    return _sharded_state(model, make_optimizer,
                          lambda m: shard_params_tp(m, mesh), teacher)


def create_train_state_fsdp(model: nn.Module, make_optimizer, mesh,
                            min_size: Optional[int] = None,
                            teacher: Optional[nn.Module] = None
                            ) -> TrainState:
    """Student and EMA teacher ZeRO-3 over ``mesh``'s data axis
    (``parallel/fsdp.py``; over a ('data', 'model') mesh tensor-parallel
    too), in place, and ``make_optimizer(student)`` (JAX's
    ``create_train_state_fsdp``)."""
    from ..parallel.fsdp import FSDP_MIN_SIZE, shard_params_fsdp

    size = FSDP_MIN_SIZE if min_size is None else min_size
    return _sharded_state(model, make_optimizer,
                          lambda m: shard_params_fsdp(m, mesh, size),
                          teacher)
