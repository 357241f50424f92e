"""The ranks of the port's data-parallel tests (tests/test_torch_distributed.py,
tests/test_torch_dp_train.py): gloo process groups on the CPU.

``spawn(fn, world, payload)`` starts ``world`` processes with
``torch.multiprocessing`` on a ``FileStore`` (no port), calls
``fn(rank, world, payload)`` in each under the process group, and returns
the ranks' results.  A spawned process imports this module again, and no
more: it imports no JAX, so a rank starts in the time torch takes.  The
JAX side of each comparison runs in the test's own process.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a spawn may take before its ranks are killed: a rank that misses
# a collective hangs the others
SPAWN_TIMEOUT = 120.0

TINY = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
            vision_width=32, vision_layers=1, vision_head_width=16,
            text_context_length=12, text_vocab_size=128, text_width=32,
            text_heads=2, text_layers=1)
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
SIGLIP = dict(init_logit_scale=float(np.log(10.0)), init_logit_bias=-10.0)
# the towers of ViT-B-16-SigLIP: a no-CLS, MAP-pooled, unprojected ViT with
# a biased patch embedding, and a text tower without a causal mask, 'last'
# pooling and a biased projection (the embedding width must be the ViT's)
SIGLIP_TOWERS = dict(vision_class_token=False, vision_patch_bias=True,
                     vision_no_proj=True, vision_no_ln_pre=True,
                     vision_pool_type="map", text_no_causal_mask=True,
                     text_pool_type="last", text_proj_bias=True)
LR, BETA1, EPS = 1e-3, 0.9, 1e-3
# an HF text tower: BERT at width 32, 2 layers, the vocabulary of TINY;
# mean pooling, so that its pooler takes no gradient (a zero one: AdamW
# decays it, as optax does)
HF_BERT = dict(
    text_hf_model_config=dict(model_type="bert", hidden_size=32,
                              num_hidden_layers=2, num_attention_heads=2,
                              intermediate_size=64, vocab_size=128,
                              max_position_embeddings=32),
    text_hf_model_pretrained=False, text_hf_pooler_type="mean_pooler")


def _entry(rank: int, world: int, store: str, fn: Callable, payload_path: str,
           out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        try:
            result = fn(rank, world, payload)
        except BaseException:
            with open(f"{out}.{rank}.err", "w") as f:
                f.write(traceback.format_exc())
            raise
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def start(fn: Callable, world: int, payload: Any,
          timeout: float = SPAWN_TIMEOUT) -> Callable[[], List[Any]]:
    """Start ``fn(rank, world, payload)`` on ``world`` gloo ranks and return
    the call that waits for them: it gives the results in rank order,
    raises with the ranks' tracebacks if one fails, and kills them all if
    they outlast ``timeout`` seconds from the start.  The caller may work
    (JAX's side of a comparison) while the ranks run."""
    tmp = tempfile.mkdtemp(prefix="torch_dp_")
    payload_path, out = f"{tmp}/payload.pkl", f"{tmp}/result"
    with open(payload_path, "wb") as f:
        pickle.dump(payload, f)
    ctx = mp.start_processes(
        _entry, args=(world, f"{tmp}/store", fn, payload_path, out),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def join() -> List[Any]:
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{fn.__name__} on {world} ranks outlasted "
                        f"{timeout} s")
            return [torch.load(f"{out}.{r}.pt", weights_only=False)
                    for r in range(world)]
        except Exception as e:
            errs = [open(f"{out}.{r}.err").read() for r in range(world)
                    if os.path.exists(f"{out}.{r}.err")]
            raise RuntimeError("\n".join(errs) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
            shutil.rmtree(tmp, ignore_errors=True)

    return join


def spawn(fn: Callable, world: int, payload: Any,
          timeout: float = SPAWN_TIMEOUT) -> List[Any]:
    """``fn(rank, world, payload)`` on ``world`` gloo ranks; the results in
    rank order (``start``, then its wait)."""
    return start(fn, world, payload, timeout)()


def block(x: np.ndarray, rank: int, world: int, axis: int = 1) -> np.ndarray:
    """This rank's contiguous block of the batch axis (JAX's
    ``shard_batch`` layout)."""
    b = x.shape[axis] // world
    return np.take(x, range(rank * b, (rank + 1) * b), axis=axis)


# --- the losses ---------------------------------------------------------

# case -> (loss, constructor kwargs); every case runs at every world size
LOSS_CASES = {
    "clip-global-grad": ("clip", dict(local_loss=False, gather_with_grad=True)),
    "clip-global-nograd": ("clip", dict(local_loss=False,
                                        gather_with_grad=False)),
    "clip-local-grad": ("clip", dict(local_loss=True, gather_with_grad=True)),
    "clip-local-nograd": ("clip", dict(local_loss=True,
                                       gather_with_grad=False)),
    "cosmos-global": ("cosmos", dict(local_loss=False)),
    "cosmos-local": ("cosmos", dict(local_loss=True)),
    "distill-global": ("distill", dict(local_loss=False)),
    "distill-local-nograd": ("distill", dict(local_loss=True,
                                             gather_with_grad=False)),
    "siglip-bidir": ("siglip", dict(bidir=True)),
    "siglip-one-way": ("siglip", dict(bidir=False)),
}
# the feature inputs of each loss: name -> views
LOSS_INPUTS = {
    "clip": {"image_features": 3, "text_features": 2},
    "cosmos": {"s_image_features": 4, "s_text_features": 3,
               "t_image_features": 2, "t_text_features": 2,
               "s_img_crossmodal_features": 4,
               "s_txt_crossmodal_features": 3},
    "distill": {"image_features": 2, "text_features": 2,
                "dist_image_features": 2, "dist_text_features": 2},
    "siglip": {"image_features": 1, "text_features": 1},
}
LOSS_SCALES = {"clip": ("logit_scale",),
               "cosmos": ("logit_scale", "distill_logit_scale"),
               "distill": ("logit_scale", "dist_logit_scale"),
               "siglip": ("logit_scale", "logit_bias")}


def loss_inputs(kind: str, batch: int, dim: int = 8, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """Unit-norm [V, batch, dim] features and the scales, from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, views in LOSS_INPUTS[kind].items():
        x = rng.standard_normal((views, batch, dim)).astype(np.float32)
        out[name] = x / np.linalg.norm(x, axis=-1, keepdims=True)
    for name in LOSS_SCALES[kind]:
        out[name] = np.float32(-2.0 if name == "logit_bias"
                               else rng.uniform(2.0, 12.0))
    return out


def call_loss(fn, kind: str, t: Dict[str, Any]):
    """The scalar loss of one case: DistillClipLoss's two terms summed."""
    if kind == "distill":
        return sum(fn(**t))
    if kind == "siglip":
        return fn(t["image_features"], t["text_features"], t["logit_scale"],
                  t["logit_bias"])
    return fn(**t)


def losses_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """Each case's loss on this rank, and its gradients with respect to
    this rank's feature blocks and the scales (none where the loss detaches
    an input)."""
    from cosmos_tpu_torch.losses import contrastive as C

    ctor = {"clip": C.ClipLoss, "cosmos": C.COSMOSLoss,
            "distill": C.DistillClipLoss, "siglip": C.SigLipLoss}
    out = {}
    for case, inputs in payload.items():
        kind, kw = LOSS_CASES[case]
        t = {k: torch.tensor(block(v, rank, world) if v.ndim == 3 else v,
                             requires_grad=True)
             for k, v in inputs.items()}
        loss = call_loss(ctor[kind](**kw), kind, t)
        loss.backward()
        out[case] = {"loss": loss.detach().numpy(),
                     **{k: v.grad.numpy() for k, v in t.items()
                        if v.grad is not None}}
    return out


# --- the training step --------------------------------------------------

# mode -> (model overrides, step config, micro-batches)
STEP_MODES = {
    "cosmos": (COSMOS, dict(cosmos=True), 1),
    "clip": ({}, dict(cosmos=False), 1),
    "clip-accum-exact": ({}, dict(cosmos=False, accum_freq=2), 2),
    "siglip": (SIGLIP, dict(cosmos=False, siglip=True), 1),
    "coca": ({}, dict(cosmos=False, coca=True, coca_caption_loss_weight=1.5),
             1),
    "hf": (HF_BERT, dict(cosmos=False), 1),
}
# mode -> the config it trains as it stands (the others: ViT-B-16 cut to
# TINY)
STEP_MODELS = {"coca": "coca_Tiny-Test"}
COCA_EOT = 511


def unequal_coca():
    """(name, config): coca_Tiny-Test with a 128-wide vision tower of head
    dim 64 (K1 and K2 take it) beside the 32-wide decoder, so the pooler
    projects its keys and values separately (``q_proj_weight``, ...).
    JAX's CoCa does not build at unequal widths."""
    from cosmos_tpu_torch.models import config as pconfig

    cfg = pconfig.get_model_config("coca_Tiny-Test")
    cfg["vision_cfg"] = dict(cfg["vision_cfg"], width=128, head_width=64)
    return "coca_Unequal-Test", cfg


@contextlib.contextmanager
def registered(config):
    """``config``, a (name, config dict), among the port's model configs
    for the block (a rank registers for good: ``step_model``)."""
    from cosmos_tpu_torch.models import config as pconfig

    pconfig._EXTRA_CONFIGS[config[0]] = config[1]
    try:
        yield
    finally:
        pconfig._EXTRA_CONFIGS.pop(config[0], None)


def perturbed(state: Dict[str, torch.Tensor], seed: int = 2,
              scale: float = 0.05) -> Dict[str, torch.Tensor]:
    """``state`` with seeded normal noise added to every floating tensor:
    the init's zero biases would hide a bias placed or added wrongly."""
    gen = torch.Generator().manual_seed(seed)
    return {k: v + scale * torch.randn(v.shape, generator=gen)
            if v.is_floating_point() else v for k, v in state.items()}


def coca_trainer_config():
    """(name, config): coca_Tiny-Test with the tokenizer's vocabulary,
    which the BPE ids of the seeded shards' captions need."""
    from cosmos_tpu_torch.models import config as pconfig

    cfg = pconfig.get_model_config("coca_Tiny-Test")
    cfg["text_cfg"] = dict(cfg["text_cfg"], vocab_size=49408)
    return "coca_Tiny-Test-49408", cfg


def step_batch(global_batch: int, accum: int, seed: int = 3
               ) -> Dict[str, np.ndarray]:
    """uint8 views of the global batch (2 global 16px, 2 local 8px crops,
    3 caption views), with a leading micro-batch axis when ``accum`` > 1."""
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum > 1 else ()
    return {
        "global_images": rng.integers(0, 256, lead + (2, global_batch, 16,
                                                      16, 3), np.uint8),
        "local_images": rng.integers(0, 256, lead + (2, global_batch, 8, 8,
                                                     3), np.uint8),
        "texts": rng.integers(1, 127, lead + (3, global_batch, 12)).astype(
            np.int32),
    }


def coca_step_batch(global_batch: int, seed: int = 3
                    ) -> Dict[str, np.ndarray]:
    """uint8 32px images and one caption view for coca_Tiny-Test, padded
    (id 0) in the first two rows only: at world 2 the first rank's caption
    cross-entropy averages fewer tokens than the second's."""
    rng = np.random.default_rng(seed)
    texts = rng.integers(1, COCA_EOT, (1, global_batch, 12)).astype(np.int32)
    texts[0, 0, 5:] = 0
    texts[0, 1, 8:] = 0
    return {"global_images": rng.integers(0, 256, (1, global_batch, 32, 32,
                                                   3), np.uint8),
            "texts": texts}


def step_model(mode: str, model_kw=None, config=None):
    """The port's model of a step mode on the CPU (``model_kw`` overrides
    TINY's widths, where the mode trains ViT-B-16; ``config``: (name,
    config dict) registered first and built instead)."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.models import config as pconfig

    if config is not None:
        pconfig._EXTRA_CONFIGS[config[0]] = config[1]
        return create_model(config[0], device="cpu")
    if mode in STEP_MODELS:
        return create_model(STEP_MODELS[mode], device="cpu")
    return create_model("ViT-B-16", device="cpu",
                        **dict(TINY, **(model_kw or {})), **STEP_MODES[mode][0])


def port_step(mode: str, init: Dict[str, Any], batch: Dict[str, np.ndarray],
              steps: int = 1, config=None) -> Dict[str, Any]:
    """``steps`` steps of the port's ``make_train_step`` from ``init`` on
    ``batch`` (this rank's block under a process group): the last metrics,
    the averaged gradients and the updated student and teacher
    (``config``: as ``step_model``'s)."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training import scheduler
    from cosmos_tpu_torch.training.train import TrainStepConfig

    cfg_kw = STEP_MODES[mode][1]
    model = step_model(mode, config=config)
    model.load_state_dict(init, strict=True)
    lr = scheduler.const_lr(LR, 0, 10)
    opt = create_optimizer(model, lr, beta1=BETA1, beta2=0.98, eps=EPS,
                           weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True, **cfg_kw)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    for _ in range(steps):
        metrics = step(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict()}


def steps_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """Each mode's step on this rank's block of the payload's batch."""
    out = {}
    for mode, (init, batch) in payload.items():
        axis = 2 if STEP_MODES[mode][2] > 1 else 1
        local = {k: block(v, rank, world, axis) for k, v in batch.items()}
        out[mode] = port_step(mode, init, local)
    return out


# --- the trainer --------------------------------------------------------

def trainer_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """``main([...])`` twice under the process group, a run of one epoch
    then ``--resume latest`` into a second, recording which ranks save,
    look for the latest checkpoint and restore which path, the texts of
    every batch the step receives, and the student and teacher each rank
    ends on."""
    from cosmos_tpu_torch.training import checkpoint, main as trainer, train

    calls = {"save": 0, "latest": 0, "restore": [], "texts": []}
    live = {}
    save, latest, restore = (checkpoint.save_checkpoint,
                             checkpoint.get_latest_checkpoint,
                             checkpoint.restore_checkpoint)
    make_step = train.make_train_step

    def counted_save(*a, **kw):
        calls["save"] += 1
        return save(*a, **kw)

    def counted_latest(*a, **kw):
        calls["latest"] += 1
        return latest(*a, **kw)

    def counted_restore(state, path):
        calls["restore"].append(path)
        return restore(state, path)

    def recorded_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch):
            calls["texts"].append(batch["texts"].numpy().copy())
            live["state"] = state
            return step(state, batch)
        return recorded

    checkpoint.save_checkpoint = counted_save
    checkpoint.get_latest_checkpoint = counted_latest
    checkpoint.restore_checkpoint = counted_restore
    train.make_train_step = recorded_make_step
    argv = payload["argv"]
    runs = [trainer.main(argv + ["--epochs", "1"], device="cpu"),
            trainer.main(argv + ["--epochs", "2", "--resume", "latest"],
                         device="cpu")]
    state = live["state"]
    return {"calls": calls, "group_kept": dist.is_initialized(),
            "losses": [line["loss"] for r in runs
                       for s in r["train_epoch_stats"] for line in s["logged"]],
            "val_loss": [r.get("clip_val_loss") for r in runs],
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict()}


# --- beyond data parallelism: FSDP, tensor parallelism, multislice --------

def trainer_argv(d: str, name: str, *extra: str) -> List[str]:
    """The trainer's flags for a tiny COSMOS run on the shards of
    ``write_trainer_data(d)``: 2 steps an epoch of 4 rows a data rank."""
    return ["--model", "ViT-Tiny-Test", "--dataset-type", "webdataset",
            "--train-data", f"{d}/train-{{0000..0003}}.tar",
            "--train-num-samples", "16", "--batch-size", "2",
            "--use-imagecrop-aug", "--local-crops-number", "2",
            "--caption-sampling-mode", "textcrop",
            "--num-sampled-captions", "3", "--cosmos", "--output-all",
            "--attentional-pool", "--add-zero-attn", "--fix-momentum",
            "--precision", "fp32", "--log-every-n-steps", "1",
            "--workers", "0", "--lr", "1e-3", "--warmup", "1", "--seed", "3",
            "--save-most-recent", "--val-data", f"{d}/val-0000.tar",
            "--val-num-samples", "4", "--logs-dir", f"{d}/logs",
            "--name", name, *extra]


def hf_trainer_config():
    """(name, config): ViT-Tiny-Test's vision tower with HF_BERT's text
    tower at the tokenizer's vocabulary."""
    from cosmos_tpu_torch.models import config as pconfig

    cfg = pconfig.get_model_config("ViT-Tiny-Test")
    cfg["text_cfg"] = {
        "context_length": 16, "hf_model_pretrained": False,
        "hf_pooler_type": HF_BERT["text_hf_pooler_type"],
        "hf_model_config": dict(HF_BERT["text_hf_model_config"],
                                vocab_size=49408)}
    return "hf-bert-Tiny-Test-49408", cfg


def coca_trainer_argv(d: str, name: str, *extra: str,
                      model: str = None) -> List[str]:
    """The trainer's flags for a CoCa run (``coca_trainer_config``; or a
    plain-CLIP run of ``model``) on the shards of
    ``write_trainer_data(d)``: one crop and one caption, 2 rows a data
    rank, the val eval."""
    return ["--model", model or coca_trainer_config()[0], "--dataset-type",
            "webdataset", "--train-data", f"{d}/train-{{0000..0003}}.tar",
            "--batch-size", "2", "--precision", "fp32",
            "--log-every-n-steps", "1", "--workers", "0", "--lr", "1e-3",
            "--warmup", "1", "--seed", "3", "--save-most-recent",
            "--val-data", f"{d}/val-0000.tar", "--val-num-samples", "4",
            "--logs-dir", f"{d}/logs", "--name", name, *extra]


def write_trainer_data(d: str) -> None:
    from cosmos_tpu_torch.data.synthetic import write_shards

    write_shards(f"{d}/train-{{i:04d}}.tar", 4, 8, seed=0, fmt="png",
                 size_range=(36, 72))
    write_shards(f"{d}/val-{{i:04d}}.tar", 1, 4, seed=1, fmt="png",
                 size_range=(36, 72))


def _mesh(kind: str, shape):
    """The mesh of ``kind`` over every rank (None: the default group)."""
    from cosmos_tpu_torch.parallel import mesh as M

    if kind in ("tp", "fsdp_tp"):
        return M.create_tp_mesh(*shape, "cpu")
    if kind == "multislice":
        return M.create_multislice_mesh(shape[0], device_type="cpu")
    if kind == "fsdp":
        return M.create_mesh(device_type="cpu")
    return None


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor

    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


def stateful_bytes(state) -> int:
    """This rank's bytes of student, teacher and Adam moments."""
    moments = [v for s in state.optimizer.state.values()
               for k, v in s.items() if k in ("exp_avg", "exp_avg_sq")]
    return _local_bytes([*state.student.parameters(),
                         *state.teacher.parameters(), *moments])


def model_sharded(model) -> List[str]:
    """The parameters sharded over a model axis."""
    from torch.distributed.tensor import DTensor, Shard

    return sorted(
        n for n, p in model.named_parameters() if isinstance(p, DTensor)
        and any(isinstance(pl, Shard) and ax == "model" for pl, ax in zip(
            p.placements, p.device_mesh.mesh_dim_names or ())))


class kernel_calls:
    """Counts the calls of K1's, K2's, K5's and K6's CPU implementations
    (their plain versions, looked up at call time) inside the block, and
    the widths K5 (``O``) and K6 (``HD``) were given: a rank's local
    shard's under tensor parallelism."""

    def __enter__(self):
        from cosmos_tpu_torch.ops import fused_attention as fa
        from cosmos_tpu_torch.ops.experimental import ln_matmul as lm
        from cosmos_tpu_torch.ops.experimental import mlp_block as mb

        self.counts = {"K1": 0, "K2": 0, "K5": 0, "K6": 0, "K5_widths": [],
                       "K6_widths": []}
        self.patched = [(fa, "fused_attention_qkv_reference", "K1"),
                        (fa, "fused_attention_qkv_backward_reference", "K2"),
                        (lm, "ln_matmul_reference", "K5"),
                        (mb, "mlp_block_reference", "K6")]
        self.saved = [getattr(m, name) for m, name, _ in self.patched]

        def counted(key, fn):
            def call(*a, **kw):
                self.counts[key] += 1
                if key in ("K5", "K6"):
                    # w [O, D] / w1 [HD, D]
                    self.counts[f"{key}_widths"].append(a[3].shape[0])
                return fn(*a, **kw)
            return call

        for (m, name, key), fn in zip(self.patched, self.saved):
            setattr(m, name, counted(key, fn))
        return self.counts

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.patched, self.saved):
            setattr(m, name, fn)


def sharded_step(kind: str, init, batch, shape=(), cfg_kw=None,
                 model_kw=None, min_size: int = 256, save: str = None,
                 fused_ln: bool = False, mode: str = "cosmos", config=None
                 ) -> Dict[str, Any]:
    """One step of ``mode`` (COSMOS by default) of the port from ``init``
    on this rank's block of the global ``batch``: 'dp' (the default group),
    'fsdp' (a data mesh),
    'tp'/'fsdp_tp' (a ('data', 'model') mesh of ``shape``) or
    'multislice' (``shape[0]`` slices), with ``layers.FUSED_LN`` set by
    ``fused_ln`` (``config``: as ``step_model``'s).  Returns the metrics,
    the whole student and teacher (on rank 0 for a sharded state), this
    rank's stateful bytes and kernel calls (``kernel_calls``) and, with
    ``save``, writes the checkpoint there (every rank joins the gather)."""
    from cosmos_tpu_torch import create_optimizer
    from cosmos_tpu_torch.models import layers
    from cosmos_tpu_torch.parallel.mesh import batch_sharding
    from cosmos_tpu_torch.training import checkpoint, scheduler
    from cosmos_tpu_torch.training import train as T

    model = step_model(mode, model_kw, config)
    model.load_state_dict(init, strict=True)
    lr = scheduler.const_lr(LR, 0, 10)

    def make_opt(m):
        return create_optimizer(m, lr, beta1=BETA1, beta2=0.98, eps=EPS,
                                weight_decay=0.5)

    cfg = T.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                            lr_schedule=lr, log_grad_norm=True,
                            **dict(STEP_MODES[mode][1], **(cfg_kw or {})))
    mesh = _mesh(kind, shape)
    if kind in ("fsdp", "fsdp_tp"):
        state = T.create_train_state_fsdp(model, make_opt, mesh, min_size)
        step = T.make_train_step_gspmd(model, state.optimizer, mesh, cfg)
    elif kind == "tp":
        state = T.create_train_state_gspmd(model, make_opt, mesh)
        step = T.make_train_step_gspmd(model, state.optimizer, mesh, cfg)
    else:
        opt = make_opt(model)
        state = T.create_train_state(model, opt)
        step = T.make_train_step(model, opt, cfg, mesh=mesh)
    index, count = (batch_sharding(mesh) if mesh is not None
                    else (dist.get_rank(), dist.get_world_size()))
    layers.FUSED_LN = fused_ln
    try:
        with kernel_calls() as calls:
            metrics = step(state, {k: torch.from_numpy(block(v, index, count))
                                   for k, v in batch.items()})
    finally:
        layers.FUSED_LN = False
    out = {"metrics": {k: float(v) for k, v in metrics.items()},
           "bytes": stateful_bytes(state), "calls": calls,
           "model_sharded": model_sharded(state.student)}
    if checkpoint.is_sharded(state):
        whole = checkpoint.host_state(state, optimizer=False)
    else:
        whole = {w: getattr(state, w).state_dict()
                 for w in ("student", "teacher")}
    out.update(student=whole["student"], teacher=whole["teacher"])
    if save:
        checkpoint.save_checkpoint(state, save, 1, write=dist.get_rank() == 0)
        dist.barrier()
    return out


def resumed(kind: str, path: str, shape=(), min_size: int = 256,
            model_kw=None) -> Dict[str, Any]:
    """A fresh state of ``kind`` restored from ``path``: the whole student,
    teacher and optimizer state it holds, and its counts."""
    from cosmos_tpu_torch import create_model, create_optimizer
    from cosmos_tpu_torch.training import checkpoint, scheduler
    from cosmos_tpu_torch.training import train as T

    model = create_model("ViT-B-16", device="cpu",
                         **dict(TINY, **(model_kw or {})), **COSMOS)
    lr = scheduler.const_lr(LR, 0, 10)

    def make_opt(m):
        return create_optimizer(m, lr, beta1=BETA1, beta2=0.98, eps=EPS,
                                weight_decay=0.5)

    mesh = _mesh(kind, shape)
    if kind in ("fsdp", "fsdp_tp"):
        state = T.create_train_state_fsdp(model, make_opt, mesh, min_size)
    elif kind == "tp":
        state = T.create_train_state_gspmd(model, make_opt, mesh)
    else:
        state = T.create_train_state(model, make_opt(model))
    epoch = checkpoint.restore_checkpoint(state, path)
    if checkpoint.is_sharded(state):
        whole = checkpoint.host_state(state)
    else:
        whole = {"student": state.student.state_dict(),
                 "teacher": state.teacher.state_dict(),
                 "optimizer": state.optimizer.state_dict()}
    return dict(whole, epoch=epoch, step=state.step,
                num_updates=state.optimizer.num_updates)


def tp_encoders(init, images, texts, shape, name, model_kw, eva=None
                ) -> Dict[str, Any]:
    """The port's TP encoders' features over a ``shape`` mesh, and the K1
    operator's calls per encoder call (``eva``: an EVA02 geometry to
    register first)."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.models import eva as peva
    from cosmos_tpu_torch.parallel.tp import make_tp_encoders

    if eva is not None:
        peva.register_eva(**eva)
    model = create_model(name, device="cpu", **model_kw).eval()
    model.load_state_dict(init, strict=True)
    _, enc_image, enc_text = make_tp_encoders(model, _mesh("tp", shape))
    with kernel_calls() as image_calls:
        img = enc_image(torch.from_numpy(images))
    with kernel_calls() as text_calls:
        txt = enc_text(torch.from_numpy(texts))
    return {"image": img, "text": txt, "k1_image": image_calls["K1"],
            "k1_text": text_calls["K1"]}


def trainer_runs(argvs, config=None) -> Dict[str, Any]:
    """``main(argv, device="cpu")`` for each of ``argvs`` in turn (with
    ``config``, a (name, config) registered first): the logged losses and
    metrics, the val loss and the epochs each run trained."""
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.training import main as trainer

    if config is not None:
        pconfig._EXTRA_CONFIGS[config[0]] = config[1]
    runs = [trainer.main(argv, device="cpu") for argv in argvs]
    return {"losses": [[line["loss"] for s in r["train_epoch_stats"]
                        for line in s["logged"]] for r in runs],
            "logged": [[line for s in r["train_epoch_stats"]
                        for line in s["logged"]] for r in runs],
            "epochs": [[s["epoch"] for s in r["train_epoch_stats"]]
                       for r in runs],
            "val_loss": [r.get("clip_val_loss") for r in runs]}


def beyond_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """Every case of ``payload`` on this rank: {name: (function name,
    kwargs)} over the functions above."""
    fns = {"sharded_step": sharded_step, "resumed": resumed,
           "tp_encoders": tp_encoders, "trainer_runs": trainer_runs}
    return {name: fns[fn](**kw) for name, (fn, kw) in payload.items()}
