"""Model factory (counterpart of ``cosmos_tpu/models/factory.py``).

``create_model`` returns an ``nn.Module`` in eval mode on the requested
device.  Weights are initialised on the CPU from one ``torch.Generator``
seeded with ``seed``, so a seed gives the same weights on every device,
then a ``pretrained`` checkpoint (a path or a cached registry tag) is loaded
and the model moved.  ``precision`` stays the second positional argument;
``pretrained`` is a keyword, where the JAX package takes it second.
"""

from __future__ import annotations

import dataclasses
import os
import weakref
from typing import Any, Dict, Optional, Tuple, Union

import torch

from ..parallel import distributed
from .clip import CLIP
from .coca import CoCa
from .config import build_clip_cfg


def resolve_dtype(precision: str) -> torch.dtype:
    """Map a precision flag to the compute dtype (parameters stay float32)."""
    if precision in ("fp32", "float32", "amp_bf16_grad_fp32"):
        return torch.float32
    if precision in ("bf16", "pure_bf16", "amp", "amp_bf16", "amp_bfloat16",
                     "fp16", "pure_fp16"):
        return torch.bfloat16
    raise ValueError(f"unknown precision: {precision}")


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``None`` means the card: this rank's (``cuda:LOCAL_RANK``, set by
    ``parallel.distributed.init_distributed``) under a process group.
    Without CUDA that raises: nothing falls back to the CPU unless the
    caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if distributed.is_initialized():
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cuda")
    return torch.device(device)


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Call every module's own ``init_weights`` in module order."""
    with torch.no_grad():
        for module in model.modules():
            if hasattr(module, "init_weights"):
                module.init_weights(generator)


def create_model(
    model_name: str,
    precision: str = "fp32",
    *,
    pretrained: Optional[str] = None,
    cosmos: bool = False,
    output_all: bool = False,
    attentional_pool: bool = False,
    add_zero_attn: bool = False,
    act_approx: bool = False,
    text_bucket: int = 0,
    fuse_ln: bool = False,
    grad_checkpointing: bool = False,
    remat_policy: str = "",
    use_flash: Optional[bool] = None,
    force_patch_dropout: Optional[float] = None,
    force_quick_gelu: bool = False,
    force_image_size: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    **overrides: Any,
) -> Union[CLIP, CoCa]:
    """Build a CLIP config (the native ViT-B-16 and ViT-B-32, the timm-family
    towers of EVA02-B-16, EVA02-L-14, convnext_base_w, convnext_large_d and
    MobileCLIP-S1/S2/B, a ModifiedResNet config registered with
    ``config.add_model_config``), or a CoCa config (``coca_ViT-B-32``,
    ``coca_Tiny-Test``: ``models.coca.CoCa``, which takes
    ``grad_checkpointing``, ``remat_policy`` and ``use_flash`` of the
    options below and refuses ``cosmos``) with random weights from
    ``seed``; on
    the ``meta`` device, shapes only, with no weights drawn.
    ``act_approx`` picks the tanh GELU, ``text_bucket > 0`` the
    length-bucketed text tower of the COSMOS training forward, ``fuse_ln`` the blocks' fused LayerNorm kernels (K5
    before the QKV projection, K6 for the MLP; the state dict is the same).
    ``grad_checkpointing`` recomputes every block in the backward, keeping
    what ``remat_policy`` names; ``use_flash`` is the attention tri-state
    (``False``: never K1/K2); ``force_patch_dropout`` sets the vision
    tower's patch dropout.  ``overrides`` follow ``build_clip_cfg``
    (``init_logit_scale``, ``init_logit_bias`` among them).
    ``pretrained`` is a checkpoint path or a registry tag whose file is
    cached (``models/pretrained.py``), loaded by
    ``checkpoint.load_checkpoint``; the ``openai`` tag forces QuickGELU, as
    do ``force_quick_gelu`` and a config's ``quick_gelu``;
    ``force_image_size`` resizes the vision tower (a checkpoint's position
    table is resized to it).  An HF text tower whose ``text_hf_model_name``
    is a local directory loads that directory's weights
    (``hf_model.load_hf_pretrained``) unless ``text_hf_model_pretrained`` is
    off or ``pretrained`` is given."""
    dev = resolve_device(device)
    if pretrained and dev.type == "meta":
        raise ValueError("a meta-device model holds no weights to load into")
    if pretrained and str(pretrained).lower() == "openai":
        # OpenAI's towers use QuickGELU: their weights in erf-GELU towers
        # would change every MLP activation
        force_quick_gelu = True
    if force_patch_dropout is not None:
        overrides["vision_patch_dropout"] = force_patch_dropout
    if force_image_size is not None:
        overrides["vision_image_size"] = force_image_size
    if output_all:
        overrides["output_all"] = True
    if attentional_pool:
        overrides["attentional_pool"] = True
    if add_zero_attn:
        overrides["add_zero_attn"] = True
    cfg = build_clip_cfg(model_name, overrides)
    if force_quick_gelu:
        cfg = dataclasses.replace(cfg, quick_gelu=True)
    with torch.device("meta" if dev.type == "meta" else "cpu"):
        if cfg.multimodal_cfg is not None:
            # the CoCa dispatch takes the remat and attention flags only,
            # as JAX's does
            if cosmos:
                raise ValueError("--cosmos is a CLIP-model flag; CoCa "
                                 "configs train through the CoCa loss path")
            model = CoCa(cfg, dtype=resolve_dtype(precision),
                         remat=grad_checkpointing, remat_policy=remat_policy,
                         use_flash=use_flash)
        else:
            model = CLIP(cfg, cosmos=cosmos, dtype=resolve_dtype(precision),
                         act_approx=act_approx, text_bucket=text_bucket,
                         fuse_ln=fuse_ln, remat=grad_checkpointing,
                         remat_policy=remat_policy, use_flash=use_flash)
    if dev.type == "meta":
        return model.eval()
    init_weights(model, torch.Generator().manual_seed(seed))
    t = cfg.text_cfg
    if t.hf_model_name and t.hf_model_pretrained and not pretrained:
        # the HF tower's weights from its local directory; a pretrained
        # checkpoint supersedes them, as in JAX's factory
        from .hf_model import load_hf_pretrained

        load_hf_pretrained(model, t.hf_model_name)
    if pretrained:
        from .checkpoint import load_checkpoint
        from .pretrained import resolve_pretrained

        load_checkpoint(model, resolve_pretrained(model_name, pretrained))
    return model.to(dev).eval()


def get_tokenizer(model_name: str = "", context_length: Optional[int] = None,
                  **kwargs: Any):
    """The config's tokenizer at ``context_length``, by default the
    config's (77 without a config; 76 for CoCa).  A ``text_cfg`` that names
    an ``hf_tokenizer_name`` directory gets ``HFTokenizer`` (``kwargs``:
    ``clean``, ``strip_sep_token`` and the keywords ``hf_tokenizer.load``
    takes), any other ``SimpleTokenizer`` (``kwargs``: ``clean``,
    ``additional_special_tokens``, ``reduction_mask``, ``rng``).  A hub
    name is refused (a download)."""
    from ..data.tokenizer import HFTokenizer, SimpleTokenizer
    from .config import get_model_config

    cfg = get_model_config(model_name) if model_name else None
    text_cfg = (cfg or {}).get("text_cfg", {})
    if context_length is None:
        context_length = text_cfg.get("context_length", 77)
    hf_tok = text_cfg.get("hf_tokenizer_name")
    if hf_tok:
        if not os.path.isdir(hf_tok):
            raise NotImplementedError(
                f"{model_name}: HF tokenizers from the hub are not ported: "
                f"{hf_tok!r} is not a local directory, and a hub name needs "
                'a download ("Not queued")')
        return HFTokenizer(hf_tok, context_length=context_length or 77,
                           **kwargs)
    return SimpleTokenizer(context_length=context_length, **kwargs)


def pretrained_preprocess_defaults(
    model_name: str,
    pretrained: Optional[str],
    image_mean: Optional[Tuple[float, ...]] = None,
    image_std: Optional[Tuple[float, ...]] = None,
) -> Dict[str, Any]:
    """Preprocessing from the pretrained tag's registry entry: explicit
    arguments win, then the entry (MobileCLIP's identity mean/std and
    bilinear resize), then OpenAI's defaults."""
    from ..data.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD
    from .pretrained import get_pretrained_cfg

    pcfg = get_pretrained_cfg(model_name, pretrained) if pretrained else {}
    return {
        "mean": tuple(image_mean or pcfg.get("mean") or OPENAI_DATASET_MEAN),
        "std": tuple(image_std or pcfg.get("std") or OPENAI_DATASET_STD),
        "interpolation": pcfg.get("interpolation", "bicubic"),
        "resize_mode": pcfg.get("resize_mode", "shortest"),
    }


def create_model_and_transforms(
    model_name: str,
    pretrained: Optional[str] = None,
    precision: str = "fp32",
    *,
    image_mean: Optional[Tuple[float, ...]] = None,
    image_std: Optional[Tuple[float, ...]] = None,
    aug_cfg: Optional[Dict[str, Any]] = None,
    use_imagecrop_aug: bool = False,
    local_crops_number: int = 6,
    global_crops_number: int = 2,
    crop_scale: float = 0.4,
    **kwargs: Any,
):
    """``(model, train transform, eval transform)``; the transforms take
    the pretrained tag's preprocessing.  (The JAX package returns the
    parameters too; here the module holds them.)"""
    from ..data.transforms import (MulticropAugmentation, aug_cfg_to_dict,
                                   image_transform_eval,
                                   image_transform_train)

    aug_cfg = aug_cfg_to_dict(aug_cfg)
    model = create_model(model_name, precision, pretrained=pretrained,
                         **kwargs)
    pp = pretrained_preprocess_defaults(model_name, pretrained,
                                        image_mean, image_std)
    image_size = model.cfg.vision_cfg.image_size
    set_model_preprocess_cfg(model, {"size": image_size, **pp})
    if use_imagecrop_aug:
        train_tf = MulticropAugmentation(
            mean=pp["mean"], std=pp["std"], image_size=image_size,
            local_crops_number=local_crops_number,
            global_crops_number=global_crops_number, crop_scale=crop_scale)
    else:
        train_tf = image_transform_train(image_size, mean=pp["mean"],
                                         std=pp["std"], aug_cfg=aug_cfg)
    val_tf = image_transform_eval(image_size, mean=pp["mean"], std=pp["std"],
                                  interpolation=pp["interpolation"],
                                  resize_mode=pp["resize_mode"])
    return model, train_tf, val_tf


def create_model_from_pretrained(
    model_name: str,
    pretrained: Optional[str] = None,
    precision: str = "fp32",
    *,
    image_mean: Optional[Tuple[float, ...]] = None,
    image_std: Optional[Tuple[float, ...]] = None,
    return_transform: bool = True,
    **kwargs: Any,
):
    """A model with pretrained weights and its eval transform:
    ``(model, preprocess)``, or the model alone with
    ``return_transform=False``."""
    from ..data.transforms import image_transform_eval

    model = create_model(model_name, precision, pretrained=pretrained,
                         **kwargs)
    pp = pretrained_preprocess_defaults(model_name, pretrained,
                                        image_mean, image_std)
    size = model.cfg.vision_cfg.image_size
    set_model_preprocess_cfg(model, {"size": size, **pp})
    if not return_transform:
        return model
    return model, image_transform_eval(
        size, mean=pp["mean"], std=pp["std"],
        interpolation=pp["interpolation"], resize_mode=pp["resize_mode"])


# per-model preprocessing recorded by set_model_preprocess_cfg; an entry
# goes with its model
_PREPROCESS_OVERRIDES: "weakref.WeakKeyDictionary[torch.nn.Module, Dict]" = (
    weakref.WeakKeyDictionary())


def get_model_preprocess_cfg(model: CLIP) -> Dict[str, Any]:
    """The preprocessing a consumer of the model's checkpoint needs."""
    from ..data.constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

    cfg = {
        "size": model.cfg.vision_cfg.image_size,
        "mode": "RGB",
        "mean": OPENAI_DATASET_MEAN,
        "std": OPENAI_DATASET_STD,
        "interpolation": "bicubic",
        "resize_mode": "shortest",
    }
    cfg.update(_PREPROCESS_OVERRIDES.get(model, {}))
    return cfg


def set_model_preprocess_cfg(model: CLIP, preprocess_cfg: Dict[str, Any]
                             ) -> CLIP:
    """Record the checkpoint's preprocessing for ``model`` (read back by
    ``get_model_preprocess_cfg``); returns the model."""
    _PREPROCESS_OVERRIDES[model] = dict(preprocess_cfg)
    return model


def get_model_tokenize_cfg(model: CLIP) -> Dict[str, Any]:
    """The text tower's tokenizer geometry."""
    t = model.cfg.text_cfg
    return {"context_length": t.context_length, "vocab_size": t.vocab_size}


def create_loss(args):
    """The loss the trainer's flags name (COSMOS, SigLIP, distillation,
    CoCa's for a CoCa model, or plain CLIP)."""
    from ..losses.contrastive import (ClipLoss, CoCaLoss, COSMOSLoss,
                                      DistillClipLoss, SigLipLoss)

    if getattr(args, "cosmos", False):
        return COSMOSLoss(local_loss=args.local_loss,
                          gather_with_grad=args.gather_with_grad)
    if getattr(args, "siglip", False):
        return SigLipLoss()
    if getattr(args, "distill", False) or getattr(args, "distill_model",
                                                   None):
        return DistillClipLoss(local_loss=args.local_loss,
                               gather_with_grad=args.gather_with_grad)
    if "coca" in getattr(args, "model", "").lower():
        return CoCaLoss(
            caption_loss_weight=args.coca_caption_loss_weight,
            clip_loss_weight=args.coca_contrastive_loss_weight,
            local_loss=args.local_loss,
            gather_with_grad=args.gather_with_grad)
    return ClipLoss(local_loss=getattr(args, "local_loss", False),
                    gather_with_grad=getattr(args, "gather_with_grad", True))
