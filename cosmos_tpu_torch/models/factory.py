"""Model factory (counterpart of ``cosmos_tpu/models/factory.py``).

``create_model`` returns an ``nn.Module`` in eval mode on the requested
device.  Weights are initialised on the CPU from one ``torch.Generator``
seeded with ``seed``, so a seed gives the same weights on every device, and
are then moved.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..parallel import distributed
from .clip import CLIP
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
    device: Union[str, torch.device, None] = None,
    seed: int = 0,
    **overrides: Any,
) -> CLIP:
    """Build a native-ViT CLIP config (e.g. ViT-B-16, ViT-B-32) with random
    weights from ``seed``.  ``act_approx`` picks the tanh GELU,
    ``text_bucket > 0`` the length-bucketed text tower of the COSMOS
    training forward, ``fuse_ln`` the blocks' fused LayerNorm kernels (K5
    before the QKV projection, K6 for the MLP; the state dict is the same).
    ``grad_checkpointing`` recomputes every block in the backward, keeping
    what ``remat_policy`` names; ``use_flash`` is the attention tri-state
    (``False``: never K1/K2); ``force_patch_dropout`` sets the vision
    tower's patch dropout.  ``overrides`` follow ``build_clip_cfg``
    (``init_logit_scale``, ``init_logit_bias`` among them)."""
    dev = resolve_device(device)
    if force_patch_dropout is not None:
        overrides["vision_patch_dropout"] = force_patch_dropout
    if output_all:
        overrides["output_all"] = True
    if attentional_pool:
        overrides["attentional_pool"] = True
    if add_zero_attn:
        overrides["add_zero_attn"] = True
    cfg = build_clip_cfg(model_name, overrides)
    model = CLIP(cfg, cosmos=cosmos, dtype=resolve_dtype(precision),
                 act_approx=act_approx, text_bucket=text_bucket,
                 fuse_ln=fuse_ln, remat=grad_checkpointing,
                 remat_policy=remat_policy, use_flash=use_flash)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()


def get_tokenizer(model_name: str = ""):
    """The byte-BPE tokenizer at the config's context length (77 without a
    config).  The native-ViT configs the port builds all use it; a config
    that names an HF tokenizer is refused."""
    from ..data.tokenizer import SimpleTokenizer
    from .config import get_model_config

    cfg = get_model_config(model_name) if model_name else None
    text_cfg = (cfg or {}).get("text_cfg", {})
    if text_cfg.get("hf_tokenizer_name"):
        raise NotImplementedError(
            f"{model_name}: HF tokenizers are not ported (ROADMAP queue 1, "
            '"Not queued": it needs a download)')
    return SimpleTokenizer(context_length=text_cfg.get("context_length", 77))
