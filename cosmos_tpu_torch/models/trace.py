"""Export of the serving encoders (counterpart of
``cosmos_tpu/models/trace.py``, the trainer's ``--trace``).

``trace_model`` exports the normalised ``encode_image(images, True)
["image_features"]`` and ``encode_text(tokens, True)["text_features"]`` (a
CoCa model's bare latents) with
``torch.export`` at a fixed batch and shape, as JAX exports its jitted
encoders.  Each program holds its tower's weights (JAX's StableHLO takes
``params`` as its first argument instead) and runs every self-attention the
live model sends to K1 as the ``cosmos_tpu_torch::fused_attention_fwd``
operator: on the card the loaded program launches K1.  The export runs on
fake tensors, so it launches nothing.

    artifacts = trace_model(model, batch_size=256)
    save_traced(artifacts, "traced")        # traced/encode_{image,text}.pt2
    encoders = load_traced("traced")         # {"encode_image": f, ...}
    features = encoders["encode_image"](images)
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from .clip import CLIP
from .coca import CoCa
from .config import is_coca


class _ImageEncoder(nn.Module):
    """``CLIP.encode_image``'s normalised features over the vision tower
    alone (no token outputs)."""

    output_all = False

    def __init__(self, model: CLIP):
        super().__init__()
        self.visual = model.visual

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return CLIP.encode_image(self, images, True)["image_features"]


class _TextEncoder(nn.Module):
    """``CLIP.encode_text``'s normalised features over the text tower
    alone (no token outputs)."""

    output_all = False
    _encode_text = CLIP._encode_text

    def __init__(self, model: CLIP):
        super().__init__()
        self.text_cfg, self.dtype = model.text_cfg, model.dtype
        if model.text_cfg.is_hf:
            self.text = model.text
            return
        self.token_embedding = model.token_embedding
        self.positional_embedding = model.positional_embedding
        self.transformer = model.transformer
        self.ln_final = model.ln_final
        self.text_projection = model.text_projection

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return CLIP.encode_text(self, tokens, True)["text_features"]


class _CoCaImageEncoder(nn.Module):
    """``CoCa.encode_image``'s normalised latent over the vision tower and
    the pooler alone."""

    def __init__(self, model: CoCa):
        super().__init__()
        self.dtype = model.dtype
        self.visual = model.visual
        self.attn_pool = model.attn_pool
        self.ln_attn_pool = model.ln_attn_pool

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return CoCa._encode_image(self, images)[0]


class _CoCaTextEncoder(nn.Module):
    """``CoCa.encode_text``'s normalised latent over the text tower
    alone."""

    def __init__(self, model: CoCa):
        super().__init__()
        self.text = model.text

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return CoCa._encode_text(self, tokens)[0]


def trace_model(model: Union[CLIP, CoCa], batch_size: int = 256,
                image_size: Optional[int] = None,
                context_length: Optional[int] = None
                ) -> Dict[str, "torch.export.ExportedProgram"]:
    """``{"encode_image": ..., "encode_text": ...}``: the exported
    programs of the normalised encoders on the model's device, for float32
    NHWC images ``[batch_size, S, S, 3]`` and int64 tokens ``[batch_size,
    context_length]``.  Exported without a gradient, so that the kernels
    are plain operator calls in the graph."""
    image_size = image_size or model.cfg.vision_cfg.image_size
    context_length = context_length or model.cfg.text_cfg.context_length
    dev = next(model.parameters()).device
    images = torch.zeros(batch_size, image_size, image_size, 3, device=dev)
    tokens = torch.zeros(batch_size, context_length, dtype=torch.long,
                         device=dev)
    encoders = ((_CoCaImageEncoder, _CoCaTextEncoder)
                if is_coca(model) else (_ImageEncoder, _TextEncoder))
    out = {}
    with torch.no_grad():
        for name, module, example in (
                ("encode_image", encoders[0](model), images),
                ("encode_text", encoders[1](model), tokens)):
            out[name] = torch.export.export(module, (example,),
                                            strict=False)
    return out


def save_traced(artifacts: Dict[str, "torch.export.ExportedProgram"],
                path: str) -> None:
    """Write each program as ``<path>/<name>.pt2``."""
    os.makedirs(path, exist_ok=True)
    for name, program in artifacts.items():
        torch.export.save(program, os.path.join(path, f"{name}.pt2"))


def load_traced(path: str) -> Dict[str, Callable[[torch.Tensor],
                                                 torch.Tensor]]:
    """The programs under ``path`` as callables ``(batch) -> features``,
    run without a gradient.  The port's kernel operators are registered
    first, so that the programs' operator calls resolve."""
    from ..ops import fused_attention  # noqa: F401  (registers K1, K2)
    from ..ops.experimental import (layer_norm, ln_matmul,  # noqa: F401
                                    mlp_block)

    out = {}
    for fname in sorted(os.listdir(path)):
        if not fname.endswith(".pt2"):
            continue
        module = torch.export.load(os.path.join(path, fname)).module()

        def run(batch: torch.Tensor, _module=module) -> torch.Tensor:
            with torch.no_grad():
                return _module(batch)

        out[fname[:-len(".pt2")]] = run
    return out
