"""The ConvNeXt trunk (counterpart of ``cosmos_tpu/models/convnext.py``):
a 4x4/4 stem conv and LayerNorm, four stages of [depthwise 7x7 -> LayerNorm
-> 4x MLP -> layer scale] blocks with LayerNorm + 2x2/2 conv downsampling
between stages, and a global average pool with a final LayerNorm.

Activations are NHWC, as in the JAX package, so every LayerNorm normalises
the last (channel) axis through ``layers.LayerNorm``; the convs view the
tensor as NCHW with channels-last strides (``layers.Conv2d``).  Module and
parameter names are timm's ``convnext.py`` (``stem.0/1``,
``stages.S.downsample.0/1``, ``stages.S.blocks.B.{conv_dw, norm, mlp.fc1,
mlp.fc2, gamma}``, ``head.norm``), the layout the JAX package's
``convert_timm_convnext`` reads.

Stochastic depth acts only when the forward is given a ``torch.Generator``
(``drop_path``), as the JAX module acts only when given a ``drop_path``
rng; the training step gives neither.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .convert import rename_
from .layers import Conv2d, LayerNorm, Linear, gelu
from .transformer import remat_context_fn, run_block

# timm model name -> (depths, dims), the JAX package's CONVNEXT_CONFIGS
CONVNEXT_CONFIGS: Dict[str, Dict[str, Any]] = {
    "convnext_tiny": dict(depths=(3, 3, 9, 3), dims=(96, 192, 384, 768)),
    "convnext_small": dict(depths=(3, 3, 27, 3), dims=(96, 192, 384, 768)),
    "convnext_base": dict(depths=(3, 3, 27, 3), dims=(128, 256, 512, 1024)),
    "convnext_large": dict(depths=(3, 3, 27, 3), dims=(192, 384, 768, 1536)),
    "convnext_xlarge": dict(depths=(3, 3, 27, 3), dims=(256, 512, 1024, 2048)),
    "convnext_xxlarge": dict(depths=(3, 4, 30, 3), dims=(384, 768, 1536, 3072)),
}


def register_convnext(name: str, *, depths: Sequence[int],
                      dims: Sequence[int]) -> None:
    """Register another ConvNeXt geometry."""
    CONVNEXT_CONFIGS[name] = dict(depths=tuple(depths), dims=tuple(dims))


class _Mlp(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(dim, 4 * dim, dtype=dtype)
        self.fc2 = Linear(4 * dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """dwconv 7x7 -> LN -> Linear(4x) -> GELU -> Linear -> gamma, residual."""

    def __init__(self, dim: int, drop_path: float = 0.0,
                 ls_init: float = 1e-6, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.drop_path = drop_path
        self.ls_init = ls_init
        self.conv_dw = Conv2d(dim, dim, 7, padding=3, groups=dim, dtype=dtype)
        self.norm = LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, dtype)
        self.gamma = nn.Parameter(torch.empty(dim))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.gamma, self.ls_init)

    def forward(self, x: torch.Tensor,
                keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``keep``: [B] 0/1 per sample, the stochastic-depth draw."""
        h = self.mlp(self.norm(self.conv_dw(x)))
        h = h * self.gamma.to(h.dtype)
        if keep is not None:
            rate = 1.0 - self.drop_path
            h = h * (keep.to(h.dtype) / rate)[:, None, None, None]
        return x + h


class _Stage(nn.Module):
    def __init__(self, in_dim: int, dim: int, depth: int, rates,
                 dtype: torch.dtype, downsample: bool):
        super().__init__()
        self.downsample = (nn.Sequential(
            LayerNorm(in_dim, eps=1e-6),
            Conv2d(in_dim, dim, 2, stride=2, dtype=dtype))
            if downsample else None)
        self.blocks = nn.ModuleList(
            ConvNeXtBlock(dim, float(r), dtype=dtype) for r in rates)


class _Head(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = LayerNorm(dim, eps=1e-6)


class ConvNeXt(nn.Module):
    """ConvNeXt trunk: ``(pooled [B, dims[-1]], tokens [B, N, dims[-1]])``,
    ``pooled`` the head norm of the global average pool, ``tokens`` the
    head norm of each final-stage position."""

    def __init__(self, model_name: str, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        g = CONVNEXT_CONFIGS[model_name]
        depths, dims = g["depths"], g["dims"]
        self.dtype = dtype
        self.num_features = dims[-1]
        self.stem = nn.Sequential(Conv2d(3, dims[0], 4, stride=4,
                                         dtype=dtype),
                                  LayerNorm(dims[0], eps=1e-6))
        # per-block drop-path rates ramp linearly over the whole depth
        rates = np.linspace(0.0, drop_path_rate, sum(depths))
        done, stages = 0, []
        for s, (depth, dim) in enumerate(zip(depths, dims)):
            stages.append(_Stage(dims[s - 1] if s else dim, dim, depth,
                                 rates[done:done + depth], dtype, s > 0))
            done += depth
        self.stages = nn.ModuleList(stages)
        self.head = _Head(dims[-1])
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)

    def forward(self, images: torch.Tensor,
                drop_path: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``drop_path``: the generator of stochastic depth (per sample and
        block, drawn on the CPU); without it no path is dropped."""
        x = self.stem(images.to(self.dtype))
        for stage in self.stages:
            if stage.downsample is not None:
                x = stage.downsample(x)
            for block in stage.blocks:
                keep = None
                if block.drop_path > 0.0 and drop_path is not None:
                    keep = (torch.rand(x.shape[0], generator=drop_path)
                            < 1.0 - block.drop_path).to(x.device)
                x = run_block(block, self.remat, self._context_fn, x, keep)
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        return self.head.norm(tokens.mean(dim=1)), self.head.norm(tokens)


# --- timm checkpoint conversion (cosmos_tpu/models/convnext.py:170-221) ---

def infer_timm_convnext_name(sd: Dict[str, Any]) -> str:
    """Match a timm ConvNeXt state dict to a registered geometry."""
    dim0 = int(sd["stem.0.weight"].shape[0])
    depths = []
    for s in range(4):
        keys = [k for k in sd if k.startswith(f"stages.{s}.blocks.")]
        if not keys:
            break
        depths.append(1 + max(int(k.split(".")[3]) for k in keys))
    depths = tuple(depths)
    for name, g in CONVNEXT_CONFIGS.items():
        if g["dims"][0] == dim0 and g["depths"] == depths:
            return name
    raise KeyError(
        f"no registered ConvNeXt geometry matches dims[0]={dim0} "
        f"depths={depths}; add one via register_convnext"
    )


def convert_timm_convnext(sd: Dict[str, Any], model_name: str
                          ) -> Dict[str, torch.Tensor]:
    """A timm ConvNeXt state dict as the trunk's state dict (timm's names
    below ``visual.trunk.``); the classifier ``head.fc`` is loaded by
    ``convert._maybe_load_timm_head``."""
    g = CONVNEXT_CONFIGS[model_name]
    mods = ["stem.0", "stem.1", "head.norm"]
    for s, depth in enumerate(g["depths"]):
        if s > 0:
            mods += [f"stages.{s}.downsample.0", f"stages.{s}.downsample.1"]
        for b in range(depth):
            p = f"stages.{s}.blocks.{b}"
            mods += [f"{p}.conv_dw", f"{p}.norm", f"{p}.mlp.fc1",
                     f"{p}.mlp.fc2"]
    keys = [f"{m}.{leaf}" for m in mods for leaf in ("weight", "bias")]
    keys += [f"stages.{s}.blocks.{b}.gamma"
             for s, depth in enumerate(g["depths"]) for b in range(depth)]
    return rename_(sd, [(k, k) for k in keys])
