"""The FastViT/MCi trunk of MobileCLIP-S1/S2 in its deploy form
(counterpart of ``cosmos_tpu/models/fastvit.py:78-268``): a stem of three
convs, four stages (RepMixer blocks in stages 0-2, attention blocks with a
head dim of 32 in stage 3, each with a ConvFFN), large-kernel downsampling
between stages, a conditional position conv before stage 3, and a grouped
conv expansion with squeeze-excite before the global average pool.

Activations are NHWC, as in the JAX package (``layers.Conv2d``).  Module
and parameter names are the JAX parameter tree's paths with dots
(``stem_0``, ``down_lkb_1``, ``net_3_blocks_0.attn.qkv``, ...), a
``kernel`` as torch's ``weight``.  The attention of stage 3 runs on stock
ops, as the JAX package runs it on XLA: logits in the compute dtype, a
float32 softmax.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear, gelu
from .transformer import remat_context_fn, run_block

# timm/Apple model name -> MCi geometry (the JAX package's FASTVIT_CONFIGS)
FASTVIT_CONFIGS: Dict[str, Dict[str, Any]] = {
    "fastvit_mci0": dict(layers=(2, 6, 10, 2), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3)),
    "fastvit_mci1": dict(layers=(4, 12, 20, 4), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3)),
    "fastvit_mci2": dict(layers=(4, 12, 24, 4), dims=(80, 160, 320, 640),
                         mlp_ratios=(3, 3, 3, 3)),
}

_TOKEN_MIXERS = ("repmixer", "repmixer", "repmixer", "attention")
_POS_EMBS = (False, False, False, True)   # the position conv before stage 3
_CLS_RATIO = 2.0                          # conv_exp: C -> 2C
_ATTN_HEAD_DIM = 32
_DOWN_KERNEL, _DOWN_STRIDE = 7, 2


def register_fastvit(name: str, *, layers: Sequence[int],
                     dims: Sequence[int],
                     mlp_ratios: Sequence[int] = (3, 3, 3, 3)) -> None:
    """Register another MCi/FastViT geometry."""
    FASTVIT_CONFIGS[name] = dict(layers=tuple(layers), dims=tuple(dims),
                                 mlp_ratios=tuple(mlp_ratios))


def _conv(in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype,
          stride: int = 1, groups: int = 1) -> Conv2d:
    """The JAX package's ``_conv``: symmetric padding kernel // 2."""
    return Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups,
                  dtype=dtype)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd_ratio: float = 1.0 / 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.reduce = Linear(channels, rd, dtype=dtype)
        self.expand = Linear(rd, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.mean(dim=(1, 2))                           # [B, C]
        w = torch.sigmoid(self.expand(F.relu(self.reduce(w))))
        return x * w[:, None, None, :]


class MHSA(nn.Module):
    """Attention over the flattened grid, head dim 32, bias-free qkv."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = c // _ATTN_HEAD_DIM
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(
            b, h * w, 3, heads, _ATTN_HEAD_DIM)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        att = torch.matmul(q, k.transpose(-1, -2)) * _ATTN_HEAD_DIM ** -0.5
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        o = torch.matmul(att, v).transpose(1, 2).reshape(b, h * w, c)
        return self.proj(o).reshape(b, h, w, c)


class ConvFFN(nn.Module):
    """depthwise 7x7 -> Linear -> GELU -> Linear."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _conv(dim, dim, 7, dtype, groups=dim)
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(self.conv(x))))


class RepMixerBlock(nn.Module):
    """One fused depthwise 3x3 (identity and layer scale folded in), then
    the ConvFFN residual."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mixer = _conv(dim, dim, 3, dtype, groups=dim)
        self.convffn = ConvFFN(dim, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mixer(x)
        return x + self.convffn(x)


class AttentionBlock(nn.Module):
    """The inference BatchNorm as a per-channel affine, then attention and
    the ConvFFN, each residual."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.attn = MHSA(dim, dtype)
        self.convffn = ConvFFN(dim, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x * self.norm_scale.to(x.dtype) + self.norm_bias.to(x.dtype)
        x = x + self.attn(h)
        return x + self.convffn(x)


class FastVit(nn.Module):
    """MCi/FastViT trunk: ``(pooled [B, 2 dims[-1]], tokens [B, N,
    2 dims[-1]])``, the tokens the flattened final feature map."""

    def __init__(self, model_name: str, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__()
        g = FASTVIT_CONFIGS[model_name]
        layers, dims, ratios = g["layers"], g["dims"], g["mlp_ratios"]
        self.dtype = dtype
        self.stem_0 = _conv(3, dims[0], 3, dtype, stride=2)
        self.stem_1 = _conv(dims[0], dims[0], 3, dtype, stride=2,
                            groups=dims[0])
        self.stem_2 = _conv(dims[0], dims[0], 1, dtype)
        self.stages = []
        for s, (depth, dim, ratio) in enumerate(zip(layers, dims, ratios)):
            names = []
            if s > 0:
                self.add_module(f"down_lkb_{s}", _conv(
                    dims[s - 1], dim, _DOWN_KERNEL, dtype,
                    stride=_DOWN_STRIDE, groups=dims[s - 1]))
                self.add_module(f"down_pw_{s}", _conv(dim, dim, 1, dtype))
            if _POS_EMBS[s]:
                self.add_module(f"pos_emb_{s}",
                                _conv(dim, dim, 7, dtype, groups=dim))
            block = (RepMixerBlock if _TOKEN_MIXERS[s] == "repmixer"
                     else AttentionBlock)
            for b in range(depth):
                names.append(f"net_{s}_blocks_{b}")
                self.add_module(names[-1], block(dim, dim * ratio, dtype))
            self.stages.append(names)
        final = int(dims[-1] * _CLS_RATIO)
        self.num_features = final
        self.conv_exp = _conv(dims[-1], final, 3, dtype, groups=dims[-1])
        self.conv_exp_se = SqueezeExcite(final, dtype=dtype)
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.to(self.dtype)
        x = gelu(self.stem_0(x))
        x = gelu(self.stem_1(x))
        x = gelu(self.stem_2(x))
        for s, names in enumerate(self.stages):
            if s > 0:
                x = gelu(getattr(self, f"down_lkb_{s}")(x))
                x = gelu(getattr(self, f"down_pw_{s}")(x))
            if _POS_EMBS[s]:
                x = getattr(self, f"pos_emb_{s}")(x)
            for name in names:
                x = run_block(getattr(self, name), self.remat,
                              self._context_fn, x)
        x = gelu(self.conv_exp_se(self.conv_exp(x)))
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        return tokens.mean(dim=1), tokens
