"""Residual transformer stack shared by both towers (counterpart of
``cosmos_tpu/models/transformer.py``, without remat).

``fuse_ln=True`` runs each block's pre-LayerNorms inside the following
kernels: ``ln_1`` → packed QKV projection as K5
(``ops.experimental.ln_matmul``) and ``ln_2`` → c_fc → act → c_proj as K6
(``ops.experimental.mlp_block``).  The blocks keep their ``ln_1``/``ln_2``
modules and hand their parameters to the kernels, so the state-dict names
are the same with and without it."""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .attention import MultiheadAttention
from .layers import LayerNorm, LayerScale, Mlp, gelu


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention and pre-LN MLP, each with an optional LayerScale."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False):
        super().__init__()
        self.fuse_ln = fuse_ln
        self.ln_1 = LayerNorm(width)
        self.attn = MultiheadAttention(width, num_heads, dtype=dtype)
        self.ls_1 = (LayerScale(width, ls_init_value)
                     if ls_init_value is not None else nn.Identity())
        self.ln_2 = LayerNorm(width)
        self.mlp = Mlp(width, int(width * mlp_ratio), act_fn=act_fn,
                       dtype=dtype)
        self.ls_2 = (LayerScale(width, ls_init_value)
                     if ls_init_value is not None else nn.Identity())

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        # the blocks of both towers are self-attention (kv is None and no
        # cross-attention), so the JAX gate reduces to fuse_ln
        if self.fuse_ln:
            x = x + self.ls_1(self.attn(
                x, causal=causal, ln=(self.ln_1.weight, self.ln_1.bias)))
            return x + self.ls_2(self.mlp(
                x, ln=(self.ln_2.weight, self.ln_2.bias)))
        x = x + self.ls_1(self.attn(self.ln_1(x), causal=causal))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads, mlp_ratio, ls_init_value,
                                   act_fn, dtype, fuse_ln)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        for block in self.resblocks:
            x = block(x, causal=causal)
        return x
