"""Multi-head attention for the CLIP towers (counterpart of
``cosmos_tpu/models/attention.py``).

``MultiheadAttention`` keeps torch's packed in-projection
(``in_proj_weight`` ``[3D, D]``, thirds q|k|v).  Self-attention, causal or
not, with no additive mask, no zero-attention slot and no CSA, goes through
the packed-QKV kernel (``ops.fused_attention``), which reads the
projection's ``[B, L, 3D]`` output directly, when JAX's gate
(``fused_attention.supported``: head dim, head group, and the length at the
compute dtype's width) sends the geometry to its kernel.
With ``ln=(scale, bias)`` (the blocks' ``fuse_ln``) the projection is K5,
the preceding LayerNorm fused into it (``ops.experimental.ln_matmul``).
Cross-attention, ``add_zero_attn``, additive masks and the lengths the gate
refuses use plain torch ops with the JAX package's XLA-path semantics:
logits in the compute dtype, softmax reduced in float32.  ``csa=True`` is
SCLIP's correlative self-attention, ``softmax(q qᵀ s) + softmax(k kᵀ s)``
applied to v (the weights of a row sum to 2), on the plain path only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.experimental.ln_matmul import ln_matmul
from ..ops.fused_attention import fused_attention_qkv, supported
from .layers import LayerNorm, Linear


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    # [B, L, D] -> [B, H, L, Dh]
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    # [B, H, L, Dh] -> [B, L, D]
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention over [B, H, L, Dh]; ``mask`` is additive [..., Lq, Lk].
    Logits stay in the compute dtype; the softmax reduces in float32."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    weights = torch.softmax(logits.float(), dim=-1)
    return torch.matmul(weights.to(v.dtype), v)


def correlative_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """SCLIP's CSA over [B, H, L, Dh] (``cosmos_tpu/models/attention.py``
    ``csa``): float32 logits q qᵀ s and k kᵀ s, the sum of their softmaxes
    cast to v's dtype before the product, as JAX casts it."""
    scale = q.shape[-1] ** -0.5
    qf, kf = q.float(), k.float()
    weights = (torch.softmax(torch.matmul(qf, qf.transpose(-1, -2)) * scale,
                             dim=-1)
               + torch.softmax(torch.matmul(kf, kf.transpose(-1, -2)) * scale,
                               dim=-1))
    return torch.matmul(weights.to(v.dtype), v)


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention (self or cross)."""

    def __init__(self, dim: int, num_heads: int, add_zero_attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.add_zero_attn = add_zero_attn
        self.dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.in_proj_weight, std=self.dim ** -0.5,
                        generator=generator)
        nn.init.zeros_(self.in_proj_bias)

    def forward(
        self,
        x: torch.Tensor,
        kv: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        causal: bool = False,
        ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        csa: bool = False,
    ) -> torch.Tensor:
        """``ln=(scale, bias)``: fuse the preceding LayerNorm into the packed
        QKV projection (K5, ``ops.experimental.ln_matmul``); ``x`` is then
        the un-normalised residual stream.  Self-attention only.
        ``csa``: correlative self-attention (SCLIP), never on K1."""
        d = self.dim
        xc = x.to(self.dtype)
        if ln is not None:
            if kv is not None:
                raise ValueError("the fused LayerNorm -> QKV projection is a "
                                 "self-attention path")
            # K5 rounds the projection weight and bias to the compute dtype,
            # as the JAX attention path casts them before ln_matmul
            qkv = ln_matmul(xc, ln[0], ln[1], self.in_proj_weight,
                            self.in_proj_bias)
        elif kv is None:
            qkv = F.linear(xc, self.in_proj_weight.to(self.dtype),
                           self.in_proj_bias.to(self.dtype))
        if (kv is None and mask is None and not csa and not self.add_zero_attn
                and supported(self.num_heads, d, x.shape[1],
                              xc.dtype.itemsize)):
            # packed path: the kernel reads every head by stride from the
            # row-major [B, L, 3D] projection output
            return self.out_proj(fused_attention_qkv(qkv, self.num_heads,
                                                     causal))

        if causal and mask is None:
            l_ = x.shape[1]
            above = torch.ones(l_, l_, dtype=torch.bool,
                               device=x.device).triu(1)
            mask = torch.zeros(l_, l_, device=x.device).masked_fill(
                above, -1e30)
        if kv is None:
            q, k, v = qkv.split(d, dim=-1)
        else:
            w = self.in_proj_weight.to(self.dtype)
            bias = self.in_proj_bias.to(self.dtype)
            kvc = kv.to(self.dtype)
            q = F.linear(xc, w[:d], bias[:d])
            k = F.linear(kvc, w[d:2 * d], bias[d:2 * d])
            v = F.linear(kvc, w[2 * d:], bias[2 * d:])
        if self.add_zero_attn:
            zeros = k.new_zeros(k.shape[:-2] + (1, d))
            k = torch.cat([k, zeros], dim=-2)
            v = torch.cat([v, zeros], dim=-2)
            if mask is not None:
                mask = F.pad(mask, (0, 1))
        qh, kh, vh = (_split_heads(t, self.num_heads) for t in (q, k, v))
        if csa:
            out = correlative_attention(qh, kh, vh)
        else:
            out = dot_product_attention(qh, kh, vh, mask=mask)
        return self.out_proj(_merge_heads(out))


class AttentionalCrossPooler(nn.Module):
    """Cross-attention pooler: LayerNorm on the queries and on the context,
    then attention of the queries over the context."""

    def __init__(self, dim: int, num_heads: int = 8,
                 add_zero_attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ln_q = LayerNorm(dim)
        self.ln_k = LayerNorm(dim)
        self.attn = MultiheadAttention(dim, num_heads,
                                       add_zero_attn=add_zero_attn,
                                       dtype=dtype)

    def forward(self, context: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return self.attn(self.ln_q(q), kv=self.ln_k(context))
