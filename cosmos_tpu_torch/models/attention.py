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

Under tensor parallelism (``parallel/tp.py``) the packed projection's
weight and bias are DTensors sharded on the model axis: the projection
(``F.linear``, or K5 on each rank's column shard through its own rule)
then yields a feature-sharded ``qkv`` DTensor, which K1 takes through its
sharding rule (the columns all-gathered in front of the kernel); every
other path, cross-attention with packed or separate weights among them,
works on the whole local tensors (``_whole``).

``use_flash`` is JAX's tri-state (``resolve_fused``): ``False`` sends every
self-attention to the plain path (JAX's XLA path), so K1 and K2 never run;
``True`` and ``None`` (auto) take the kernel path wherever the gate admits
it, on a CPU tensor through the wrappers' plain versions (the counterpart
of JAX's interpret mode off the TPU).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.experimental.ln_matmul import ln_matmul
from ..ops.fused_attention import fused_attention_qkv, supported
from .layers import LayerNorm, Linear


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A tensor-parallel DTensor as the whole local tensor (a
    differentiable all-gather); any other tensor as it is."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _in_proj(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``x W^T + b`` in ``dtype``; with tensor-parallel (DTensor) weights
    the replicated input enters as a DTensor and the output is sharded on
    its features."""
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(weight, DTensor):
        x = DTensor.from_local(x, weight.device_mesh, [Replicate()],
                               run_check=False)
    return F.linear(x, weight.to(dtype), bias.to(dtype))


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
    Logits stay in the compute dtype; the softmax reduces in float32 (in
    float64 for float64 logits)."""
    logits = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if mask is not None:
        logits = logits + mask.to(logits.dtype)
    weights = torch.softmax(
        logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)
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


def causal_mask(length: int, device) -> torch.Tensor:
    """Additive [L, L] mask: -1e30 above the diagonal."""
    above = torch.ones(length, length, dtype=torch.bool,
                       device=device).triu(1)
    return torch.zeros(length, length, device=device).masked_fill(above,
                                                                  -1e30)


def packed_self_attention(qkv: torch.Tensor, num_heads: int,
                          causal: bool = False,
                          use_flash: Optional[bool] = None) -> torch.Tensor:
    """Self-attention of a packed ``[B, L, 3D]`` projection (thirds q|k|v)
    -> ``[B, L, D]``, routed as ``MultiheadAttention`` routes it: K1 where
    ``use_flash`` is not False and the gate admits the geometry, else the
    plain path."""
    d = qkv.shape[-1] // 3
    if use_flash is not False and supported(num_heads, d, qkv.shape[1],
                                            qkv.dtype.itemsize):
        return fused_attention_qkv(qkv, num_heads, causal)
    qkv = _whole(qkv)
    mask = causal_mask(qkv.shape[1], qkv.device) if causal else None
    q, k, v = (_split_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    return _merge_heads(dot_product_attention(q, k, v, mask=mask))


class MultiheadAttention(nn.Module):
    """Packed-QKV multi-head attention (self or cross).

    ``kdim``: the width of the keys' and values' input, when it is not
    ``dim`` (CoCa's pooler); the projections are then torch's separate
    ``q_proj_weight`` ``[D, D]``, ``k_proj_weight`` and ``v_proj_weight``
    ``[D, kdim]``, the layout of ``nn.MultiheadAttention(dim, heads, kdim=,
    vdim=)``, and the attention is cross-attention only."""

    def __init__(self, dim: int, num_heads: int, add_zero_attn: bool = False,
                 dtype: torch.dtype = torch.float32,
                 use_flash: Optional[bool] = None,
                 kdim: Optional[int] = None):
        super().__init__()
        self.dim = dim
        self.kdim = dim if kdim is None else kdim
        self.use_flash = use_flash
        self.num_heads = num_heads
        self.add_zero_attn = add_zero_attn
        self.dtype = dtype
        if self.kdim == dim:
            self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        else:
            self.in_proj_weight = None
            self.q_proj_weight = nn.Parameter(torch.empty(dim, dim))
            self.k_proj_weight = nn.Parameter(torch.empty(dim, self.kdim))
            self.v_proj_weight = nn.Parameter(torch.empty(dim, self.kdim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = Linear(dim, dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        if self.in_proj_weight is not None:
            nn.init.normal_(self.in_proj_weight, std=self.dim ** -0.5,
                            generator=generator)
        else:
            for w in (self.q_proj_weight, self.k_proj_weight,
                      self.v_proj_weight):
                nn.init.normal_(w, std=w.shape[1] ** -0.5,
                                generator=generator)
        nn.init.zeros_(self.in_proj_bias)

    def _qkv_weights(self) -> Tuple[torch.Tensor, ...]:
        """The q, k and v projection weights in the compute dtype."""
        if self.in_proj_weight is None:
            ws = tuple(_whole(w) for w in (self.q_proj_weight,
                                           self.k_proj_weight,
                                           self.v_proj_weight))
        else:
            ws = _whole(self.in_proj_weight).split(self.dim)
        return tuple(w.to(self.dtype) for w in ws)

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
            qkv = _in_proj(xc, self.in_proj_weight, self.in_proj_bias,
                           self.dtype)
        if kv is None and mask is None and not csa and not self.add_zero_attn:
            # packed path: the kernel reads every head by stride from the
            # row-major [B, L, 3D] projection output
            return self.out_proj(packed_self_attention(
                qkv, self.num_heads, causal, self.use_flash))

        if causal and mask is None:
            mask = causal_mask(x.shape[1], x.device)
        if kv is None:
            q, k, v = _whole(qkv).split(d, dim=-1)
        else:
            wq, wk, wv = self._qkv_weights()
            bias = _whole(self.in_proj_bias).to(self.dtype)
            kvc = kv.to(self.dtype)
            q = F.linear(xc, wq, bias[:d])
            k = F.linear(kvc, wk, bias[d:2 * d])
            v = F.linear(kvc, wv, bias[2 * d:])
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


class AttentionalPooler(nn.Module):
    """CoCa's learned-query pooler (``cosmos_tpu/models/attention.py``
    ``AttentionalPooler``): ``n_queries`` queries of width ``dim`` attend
    over the LayerNormed tokens of width ``context_dim``.

    JAX's pooler takes its width from its input; here it is ``dim``, the
    decoder's width, with the keys and values projected from
    ``context_dim`` (OpenCLIP's ``AttentionalPooler(d_model,
    context_dim)``).  Where the two agree this is JAX's module, parameter
    for parameter.  Always the plain attention path, as in JAX."""

    def __init__(self, dim: int, context_dim: int, n_queries: int = 256,
                 num_heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.query = nn.Parameter(torch.empty(n_queries, dim))
        self.ln_q = LayerNorm(dim)
        self.ln_k = LayerNorm(context_dim)
        self.attn = MultiheadAttention(dim, num_heads, dtype=dtype,
                                       kdim=context_dim)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.query, std=1.0, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, N, context_dim] -> [B, n_queries, dim]."""
        q = self.ln_q(self.query.to(x.dtype))
        return self.attn(q.expand(x.shape[0], *q.shape), kv=self.ln_k(x))
