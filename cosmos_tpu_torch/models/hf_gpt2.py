"""The GPT-2 text encoder in PyTorch: the counterpart of transformers'
``FlaxGPT2Module``, which the JAX package's HF tower wraps for a ``gpt2``
(or ``gpt-sw3``) config (``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names (``wte``, ``wpe``,
``h.N.ln_1``, ``h.N.attn.c_attn``, ``h.N.attn.c_proj``, ``h.N.ln_2``,
``h.N.mlp.c_fc``, ``h.N.mlp.c_proj``, ``ln_f``) and torch's ``Conv1D``
layout, a ``[in, out]`` weight, so that a torch ``model.safetensors``
loads by name.  Flax's ``FlaxConv1D`` holds the same kernel as ``[out,
in]`` and transposes it at use: the weight bridge transposes it
(``convert.hf_encoder_entries``), as it does a Dense kernel.

As in Flax: pre-LN blocks whose LayerNorms (``layer_norm_epsilon``) reduce
in float32; a causal self-attention (``make_causal_mask``) combined with
the padding mask as an additive bias of ``finfo(dtype).min``, its logits
always scaled by ``1/sqrt(head_dim)`` (Flax reads neither
``scale_attn_weights`` nor ``scale_attn_by_inverse_layer_idx``); the MLP's
``activation_function`` (``gelu_new`` by default) over ``n_inner`` or
``4 * n_embd`` features; learned positions ``wpe``.
``add_cross_attention`` builds nothing: Flax creates those leaves
only when it is given encoder states, which the tower never passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .hf_bert import Embed, LayerNorm, act_fn, attention, mask_bias


class Conv1D(nn.Module):
    """transformers' ``Conv1D``: ``y = x W + b`` with a ``[in, out]``
    weight, cast to the compute dtype (``FlaxConv1D(dtype=...)``), drawn
    from a normal at ``std``."""

    def __init__(self, in_features: int, out_features: int, std: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.std, self.dtype = std, dtype
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.std, generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under tensor parallelism the weight and bias are DTensors, split
        # where JAX's rule splits Flax's [out, in] kernel, a dim the matmul
        # is not parallel over: every rank of the model group computes with
        # the whole tensors
        w, b = (t.full_tensor() if hasattr(t, "full_tensor") else t
                for t in (self.weight, self.bias))
        return F.linear(x.to(self.dtype), w.to(self.dtype).t(),
                        b.to(self.dtype))


class _Attention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.n_embd, cfg.initializer_range
        self.heads = cfg.n_head
        self.c_attn = Conv1D(d, 3 * d, std, dtype)
        self.c_proj = Conv1D(d, d, std, dtype)

    def forward(self, h, bias):
        q, k, v = self.c_attn(h).chunk(3, dim=-1)
        return self.c_proj(attention(q, k, v, self.heads, bias))


class _Mlp(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.n_embd, cfg.initializer_range
        inner = cfg.n_inner if cfg.n_inner is not None else 4 * d
        self.c_fc = Conv1D(d, inner, std, dtype)
        self.c_proj = Conv1D(inner, d, std, dtype)
        self.act = act_fn(cfg.activation_function)

    def forward(self, h):
        return self.c_proj(self.act(self.c_fc(h)))


class GPT2Block(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(d, eps, dtype)
        self.attn = _Attention(cfg, dtype)
        self.ln_2 = LayerNorm(d, eps, dtype)
        self.mlp = _Mlp(cfg, dtype)

    def forward(self, h, bias):
        h = h + self.attn(self.ln_1(h), bias)
        return h + self.mlp(self.ln_2(h))


class GPT2Model(nn.Module):
    """``forward(ids, mask) -> (last hidden state [B, L, D], None)``,
    at the ``arange`` positions the JAX tower passes."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        d, std = cfg.n_embd, cfg.initializer_range
        self.wte = Embed(cfg.vocab_size, d, std, dtype)
        self.wpe = Embed(cfg.n_positions, d, std, dtype)
        self.h = nn.ModuleList(GPT2Block(cfg, dtype)
                               for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(d, cfg.layer_norm_epsilon, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        position_ids = torch.arange(ids.shape[1], device=ids.device
                                    ).expand_as(ids)
        h = self.wte(ids) + self.wpe(position_ids)
        bias = mask_bias(mask, self.dtype, causal=True)
        for block in self.h:
            h = block(h, bias)
        return self.ln_f(h), None
