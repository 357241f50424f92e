"""The Llama, Mistral and Gemma text encoders in PyTorch: the counterparts
of transformers' ``FlaxLlamaModule``, ``FlaxMistralModule`` and
``FlaxGemmaModule``, which the JAX package's HF tower wraps for a
``llama``, ``mistral`` or ``gemma`` config
(``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names (``embed_tokens``,
``layers.N.input_layernorm``, ``layers.N.self_attn.{q,k,v,o}_proj``,
``layers.N.post_attention_layernorm``,
``layers.N.mlp.{gate,up,down}_proj``, ``norm``), the Flax tree's paths (an
RMSNorm's leaf is ``weight`` there too).

As in Flax, which departs from transformers' torch modules in places the
port keeps:

- the RMSNorm divides by ``sqrt(mean(x^2) + rms_norm_eps)`` with float32
  statistics and scales by ``weight`` (Gemma: ``1 + weight``); the float32
  weight times the compute-dtype output leaves a float32 result;
- the rotary table is ``create_sinusoidal_positions`` of the Flax module:
  base 10000 whatever ``rope_theta`` or ``rope_scaling`` say, over
  ``hidden_size // num_attention_heads`` features for Llama and Mistral
  (a config's ``head_dim`` is not read) and over ``head_dim`` for Gemma,
  computed in numpy as Flax computes it; the rotation is float32 and is
  cast back to the compute dtype;
- grouped-query attention: each of ``num_key_value_heads`` key and value
  heads serves ``num_attention_heads / num_key_value_heads`` consecutive
  query heads (``jnp.repeat``); the logits are scaled by
  ``1/sqrt(head_dim)``, masked by an additive bias of ``finfo(dtype).min``
  and normalised in float32 under a lower compute dtype;
- the mask is causal, combined with the padding mask; Mistral's is
  ``jnp.triu(causal, k=-(sliding_window or 0))``, so that query ``i``
  sees keys ``i - w .. i`` (``w + 1`` keys, one more than transformers'
  torch Mistral), and with ``sliding_window`` null only itself;
- the MLP is ``down(up(x) * act(gate(x)))``: SwiGLU, or Gemma's GeGLU
  (``hf_arch`` resolves the activation, ``mlp_act``); its width is
  ``intermediate_size`` (``4 * hidden_size`` where that is unset);
- Gemma's embeddings are multiplied by ``hidden_size ** 0.5`` in the
  compute dtype.

The attention runs on stock torch ops, as it runs on XLA in JAX.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from .hf_bert import Dense, Embed, act_fn, mask_bias


def sinusoidal_positions(num_pos: int, dim: int, length: int
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """(sin, cos) ``[length, 1, dim]`` of the first ``length`` rows of the
    Flax modules' ``create_sinusoidal_positions(num_pos, dim)`` table,
    float32, with its cut of the last axis to ``num_pos`` entries."""
    if length > num_pos:
        raise ValueError(f"a text of {length} tokens is longer than "
                         f"max_position_embeddings {num_pos}")
    inv_freq = 1.0 / (10000 ** (np.arange(0, dim, 2)[: dim // 2] / dim))
    freqs = np.einsum("i , j -> i j", np.arange(length), inv_freq
                      ).astype("float32")
    emb = np.concatenate((freqs, freqs), axis=-1)
    out = np.concatenate((np.sin(emb)[:, None, :], np.cos(emb)[:, None, :]),
                         axis=-1)[:, :, :num_pos]
    sin, cos = np.split(out, 2, axis=-1)
    return sin, cos


def rotate_half(t: torch.Tensor) -> torch.Tensor:
    half = t.shape[-1] // 2
    return torch.cat((-t[..., half:], t[..., :half]), dim=-1)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float, dtype: torch.dtype,
                 plus_one: bool = False):
        super().__init__()
        self.eps, self.dtype, self.plus_one = eps, dtype, plus_one
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        var = h.float().square().mean(-1, keepdim=True)
        x = (h / torch.sqrt(var + self.eps)).to(self.dtype)
        return ((1 + self.weight) if self.plus_one else self.weight) * x


class _Attention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        gemma = cfg.model_type == "gemma"
        self.heads, self.kv_heads = (cfg.num_attention_heads,
                                     cfg.num_key_value_heads)
        self.head_dim = cfg.head_dim if gemma else d // self.heads
        if not gemma and self.head_dim * self.heads != d:
            raise ValueError(
                f"hidden_size must be divisible by num_heads (got "
                f"`hidden_size`: {d} and `num_heads`: {self.heads}).")
        bias = bool(getattr(cfg, "attention_bias", False))
        inner, kv = self.heads * self.head_dim, self.kv_heads * self.head_dim
        self.q_proj = Dense(d, inner, std, bias=bias, dtype=dtype)
        self.k_proj = Dense(d, kv, std, bias=bias, dtype=dtype)
        self.v_proj = Dense(d, kv, std, bias=bias, dtype=dtype)
        self.o_proj = Dense(inner, d, std, bias=bias, dtype=dtype)
        self.dtype = dtype

    def forward(self, h, bias, sin, cos):
        b, n, _ = h.shape
        q = self.q_proj(h).reshape(b, n, self.heads, self.head_dim)
        k = self.k_proj(h).reshape(b, n, self.kv_heads, self.head_dim)
        v = self.v_proj(h).reshape(b, n, self.kv_heads, self.head_dim)
        k = (k * cos + rotate_half(k) * sin).to(self.dtype)
        q = (q * cos + rotate_half(q) * sin).to(self.dtype)
        groups = self.heads // self.kv_heads
        k = k.repeat_interleave(groups, dim=2)
        v = v.repeat_interleave(groups, dim=2)
        # flax's dot_product_attention_weights in float32 under a lower
        # compute dtype (attention_softmax_in_fp32)
        ad = torch.float32 if self.dtype != torch.float32 else self.dtype
        q, k = q.to(ad), k.to(ad)
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=ad)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
        w = torch.softmax(w, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", w, v)
        return self.o_proj(out.reshape(b, n, self.heads * self.head_dim))


class _Mlp(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        inner = (cfg.intermediate_size if cfg.intermediate_size is not None
                 else 4 * d)
        self.gate_proj = Dense(d, inner, std, bias=False, dtype=dtype)
        self.up_proj = Dense(d, inner, std, bias=False, dtype=dtype)
        self.down_proj = Dense(inner, d, std, bias=False, dtype=dtype)
        self.act = act_fn(cfg.mlp_act)

    def forward(self, h):
        return self.down_proj(self.up_proj(h) * self.act(self.gate_proj(h)))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.rms_norm_eps
        gemma = cfg.model_type == "gemma"
        self.input_layernorm = RMSNorm(d, eps, dtype, gemma)
        self.self_attn = _Attention(cfg, dtype)
        self.post_attention_layernorm = RMSNorm(d, eps, dtype, gemma)
        self.mlp = _Mlp(cfg, dtype)

    def forward(self, h, bias, sin, cos):
        h = h + self.self_attn(self.input_layernorm(h), bias, sin, cos)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    """``forward(ids, mask) -> (last hidden state [B, L, D], None)``, at
    the ``arange`` positions the JAX tower passes."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gemma = cfg.model_type == "gemma"
        self.hidden_size = cfg.hidden_size
        self.max_positions = cfg.max_position_embeddings
        self.rotary_dim = (cfg.head_dim if self.gemma
                           else cfg.hidden_size // cfg.num_attention_heads)
        # Mistral's window (0 where it is null); None: causal alone
        self.window = ((cfg.sliding_window or 0)
                       if cfg.model_type == "mistral" else None)
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  cfg.initializer_range, dtype)
        self.layers = nn.ModuleList(LlamaDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps, dtype,
                            self.gemma)
        self._tables: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rotary(self, length: int, device) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(sin, cos) ``[length, 1, rotary_dim]`` on ``device``, cached;
        made outside inference mode, so that a table first made there
        serves a later forward with autograd."""
        key = (length, str(device))
        if key not in self._tables:
            with torch.inference_mode(False):
                self._tables[key] = tuple(
                    torch.from_numpy(t).to(device)
                    for t in sinusoidal_positions(
                        self.max_positions, self.rotary_dim, length))
        return self._tables[key]

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        h = self.embed_tokens(ids)
        if self.gemma:
            h = h * torch.tensor(self.hidden_size ** 0.5, dtype=h.dtype)
        sin, cos = self.rotary(ids.shape[1], ids.device)
        bias = mask_bias(mask, self.dtype, causal=True, window=self.window)
        for layer in self.layers:
            h = layer(h, bias, sin, cos)
        return self.norm(h), None
