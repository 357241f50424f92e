"""The T5 and mT5 encoders in PyTorch: the counterpart of transformers'
``FlaxT5EncoderModel.module_class``, which the JAX package's HF tower
wraps for an encoder-decoder config (``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names (``shared``,
``encoder.block.N.layer.0.SelfAttention.{q,k,v,o}``,
``...relative_attention_bias`` in block 0, ``encoder.block.N.layer.1.
DenseReluDense.{wi,wo}`` or ``{wi_0,wi_1,wo}``, the ``layer_norm``s and
``encoder.final_layer_norm``), the Flax tree's paths.  The embedding is
``shared`` alone: the encoder reads it, as Flax's ``embed_tokens`` does.

As in Flax: no ``1/sqrt(d_kv)`` scaling of the logits; bidirectional
relative-position buckets, computed in block 0 (inside its forward, so
that FSDP has gathered its table) with the additive mask of
``finfo(dtype).min`` added and the sum shared by the later blocks;
``T5LayerNorm`` is an RMS norm in float32 with no mean and no bias, whose
float32 output the next Dense casts to the compute dtype; the gated
feed-forward multiplies ``act(wi_0 x)`` by ``wi_1 x``.
"""

from __future__ import annotations

import torch
from torch import nn

from .hf_bert import Dense, Embed, act_fn, attention, mask_bias


class T5LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        var = h.float().square().mean(-1, keepdim=True)
        return self.weight * (h / torch.sqrt(var + self.eps))


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32,
                             max_distance: int = 128) -> torch.Tensor:
    """Bidirectional buckets of ``key - query`` positions, in float32 as
    transformers' Flax T5 computes them."""
    num_buckets //= 2
    buckets = (rel > 0).to(torch.int32) * num_buckets
    rel = rel.abs()
    max_exact = num_buckets // 2
    large = max_exact + (
        torch.log(rel.float() / max_exact)
        / torch.log(torch.tensor(max_distance / max_exact))
        * (num_buckets - max_exact))
    large = large.clamp(max=num_buckets - 1)
    return (buckets + torch.where(rel < max_exact, rel.float(), large)
            ).to(torch.int32)


class _SelfAttention(nn.Module):
    def __init__(self, cfg, dtype, relative_bias: bool):
        super().__init__()
        self.cfg, self.heads = cfg, cfg.num_heads
        inner, f = cfg.num_heads * cfg.d_kv, cfg.initializer_factor
        kv_std = f * inner ** -0.5
        self.q = Dense(cfg.d_model, inner, f * (inner * cfg.d_kv) ** -0.5,
                       bias=False, dtype=dtype)
        self.k = Dense(cfg.d_model, inner, kv_std, bias=False, dtype=dtype)
        self.v = Dense(cfg.d_model, inner, kv_std, bias=False, dtype=dtype)
        self.o = Dense(inner, cfg.d_model, kv_std, bias=False, dtype=dtype)
        if relative_bias:
            self.relative_attention_bias = Embed(
                cfg.relative_attention_num_buckets, cfg.num_heads, kv_std,
                dtype)

    def position_bias(self, length: int, device) -> torch.Tensor:
        """``[1, H, L, L]`` from the relative-position table."""
        pos = torch.arange(length, device=device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(buckets).permute(2, 0, 1)[None]

    def forward(self, h, bias):
        return self.o(attention(self.q(h), self.k(h), self.v(h), self.heads,
                                bias, scale=False))


class _LayerSelfAttention(nn.Module):
    def __init__(self, cfg, dtype, relative_bias):
        super().__init__()
        self.SelfAttention = _SelfAttention(cfg, dtype, relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, h, bias):
        return h + self.SelfAttention(self.layer_norm(h), bias)


class _DenseActDense(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        f = cfg.initializer_factor
        wi_std, wo_std = f * cfg.d_model ** -0.5, f * cfg.d_ff ** -0.5
        self.gated = cfg.is_gated_act
        self.act = act_fn(cfg.dense_act_fn)
        names = ("wi_0", "wi_1") if self.gated else ("wi",)
        for name in names:
            setattr(self, name, Dense(cfg.d_model, cfg.d_ff, wi_std,
                                      bias=False, dtype=dtype))
        self.wo = Dense(cfg.d_ff, cfg.d_model, wo_std, bias=False,
                        dtype=dtype)

    def forward(self, h):
        if self.gated:
            return self.wo(self.act(self.wi_0(h)) * self.wi_1(h))
        return self.wo(self.act(self.wi(h)))


class _LayerFF(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.DenseReluDense = _DenseActDense(cfg, dtype)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, h):
        return h + self.DenseReluDense(self.layer_norm(h))


class T5Block(nn.Module):
    def __init__(self, cfg, dtype, relative_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([
            _LayerSelfAttention(cfg, dtype, relative_bias),
            _LayerFF(cfg, dtype)])

    def forward(self, h, bias):
        """-> (h, the attention bias): the block with the relative-position
        table adds its bias to the mask's, for itself and the later
        blocks."""
        attn = self.layer[0].SelfAttention
        if hasattr(attn, "relative_attention_bias"):
            bias = attn.position_bias(h.shape[1], h.device) + bias
        return self.layer[1](self.layer[0](h, bias)), bias


class _Stack(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, dtype, i == 0)
                                   for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    """``forward(ids, mask) -> (last hidden state [B, L, d_model], None)``:
    no pooler output, as Flax's encoder has none."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.shared = Embed(cfg.vocab_size, cfg.d_model,
                            cfg.initializer_factor, dtype)
        self.encoder = _Stack(cfg, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        h = self.shared(ids)
        bias = mask_bias(mask, self.dtype)
        for block in self.encoder.block:
            h, bias = block(h, bias)
        return self.encoder.final_layer_norm(h), None
