"""The OPT text encoder in PyTorch: the counterpart of transformers'
``FlaxOPTModule``, which the JAX package's HF tower wraps for an ``opt``
config (``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names (``decoder.embed_tokens``,
``decoder.embed_positions``, ``decoder.project_in``/``project_out``,
``decoder.layers.N.self_attn.{q,k,v,out}_proj``,
``decoder.layers.N.self_attn_layer_norm``, ``decoder.layers.N.fc1``/
``fc2``, ``decoder.layers.N.final_layer_norm``,
``decoder.final_layer_norm``), the Flax tree's paths.

As in Flax:

- token embeddings of ``word_embed_proj_dim``, projected to
  ``hidden_size`` by ``project_in`` (and the output back by
  ``project_out``) where the two differ, as in opt-350m; both are Dense
  layers Flax builds without a dtype, so they compute in float32 and their
  outputs stay float32;
- learned positions offset by 2: ``embed_positions`` holds
  ``max_position_embeddings + 2`` rows and position ``p`` reads row
  ``p + 2``;
- ``do_layer_norm_before`` picks pre-LN blocks, else post-LN blocks (each
  LayerNorm after its residual sum), as in opt-350m; the LayerNorms'
  epsilon is 1e-5 whatever the config says;
- ``decoder.final_layer_norm`` exists only under ``do_layer_norm_before``
  and not ``_remove_final_layer_norm``;
- a causal self-attention, every projection with a bias (Flax reads no
  ``enable_bias``), the MLP's ``activation_function`` (ReLU by default).
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers
from .hf_bert import Dense, Embed, LayerNorm, act_fn, attention, mask_bias

# the offset of FlaxOPTLearnedPositionalEmbedding
POSITION_OFFSET = 2


class _Attention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.init_std
        self.heads = cfg.num_attention_heads
        self.q_proj = Dense(d, d, std, dtype=dtype)
        self.k_proj = Dense(d, d, std, dtype=dtype)
        self.v_proj = Dense(d, d, std, dtype=dtype)
        self.out_proj = Dense(d, d, std, dtype=dtype)

    def forward(self, h, bias):
        return self.out_proj(attention(self.q_proj(h), self.k_proj(h),
                                       self.v_proj(h), self.heads, bias))


class OPTDecoderLayer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d = cfg.hidden_size
        self.pre_ln = bool(cfg.do_layer_norm_before)
        self.self_attn = _Attention(cfg, dtype)
        self.self_attn_layer_norm = LayerNorm(d, 1e-5, dtype)
        self.fc1 = Dense(d, cfg.ffn_dim, cfg.init_std, dtype=dtype)
        self.fc2 = Dense(cfg.ffn_dim, d, cfg.init_std, dtype=dtype)
        self.final_layer_norm = LayerNorm(d, 1e-5, dtype)
        self.act = act_fn(cfg.activation_function)

    def forward(self, h, bias):
        x = self.self_attn_layer_norm(h) if self.pre_ln else h
        h = h + self.self_attn(x, bias)
        if not self.pre_ln:
            h = self.self_attn_layer_norm(h)
        x = self.final_layer_norm(h) if self.pre_ln else h
        h = h + self.fc2(self.act(self.fc1(x)))
        return h if self.pre_ln else self.final_layer_norm(h)


class _Decoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, e, std = cfg.hidden_size, cfg.word_embed_proj_dim, cfg.init_std
        self.embed_tokens = Embed(cfg.vocab_size, e, std, dtype)
        self.embed_positions = Embed(
            cfg.max_position_embeddings + POSITION_OFFSET, d, std, dtype)
        if e != d:
            # flax's Dense without a dtype: float32 compute, lecun-normal
            self.project_in = layers.Linear(e, d, bias=False)
            self.project_out = layers.Linear(d, e, bias=False)
        if cfg.do_layer_norm_before and not cfg._remove_final_layer_norm:
            self.final_layer_norm = LayerNorm(d, 1e-5, dtype)
        self.layers = nn.ModuleList(OPTDecoderLayer(cfg, dtype)
                                    for _ in range(cfg.num_hidden_layers))


class OPTModel(nn.Module):
    """``forward(ids, mask) -> (last hidden state [B, L,
    word_embed_proj_dim], None)``, at the ``arange`` positions the JAX
    tower passes."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.decoder = _Decoder(cfg, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        dec = self.decoder
        position_ids = torch.arange(ids.shape[1], device=ids.device
                                    ).expand_as(ids)
        h = dec.embed_tokens(ids)
        if hasattr(dec, "project_in"):
            h = dec.project_in(h)
        h = h + dec.embed_positions(position_ids + POSITION_OFFSET)
        bias = mask_bias(mask, self.dtype, causal=True)
        for layer in dec.layers:
            h = layer(h, bias)
        if hasattr(dec, "final_layer_norm"):
            h = dec.final_layer_norm(h)
        if hasattr(dec, "project_out"):
            h = dec.project_out(h)
        return h, None
