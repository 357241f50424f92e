"""The ALBERT text encoder in PyTorch: the counterpart of transformers'
``FlaxAlbertModule``, which the JAX package's HF tower wraps
(``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names, the Flax tree's paths:
``embeddings.{word,position,token_type}_embeddings`` and
``embeddings.LayerNorm`` at ``embedding_size``,
``encoder.embedding_hidden_mapping_in`` (``embedding_size`` ->
``hidden_size``), ``encoder.albert_layer_groups.G.albert_layers.I.
{attention.{query,key,value,dense,LayerNorm}, ffn, ffn_output,
full_layer_layer_norm}`` and ``pooler`` (a Dense, then ``tanh``).

The layers are shared: ``num_hidden_groups`` groups of
``inner_group_num`` layers, where layer ``i`` of ``num_hidden_layers``
runs group ``int(i / (num_hidden_layers / num_hidden_groups))``, so one
parameter set is applied many times in a forward.  Casts are Flax's: the
embeddings are float32 (Flax builds them without a dtype) and their
LayerNorm returns the compute dtype; the attention is BERT's
(``hf_bert.attention`` with the ``finfo.min`` mask bias).
"""

from __future__ import annotations

import torch
from torch import nn

from .hf_bert import (Dense, Embeddings, LayerNorm, act_fn, attention,
                      default_ids, mask_bias)


class _Attention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        if d % cfg.num_attention_heads:
            raise ValueError(
                f"`config.hidden_size`: {d} has to be a multiple of "
                f"`config.num_attention_heads`: {cfg.num_attention_heads}")
        self.heads = cfg.num_attention_heads
        self.query = Dense(d, d, std, dtype=dtype)
        self.key = Dense(d, d, std, dtype=dtype)
        self.value = Dense(d, d, std, dtype=dtype)
        self.dense = Dense(d, d, std, dtype=dtype)
        self.LayerNorm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, h, bias):
        out = attention(self.query(h), self.key(h), self.value(h),
                        self.heads, bias)
        return self.LayerNorm(self.dense(out) + h)


class AlbertLayer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        self.attention = _Attention(cfg, dtype)
        self.ffn = Dense(d, cfg.intermediate_size, std, dtype=dtype)
        self.ffn_output = Dense(cfg.intermediate_size, d, std, dtype=dtype)
        self.full_layer_layer_norm = LayerNorm(d, cfg.layer_norm_eps, dtype)
        self.act = act_fn(cfg.hidden_act)

    def forward(self, h, bias):
        a = self.attention(h, bias)
        return self.full_layer_layer_norm(
            self.ffn_output(self.act(self.ffn(a))) + a)


class AlbertLayerGroup(nn.Module):
    """``inner_group_num`` layers in turn (Flax's
    ``FlaxAlbertLayerCollections``)."""

    def __init__(self, cfg, dtype):
        super().__init__()
        self.albert_layers = nn.ModuleList(AlbertLayer(cfg, dtype)
                                           for _ in range(cfg.inner_group_num))

    def forward(self, h, bias):
        for layer in self.albert_layers:
            h = layer(h, bias)
        return h


class AlbertEncoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.cfg = cfg
        self.embedding_hidden_mapping_in = Dense(
            cfg.embedding_size, cfg.hidden_size, cfg.initializer_range,
            dtype=dtype)
        self.albert_layer_groups = nn.ModuleList(
            AlbertLayerGroup(cfg, dtype)
            for _ in range(cfg.num_hidden_groups))

    def forward(self, h, bias):
        h = self.embedding_hidden_mapping_in(h)
        n, groups = self.cfg.num_hidden_layers, self.cfg.num_hidden_groups
        for i in range(n):
            h = self.albert_layer_groups[int(i / (n / groups))](h, bias)
        return h


class AlbertModel(nn.Module):
    """``forward(ids, mask, token_type_ids, position_ids) -> (last hidden
    state [B, L, H], pooler output [B, H])``."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embeddings = Embeddings(cfg, dtype, cfg.embedding_size,
                                     torch.float32)
        self.encoder = AlbertEncoder(cfg, dtype)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size,
                            cfg.initializer_range, dtype=dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                token_type_ids=None, position_ids=None):
        token_type_ids, position_ids = default_ids(ids, token_type_ids,
                                                   position_ids)
        h = self.embeddings(ids, token_type_ids, position_ids)
        h = self.encoder(h, mask_bias(mask, self.dtype))
        return h, torch.tanh(self.pooler(h[:, 0]))
