"""The DistilBERT text encoder in PyTorch: the counterpart of transformers'
``FlaxDistilBertModule``, which the JAX package's HF tower wraps
(``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names, the Flax tree's paths
(``embeddings.word_embeddings``, ``embeddings.position_embeddings``,
``embeddings.LayerNorm``, ``transformer.layer.N.attention.{q,k,v,out}_lin``,
``...sa_layer_norm``, ``...ffn.lin1``, ``...ffn.lin2``,
``...output_layer_norm``).  The config's own names are read (``dim``,
``n_layers``, ``n_heads``, ``hidden_dim``, ``activation``,
``sinusoidal_pos_embds``).

As in Flax: the embeddings are float32 (Flax builds them without a
dtype) and their LayerNorm returns the compute dtype; every LayerNorm's
epsilon is 1e-12, whatever the config says; q is divided by
``sqrt(dim / n_heads)`` before the product, and the padding mask is
applied as ``scores - 1e30 * (1 - mask)`` in the scores' dtype, not as
BERT's ``finfo.min`` bias.  The module takes no token types and no
position ids (positions are ``arange``) and has no pooler.  Under
``sinusoidal_pos_embds`` the position table is Flax's constant (float64
sines and cosines rounded to float32), a non-persistent buffer: no
parameter, as Flax makes no leaf of it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .hf_bert import Dense, Embed, LayerNorm, act_fn

EPS = 1e-12


def sinusoidal_table(positions: int, dim: int) -> torch.Tensor:
    """``positional_encoding(positions, dim)`` of transformers' Flax
    DistilBERT: ``pos / 10000 ** (2 (i // 2) / dim)``, sines at even
    features and cosines at odd ones, in float64, as float32."""
    pos = torch.arange(positions, dtype=torch.float64)[:, None]
    i = torch.arange(dim, dtype=torch.float64)[None, :]
    angle = pos / torch.pow(10000.0, 2 * torch.div(i, 2, rounding_mode="floor")
                            / dim)
    table = torch.empty_like(angle)
    table[:, 0::2] = torch.sin(angle[:, 0::2])
    table[:, 1::2] = torch.cos(angle[:, 1::2])
    return table.float()


class _Embeddings(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        std = cfg.initializer_range
        self.word_embeddings = Embed(cfg.vocab_size, cfg.dim, std,
                                     torch.float32)
        if cfg.sinusoidal_pos_embds:
            self.register_buffer("pos_encoding", sinusoidal_table(
                cfg.max_position_embeddings, cfg.dim), persistent=False)
        else:
            self.position_embeddings = Embed(cfg.max_position_embeddings,
                                             cfg.dim, std, torch.float32)
        self.LayerNorm = LayerNorm(cfg.dim, EPS, dtype)

    def forward(self, ids):
        n = ids.shape[1]
        if hasattr(self, "pos_encoding"):
            pos = self.pos_encoding[:n]
        else:
            pos = self.position_embeddings(torch.arange(n, device=ids.device))
        return self.LayerNorm(self.word_embeddings(ids) + pos)


class _SelfAttention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.dim, cfg.initializer_range
        if d % cfg.n_heads:
            raise ValueError(f"Hidden size {d} not dividable by number of "
                             f"heads {cfg.n_heads}")
        self.heads = cfg.n_heads
        self.q_lin = Dense(d, d, std, dtype=dtype)
        self.k_lin = Dense(d, d, std, dtype=dtype)
        self.v_lin = Dense(d, d, std, dtype=dtype)
        self.out_lin = Dense(d, d, std, dtype=dtype)

    def forward(self, h, mask):
        b, n, d = h.shape
        dh = d // self.heads

        def heads(t):
            return t.reshape(b, n, self.heads, dh).transpose(1, 2)

        q, k, v = heads(self.q_lin(h)), heads(self.k_lin(h)), \
            heads(self.v_lin(h))
        q = q / torch.tensor(math.sqrt(dh), dtype=q.dtype)
        scores = q @ k.transpose(-1, -2)
        scores = scores - 1e30 * (1.0 - mask[:, None, None, :].to(
            scores.dtype))
        w = torch.softmax(scores, dim=-1).to(q.dtype)
        return self.out_lin((w @ v).transpose(1, 2).reshape(b, n, d))


class _FFN(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        std = cfg.initializer_range
        self.lin1 = Dense(cfg.dim, cfg.hidden_dim, std, dtype=dtype)
        self.lin2 = Dense(cfg.hidden_dim, cfg.dim, std, dtype=dtype)
        self.act = act_fn(cfg.activation)

    def forward(self, h):
        return self.lin2(self.act(self.lin1(h)))


class TransformerBlock(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.attention = _SelfAttention(cfg, dtype)
        self.sa_layer_norm = LayerNorm(cfg.dim, EPS, dtype)
        self.ffn = _FFN(cfg, dtype)
        self.output_layer_norm = LayerNorm(cfg.dim, EPS, dtype)

    def forward(self, h, mask):
        h = self.sa_layer_norm(self.attention(h, mask) + h)
        return self.output_layer_norm(self.ffn(h) + h)


class _Transformer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.layer = nn.ModuleList(TransformerBlock(cfg, dtype)
                                   for _ in range(cfg.n_layers))


class DistilBertModel(nn.Module):
    """``forward(ids, mask) -> (last hidden state [B, L, dim], None)``: no
    pooler."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype)
        self.transformer = _Transformer(cfg, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor):
        h = self.embeddings(ids)
        for layer in self.transformer.layer:
            h = layer(h, mask)
        return h, None
