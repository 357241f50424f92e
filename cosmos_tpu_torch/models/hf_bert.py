"""BERT-family text encoders (BERT, RoBERTa, XLM-RoBERTa, ELECTRA,
RoBERTa-PreLayerNorm) in PyTorch: the counterpart of transformers'
``FlaxBertModule``, ``FlaxRobertaModule``, ``FlaxXLMRobertaModule``,
``FlaxElectraModule`` and ``FlaxRobertaPreLayerNormModule``, which the JAX
package's HF tower wraps (``cosmos_tpu/models/hf_model.py``).

Parameters keep transformers' torch names (``embeddings.word_embeddings``,
``encoder.layer.N.attention.self.query``, ``pooler.dense``, ...), which
are the Flax tree's paths with a Dense ``kernel`` as ``weight``
(transposed), an ``embedding`` as ``weight`` and a LayerNorm ``scale`` as
``weight``.  Casts follow Flax's ``dtype``: embeddings and Dense layers
compute in the compute dtype (ELECTRA's embeddings, which Flax builds
without a dtype, in float32), LayerNorms reduce in float32 and return the
compute dtype, and the attention mask is a bias of ``finfo(dtype).min``
added to the scaled logits before a softmax in the compute dtype.  The
attention runs on stock torch ops, as it runs on XLA in JAX.

The types differ where their Flax modules do:

- ELECTRA: embeddings of ``embedding_size``, projected to ``hidden_size``
  by ``embeddings_project`` where the two differ (flax's default
  lecun-normal Dense); no pooler.
- RoBERTa-PreLayerNorm: each sublayer's LayerNorm comes before it
  (``attention.LayerNorm``, ``intermediate.LayerNorm``) and the residual
  sums are not normalised; a final ``LayerNorm`` follows the layers, and
  the pooler reads its output.
- ``is_decoder`` (BERT, RoBERTa, XLM-RoBERTa, ELECTRA,
  RoBERTa-PreLayerNorm): the self-attention is causal, Flax's
  ``make_causal_mask`` combined with the padding mask.
  ``add_cross_attention`` builds nothing: Flax creates the
  cross-attention's leaves only when it is given encoder states, which
  the tower never passes.

The building blocks (``Dense``, ``Embed``, ``LayerNorm``, ``ACT2FN``,
``attention``) are shared with ``hf_t5.py``, ``hf_distilbert.py`` and
``hf_albert.py``.  Weights are drawn as transformers draws them: a normal
at ``initializer_range`` for kernels and embeddings, zero biases, unit
LayerNorms.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import layers

ACT2FN = {
    "gelu": F.gelu,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": layers.quick_gelu,
    "gelu_pytorch_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
}


def act_fn(name: str):
    if name not in ACT2FN:
        raise ValueError(f"HF activation {name!r}: the port has "
                         f"{sorted(ACT2FN)}")
    return ACT2FN[name]


class Dense(layers.Linear):
    """Flax ``nn.Dense(dtype=...)`` drawn from a normal at ``std``."""

    def __init__(self, in_features: int, out_features: int, std: float,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias, dtype)
        self.std = std

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.std, generator=generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Embed(nn.Module):
    """Flax ``nn.Embed(dtype=...)``: rows of a float32 table, cast to the
    compute dtype."""

    def __init__(self, num: int, dim: int, std: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.std, self.dtype = std, dtype
        self.weight = nn.Parameter(torch.empty(num, dim))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.weight, std=self.std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.dtype)


class LayerNorm(layers.LayerNorm):
    """Flax ``nn.LayerNorm(dtype=...)``: float32 statistics, the output in
    ``dtype`` (the input's where None).  transformers' Flax modules do not
    use the package's LayerNorm, so ``FUSED_LN``/``HYBRID_LN`` leave it
    plain."""

    fusable = False

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(dim, eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = super().forward(x)
        return y if self.dtype is None else y.to(self.dtype)


def mask_bias(mask: torch.Tensor, dtype: torch.dtype,
              causal: bool = False, window: Optional[int] = None
              ) -> torch.Tensor:
    """A ``[B, L]`` 0/1 mask as the additive ``[B, 1, 1, L]`` bias of
    transformers' Flax attention: 0 or ``finfo(dtype).min``; ``causal``
    combines it with ``make_causal_mask`` (key <= query), ``[B, 1, L,
    L]``, and ``window`` with Flax Mistral's ``triu(causal, k=-window)``
    (key >= query - window)."""
    keep = mask[:, None, None, :] > 0
    if causal:
        pos = torch.arange(mask.shape[1], device=mask.device)
        keep = keep & (pos[None, :] <= pos[:, None])
        if window is not None:
            keep = keep & (pos[None, :] >= pos[:, None] - window)
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    low = torch.full((), torch.finfo(dtype).min, dtype=dtype,
                     device=mask.device)
    return torch.where(keep, zero, low)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              heads: int, bias: torch.Tensor, scale: bool = True
              ) -> torch.Tensor:
    """flax ``dot_product_attention_weights`` and the value product of
    transformers' Flax attention: ``[B, L, H*Dh]`` each -> ``[B, L,
    H*Dh]``; ``bias`` broadcasts to ``[B, H, L, L]``; ``scale`` divides q
    by sqrt(Dh) (T5 does not)."""
    b, l, d = q.shape
    q, k, v = (t.reshape(b, -1, heads, t.shape[-1] // heads)
               for t in (q, k, v))
    if scale:
        q = q / torch.tensor(math.sqrt(q.shape[-1]), dtype=q.dtype)
    w = torch.einsum("bqhd,bkhd->bhqk", q, k) + bias
    w = torch.softmax(w, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, -1)


class _SelfAttention(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        d, std = cfg.hidden_size, cfg.initializer_range
        self.heads = cfg.num_attention_heads
        self.query = Dense(d, d, std, dtype=dtype)
        self.key = Dense(d, d, std, dtype=dtype)
        self.value = Dense(d, d, std, dtype=dtype)

    def forward(self, h, bias):
        return attention(self.query(h), self.key(h), self.value(h),
                         self.heads, bias)


class _Output(nn.Module):
    """``dense(x) + residual``, normalised after the sum in a post-LN layer:
    ``attention.output`` and ``output``."""

    def __init__(self, d_in, cfg, dtype, post_ln: bool = True):
        super().__init__()
        self.dense = Dense(d_in, cfg.hidden_size, cfg.initializer_range,
                           dtype=dtype)
        self.LayerNorm = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    dtype) if post_ln else None)

    def forward(self, x, residual):
        h = self.dense(x) + residual
        return h if self.LayerNorm is None else self.LayerNorm(h)


class _Attention(nn.Module):
    def __init__(self, cfg, dtype, pre_ln: bool):
        super().__init__()
        self.self = _SelfAttention(cfg, dtype)
        self.output = _Output(cfg.hidden_size, cfg, dtype, not pre_ln)
        self.LayerNorm = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    dtype) if pre_ln else None)

    def forward(self, h, bias):
        x = h if self.LayerNorm is None else self.LayerNorm(h)
        return self.output(self.self(x, bias), h)


class _Intermediate(nn.Module):
    def __init__(self, cfg, dtype, pre_ln: bool):
        super().__init__()
        self.LayerNorm = (LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                    dtype) if pre_ln else None)
        self.dense = Dense(cfg.hidden_size, cfg.intermediate_size,
                           cfg.initializer_range, dtype=dtype)
        self.act = act_fn(cfg.hidden_act)

    def forward(self, h):
        if self.LayerNorm is not None:
            h = self.LayerNorm(h)
        return self.act(self.dense(h))


class BertLayer(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        pre_ln = cfg.model_type == "roberta-prelayernorm"
        self.attention = _Attention(cfg, dtype, pre_ln)
        self.intermediate = _Intermediate(cfg, dtype, pre_ln)
        self.output = _Output(cfg.intermediate_size, cfg, dtype, not pre_ln)

    def forward(self, h, bias):
        h = self.attention(h, bias)
        return self.output(self.intermediate(h), h)


class _Encoder(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg, dtype)
                                   for _ in range(cfg.num_hidden_layers))


class Embeddings(nn.Module):
    """Word, position and token-type rows of ``width`` (``hidden_size``, or
    ELECTRA's and ALBERT's ``embedding_size``), summed in ``embed_dtype``
    and normalised into the compute dtype."""

    def __init__(self, cfg, dtype, width: Optional[int] = None,
                 embed_dtype: Optional[torch.dtype] = None):
        super().__init__()
        d, std = width or cfg.hidden_size, cfg.initializer_range
        embed_dtype = embed_dtype or dtype
        self.word_embeddings = Embed(cfg.vocab_size, d, std, embed_dtype)
        self.position_embeddings = Embed(cfg.max_position_embeddings, d, std,
                                         embed_dtype)
        self.token_type_embeddings = Embed(cfg.type_vocab_size, d, std,
                                           embed_dtype)
        self.LayerNorm = LayerNorm(d, cfg.layer_norm_eps, dtype)

    def forward(self, ids, token_type_ids, position_ids):
        return self.LayerNorm(self.word_embeddings(ids)
                              + self.token_type_embeddings(token_type_ids)
                              + self.position_embeddings(position_ids))


class _Pooler(nn.Module):
    def __init__(self, cfg, dtype):
        super().__init__()
        self.dense = Dense(cfg.hidden_size, cfg.hidden_size,
                           cfg.initializer_range, dtype=dtype)

    def forward(self, hidden):
        return torch.tanh(self.dense(hidden[:, 0]))


def default_ids(ids: torch.Tensor, token_type_ids, position_ids):
    """Zero token types and ``arange`` positions where none are given, as
    the Flax modules fill them."""
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(ids)
    if position_ids is None:
        position_ids = torch.arange(ids.shape[1], device=ids.device
                                    ).expand_as(ids)
    return token_type_ids, position_ids


class BertModel(nn.Module):
    """``forward(ids, mask, token_type_ids, position_ids) -> (last hidden
    state [B, L, D], pooler output [B, D] or None)``.  The pooler exists
    whatever the tower's pooling, as in Flax (ELECTRA has none): its
    weights take zero gradients under ``mean_pooler`` and are still
    decayed."""

    def __init__(self, cfg, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.causal = bool(cfg.is_decoder)
        electra = cfg.model_type == "electra"
        if electra:
            self.embeddings = Embeddings(cfg, dtype, cfg.embedding_size,
                                         torch.float32)
            if cfg.embedding_size != cfg.hidden_size:
                self.embeddings_project = layers.Linear(
                    cfg.embedding_size, cfg.hidden_size, dtype=dtype)
        else:
            self.embeddings = Embeddings(cfg, dtype)
        self.encoder = _Encoder(cfg, dtype)
        if cfg.model_type == "roberta-prelayernorm":
            self.LayerNorm = LayerNorm(cfg.hidden_size, cfg.layer_norm_eps,
                                       dtype)
        self.pooler = None if electra else _Pooler(cfg, dtype)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None):
        token_type_ids, position_ids = default_ids(ids, token_type_ids,
                                                   position_ids)
        h = self.embeddings(ids, token_type_ids, position_ids)
        if hasattr(self, "embeddings_project"):
            h = self.embeddings_project(h)
        bias = mask_bias(mask, self.dtype, self.causal)
        for layer in self.encoder.layer:
            h = layer(h, bias)
        if hasattr(self, "LayerNorm"):
            h = self.LayerNorm(h)
        return h, None if self.pooler is None else self.pooler(h)
