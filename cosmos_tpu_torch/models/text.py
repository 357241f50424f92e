"""Text transformer tower (counterpart of ``cosmos_tpu/models/text.py``).

OpenCLIP's CLIP keeps the text tower's parts at its own top level
(``token_embedding``, ``positional_embedding``, ``transformer``,
``ln_final``, ``text_projection``), and reference checkpoints are named so.
The tower is therefore a set of parts that ``add_text_tower`` registers on
the owning module, and ``encode_tokens`` runs them.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
from torch import nn

from .config import TextCfg
from .layers import LayerNorm
from .transformer import Transformer


def add_text_tower(owner: nn.Module, cfg: TextCfg, output_dim: int,
                   act_fn: Callable[[torch.Tensor], torch.Tensor],
                   dtype: torch.dtype, fuse_ln: bool = False) -> None:
    """Register the text tower's parts on ``owner``."""
    if (cfg.embed_cls or cfg.proj_bias or cfg.hf_model_name
            or cfg.pool_type != "argmax"):
        raise ValueError(
            "the text tower takes the argmax-pooled CLIP layout only "
            "(no embed_cls, proj_bias, other pooling or HF tower)")
    owner.text_cfg = cfg
    owner.token_embedding = nn.Embedding(
        cfg.vocab_size, cfg.width,
        _weight=torch.empty(cfg.vocab_size, cfg.width))
    owner.positional_embedding = nn.Parameter(
        torch.empty(cfg.context_length, cfg.width))
    owner.transformer = Transformer(cfg.width, cfg.layers, cfg.heads,
                                    cfg.mlp_ratio, cfg.ls_init_value, act_fn,
                                    dtype, fuse_ln)
    owner.ln_final = LayerNorm(cfg.width)
    owner.text_projection = nn.Parameter(torch.empty(cfg.width, output_dim))


def init_text_tower(owner: nn.Module, generator: torch.Generator) -> None:
    nn.init.normal_(owner.token_embedding.weight, std=0.02,
                    generator=generator)
    nn.init.normal_(owner.positional_embedding, std=0.01, generator=generator)
    nn.init.normal_(owner.text_projection, std=owner.text_cfg.width ** -0.5,
                    generator=generator)


def encode_tokens(owner: nn.Module, text: torch.Tensor,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """text: [B, L] token ids -> (pooled [B, out], tokens [B, L, width]).

    Causal attention runs through the kernel's causal flag, with no mask
    tensor; pooling takes the hidden state at the highest token id (EOT)."""
    seq_len = text.shape[1]
    x = owner.token_embedding(text).to(dtype)
    x = x + owner.positional_embedding[:seq_len].to(dtype)
    x = owner.transformer(x, causal=not owner.text_cfg.no_causal_mask)
    x = owner.ln_final(x)
    rows = torch.arange(x.shape[0], device=x.device)
    pooled, tokens = x[rows, text.argmax(dim=-1)], x
    pooled = torch.matmul(pooled.to(dtype), owner.text_projection.to(dtype))
    return pooled, tokens
