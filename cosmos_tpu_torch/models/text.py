"""Text transformer tower (counterpart of ``cosmos_tpu/models/text.py``).

OpenCLIP's CLIP keeps the text tower's parts at its own top level
(``token_embedding``, ``positional_embedding``, ``transformer``,
``ln_final``, ``text_projection``), and reference checkpoints are named so.
The tower is therefore a set of parts that ``add_text_tower`` registers on
the owning module, and ``encode_tokens`` runs them.  ``text_projection`` is
a bare ``[width, out]`` matrix, or with ``proj_bias`` an ``nn.Linear``
(``text_projection.weight``/``.bias``), OpenCLIP's two forms.

CoCa keeps its text tower under ``text.`` (``TextTransformer``), with
``embed_cls``: a CLS embedding appended after the tokens, a position table
of ``L + 1``, the additive mask of ``coca_cls_pad_mask`` on top of the
causal one (the plain attention path, as JAX's gate sends any mask to
XLA), the CLS state through ``ln_final`` as the pooled feature and the
other states, without ``ln_final``, as the tokens.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .config import TextCfg
from .layers import LayerNorm, Linear
from .transformer import Transformer

# JAX's text tower's stand-in for -inf in its additive masks
NEG_INF = -1e9


def coca_cls_pad_mask(text: torch.Tensor, pad_id: int) -> torch.Tensor:
    """Additive float32 ``[B, L+1, L+1]`` mask of the appended-CLS tower
    (``cosmos_tpu/models/text.py`` ``coca_cls_pad_mask``), with OpenCLIP's
    ``build_cls_mask`` quirk kept: the L token rows are all open (the
    causal mask alone gates them) and only the CLS row is masked, key j
    gated by ``text[j-1]`` (key 0 always open)."""
    b, l = text.shape
    key_valid = torch.cat([torch.ones(b, 1, dtype=torch.bool,
                                      device=text.device),
                           text != pad_id], dim=1)
    cls_row = torch.zeros(b, l + 1, device=text.device).masked_fill(
        ~key_valid, NEG_INF)
    return torch.cat([torch.zeros(b, l, l + 1, device=text.device),
                      cls_row[:, None, :]], dim=1)


def additive_causal_mask(length: int, device) -> torch.Tensor:
    """JAX's text-tower causal mask: ``NEG_INF`` above the diagonal."""
    above = torch.ones(length, length, dtype=torch.bool,
                       device=device).triu(1)
    return torch.zeros(length, length, device=device).masked_fill(above,
                                                                  NEG_INF)


def add_text_tower(owner: nn.Module, cfg: TextCfg, output_dim: int,
                   act_fn: Callable[[torch.Tensor], torch.Tensor],
                   dtype: torch.dtype, fuse_ln: bool = False,
                   remat: bool = False, remat_policy: str = "",
                   use_flash: Optional[bool] = None) -> None:
    """Register the text tower's parts on ``owner`` (with ``embed_cls``,
    ``cls_emb`` and one more position).  An HF tower is
    ``models.hf_model.HFTextTower``."""
    owner.text_cfg = cfg
    owner.token_embedding = nn.Embedding(
        cfg.vocab_size, cfg.width,
        _weight=torch.empty(cfg.vocab_size, cfg.width))
    owner.positional_embedding = nn.Parameter(
        torch.empty(cfg.context_length + int(cfg.embed_cls), cfg.width))
    if cfg.embed_cls:
        owner.cls_emb = nn.Parameter(torch.empty(cfg.width))
    owner.transformer = Transformer(cfg.width, cfg.layers, cfg.heads,
                                    cfg.mlp_ratio, cfg.ls_init_value, act_fn,
                                    dtype, fuse_ln, remat, remat_policy,
                                    use_flash)
    owner.ln_final = LayerNorm(cfg.width)
    owner.text_projection = (
        Linear(cfg.width, output_dim, dtype=dtype) if cfg.proj_bias
        else nn.Parameter(torch.empty(cfg.width, output_dim)))


def init_text_tower(owner: nn.Module, generator: torch.Generator) -> None:
    nn.init.normal_(owner.token_embedding.weight, std=0.02,
                    generator=generator)
    nn.init.normal_(owner.positional_embedding, std=0.01, generator=generator)
    if owner.text_cfg.embed_cls:
        nn.init.normal_(owner.cls_emb, std=0.01, generator=generator)
    if isinstance(owner.text_projection, nn.Parameter):
        nn.init.normal_(owner.text_projection,
                        std=owner.text_cfg.width ** -0.5, generator=generator)


def _pool(x: torch.Tensor, text: torch.Tensor, pool_type: str
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, tokens) of the LayerNormed states, by JAX's pool types."""
    if pool_type == "first":
        return x[:, 0], x[:, 1:]
    if pool_type == "last":
        return x[:, -1], x[:, :-1]
    if pool_type == "argmax":
        rows = torch.arange(x.shape[0], device=x.device)
        return x[rows, text.argmax(dim=-1)], x
    return x, x


def encode_tokens(owner: nn.Module, text: torch.Tensor,
                  dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """text: [B, L] token ids -> (pooled [B, out], tokens [B, L, width]).

    Without ``embed_cls``, causal attention runs through the kernel's
    causal flag, with no mask tensor, and the pooled feature is the
    ``pool_type`` one (the highest token id, EOT, by default).  With it,
    the CLS tower of the module's text, its mask gating ``pad_id``."""
    cfg = owner.text_cfg
    seq_len = text.shape[1]
    x = owner.token_embedding(text).to(dtype)
    if cfg.embed_cls:
        cls = owner.cls_emb.to(dtype).expand(x.shape[0], 1, cfg.width)
        x = torch.cat([x, cls], dim=1)
        mask = coca_cls_pad_mask(text, cfg.pad_id)
        if not cfg.no_causal_mask:
            mask = additive_causal_mask(seq_len + 1, text.device) + mask
        x = x + owner.positional_embedding[:seq_len + 1].to(dtype)
        x = owner.transformer(x, mask=mask[:, None])
        pooled, tokens = owner.ln_final(x[:, -1]), x[:, :-1]
    else:
        x = x + owner.positional_embedding[:seq_len].to(dtype)
        x = owner.transformer(x, causal=not cfg.no_causal_mask)
        pooled, tokens = _pool(owner.ln_final(x), text, cfg.pool_type)
    proj = owner.text_projection
    if isinstance(proj, nn.Module):
        return proj(pooled), tokens
    return torch.matmul(pooled.to(dtype), proj.to(dtype)), tokens


class TextTransformer(nn.Module):
    """The text tower as a module of its own, OpenCLIP's ``text`` of
    CoCa: ``forward(text) -> (pooled, tokens)``."""

    def __init__(self, cfg: TextCfg, output_dim: int,
                 act_fn: Callable[[torch.Tensor], torch.Tensor],
                 dtype: torch.dtype, remat: bool = False,
                 remat_policy: str = "", use_flash: Optional[bool] = None):
        super().__init__()
        self.dtype = dtype
        add_text_tower(self, cfg, output_dim, act_fn, dtype, remat=remat,
                       remat_policy=remat_policy, use_flash=use_flash)

    def init_weights(self, generator: torch.Generator) -> None:
        init_text_tower(self, generator)

    def forward(self, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return encode_tokens(self, text, self.dtype)
