"""The HF text tower (counterpart of ``cosmos_tpu/models/hf_model.py``): an
encoder built from an offline ``hf_model_config`` (``hf_arch.py``: BERT,
RoBERTa, XLM-RoBERTa in ``hf_bert.py``, T5 and mT5 in ``hf_t5.py``), a
pooler and a projection head to the CLIP embedding width.

``HFTextTower`` is OpenCLIP's ``HFTextEncoder`` under the ``text`` of its
``CustomTextCLIP``: the encoder is ``transformer``, the head ``proj``
(``nn.Linear`` for ``linear``; ``nn.Sequential(Linear, GELU, Linear)``,
hidden width ``(d + out) // 2``, exact GELU, no biases, for ``mlp``).  Its
forward is the JAX tower's: the attention mask is ``text != pad_id`` with
the config's pad id, RoBERTa-family position ids count up from
``pad_id + 1`` over real tokens and sit at ``pad_id`` on pads, token types
are zeros, and ``cls_pooler`` takes the encoder's pooler output (the
first state where it has none) and the states after the first as tokens.

A hub ``hf_model_name``, its pretrained weights and HF tokenizers need a
download and are refused (``ROADMAP.md``, "Not queued").
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch import nn

from .hf_arch import BERT_FAMILY, resolve_hf_config
from .hf_bert import BertModel
from .hf_t5 import T5EncoderModel
from .layers import Linear

NOT_QUEUED = 'ROADMAP.md queue 1, "Not queued": it needs a download'
SHARDED = 'ROADMAP.md queue 1, "HF text towers under FSDP and TP"'
# the pooler of each architecture when hf_pooler_type is unset (the
# "pooler" entries of JAX's hf_configs.arch_dict; every other type pools
# by the mean)
DEFAULT_POOLER = {"bert": "cls_pooler"}

def mean_pooler(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(1) / m.sum(1).clamp_min(1.0)


def max_pooler(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return hidden.masked_fill(~mask[..., None].bool(), -torch.inf).amax(1)


def cls_pooler(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0]


def cls_last_hidden_state_pooler(hidden: torch.Tensor,
                                 mask: torch.Tensor) -> torch.Tensor:
    return hidden[:, 0]


POOLERS: Dict[str, Callable] = {f.__name__: f for f in (
    mean_pooler, max_pooler, cls_pooler, cls_last_hidden_state_pooler)}


def projection_head(d: int, output_dim: int, proj_type: str,
                    dtype: torch.dtype) -> nn.Module:
    """The JAX tower's ``HFProjectionHead`` in OpenCLIP's layout, drawn
    from lecun-normal as flax's ``Dense`` default."""
    if proj_type == "linear":
        return Linear(d, output_dim, bias=False, dtype=dtype)
    hidden = (d + output_dim) // 2
    return nn.Sequential(Linear(d, hidden, bias=False, dtype=dtype),
                         nn.GELU(),
                         Linear(hidden, output_dim, bias=False, dtype=dtype))


class HFTextTower(nn.Module):
    """``forward(text [B, L]) -> (pooled and projected [B, out], tokens
    [B, L', D])``, the native tower's surface."""

    def __init__(self, config, output_dim: int,
                 pooler_type: str = "mean_pooler", proj_type: str = "mlp",
                 pad_id: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if pooler_type not in POOLERS:
            raise ValueError(f"unknown HF pooler {pooler_type!r}: "
                             f"{sorted(POOLERS)}")
        if proj_type not in ("linear", "mlp"):
            raise ValueError(f"unknown HF projection {proj_type!r}")
        self.config, self.pooler_type = config, pooler_type
        self.pad_id = pad_id
        self.bert_family = config.model_type in BERT_FAMILY
        if self.bert_family:
            self.transformer = BertModel(config, dtype)
            self.width = config.hidden_size
        else:
            self.transformer = T5EncoderModel(config, dtype)
            self.width = config.d_model
        self.proj = projection_head(self.width, output_dim, proj_type, dtype)

    def forward(self, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = (text != self.pad_id).to(torch.int32)
        if self.bert_family:
            if self.config.model_type in ("roberta", "xlm-roberta"):
                positions = mask.cumsum(1) * mask + self.config.pad_token_id
            else:
                positions = None
            hidden, pooler_out = self.transformer(
                text, mask, torch.zeros_like(text), positions)
        else:
            hidden, pooler_out = self.transformer(text, mask)
        if self.pooler_type == "cls_pooler":
            pooled = pooler_out if pooler_out is not None else hidden[:, 0]
            tokens = hidden[:, 1:]
        else:
            pooled, tokens = POOLERS[self.pooler_type](hidden, mask), hidden
        return self.proj(pooled), tokens


def build_hf_text_tower(text_cfg, embed_dim: int,
                        dtype: torch.dtype = torch.float32) -> HFTextTower:
    """``text_cfg`` with ``hf_model_config`` -> the tower.  The pooler is
    ``hf_pooler_type`` or the architecture's (``DEFAULT_POOLER``), the pad id
    the config's (``text_cfg.pad_id`` where it has none)."""
    if not text_cfg.hf_model_config:
        raise NotImplementedError(
            f"hf_model_name {text_cfg.hf_model_name!r} without "
            f"hf_model_config: the HF config is on the hub ({NOT_QUEUED}); "
            "pass the config's fields as text_hf_model_config")
    if text_cfg.hf_model_name and text_cfg.hf_model_pretrained:
        raise NotImplementedError(
            f"the pretrained weights of {text_cfg.hf_model_name!r} are on "
            f"the hub ({NOT_QUEUED}); pass text_hf_model_pretrained=False")
    config = resolve_hf_config(text_cfg.hf_model_config)
    pooler = text_cfg.hf_pooler_type or DEFAULT_POOLER.get(
        config.model_type, "mean_pooler")
    pad = config.pad_token_id
    return HFTextTower(config, embed_dim, pooler_type=pooler,
                       proj_type=text_cfg.hf_proj_type or "mlp",
                       pad_id=text_cfg.pad_id if pad is None else pad,
                       dtype=dtype)


def refuse_sharded(model: nn.Module, mode: str) -> None:
    """FSDP and tensor parallelism have no placement for an HF tower's
    leaves yet: raise for such a model (data parallelism takes it)."""
    cfg = getattr(model, "text_cfg", None)
    if cfg is not None and cfg.is_hf:
        raise NotImplementedError(
            f"{mode} on an HF text tower is not ported ({SHARDED})")
