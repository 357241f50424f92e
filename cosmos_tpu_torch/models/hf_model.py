"""The HF text tower (counterpart of ``cosmos_tpu/models/hf_model.py``): an
encoder built from an offline ``hf_model_config`` or the ``config.json``
of a local ``hf_model_name`` directory (``hf_arch.py``: BERT, RoBERTa,
XLM-RoBERTa, ELECTRA and RoBERTa-PreLayerNorm in ``hf_bert.py``,
DistilBERT in ``hf_distilbert.py``, ALBERT in ``hf_albert.py``, T5 and mT5
in ``hf_t5.py``, the decoder LMs GPT-2 in ``hf_gpt2.py``, OPT in
``hf_opt.py``, Llama, Mistral and Gemma in ``hf_llama.py``), a pooler and
a projection head to the CLIP embedding width.

``HFTextTower`` is OpenCLIP's ``HFTextEncoder`` under the ``text`` of its
``CustomTextCLIP``: the encoder is ``transformer``, the head ``proj``
(``nn.Linear`` for ``linear``; ``nn.Sequential(Linear, GELU, Linear)``,
hidden width ``(d + out) // 2``, exact GELU, no biases, for ``mlp``).  Its
forward is the JAX tower's: the attention mask is ``text != pad_id`` with
the config's pad id, RoBERTa-family position ids count up from
``pad_id + 1`` over real tokens and sit at ``pad_id`` on pads, token types
are zeros (the decoder LMs take neither: their positions are ``arange``),
and ``cls_pooler`` takes the encoder's pooler output (the
first state where it has none) and the states after the first as tokens.

``load_hf_pretrained`` reads a local directory's weights as
``FlaxAutoModel.from_pretrained`` reads them (``flax_model.msgpack``, its
sharded index, or a torch-layout ``model.safetensors``) into the encoder;
``create_model`` calls it when ``hf_model_pretrained`` is set and no
``pretrained`` checkpoint is given, as JAX's factory does.  A hub
``hf_model_name``, that is one that names no local directory, needs a
download and is refused (``ROADMAP.md``, "Not queued").
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn

from .hf_albert import AlbertModel
from .hf_arch import BERT_FAMILY, LLAMA_FAMILY, T5_FAMILY, resolve_hf_config
from .hf_bert import BertModel
from .hf_distilbert import DistilBertModel
from .hf_gpt2 import GPT2Model
from .hf_llama import LlamaModel
from .hf_opt import OPTModel
from .hf_t5 import T5EncoderModel
from .layers import Linear

logger = logging.getLogger(__name__)

NOT_QUEUED = 'ROADMAP.md queue 1, "Not queued": it needs a download'
# the files transformers looks for in a local directory
CONFIG_NAME = "config.json"
FLAX_WEIGHTS_NAME = "flax_model.msgpack"
FLAX_WEIGHTS_INDEX_NAME = "flax_model.msgpack.index.json"
SAFE_WEIGHTS_NAME = "model.safetensors"
SAFE_WEIGHTS_INDEX_NAME = "model.safetensors.index.json"
WEIGHTS_NAME = "pytorch_model.bin"
# the pooler of each architecture when hf_pooler_type is unset (the
# "pooler" entries of JAX's hf_configs.arch_dict; every other type pools
# by the mean)
DEFAULT_POOLER = {"bert": "cls_pooler"}
# the types whose position ids are pad-offset in JAX's tower (its list also
# names camembert, which has no Flax model)
PAD_OFFSET_POSITIONS = ("roberta", "xlm-roberta")

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
        kind = config.model_type
        # whether the encoder takes token types and position ids
        self.takes_ids = kind in BERT_FAMILY or kind == "albert"
        if kind in BERT_FAMILY:
            self.transformer = BertModel(config, dtype)
        elif kind == "albert":
            self.transformer = AlbertModel(config, dtype)
        elif kind == "distilbert":
            self.transformer = DistilBertModel(config, dtype)
        elif kind == "gpt2":
            self.transformer = GPT2Model(config, dtype)
        elif kind == "opt":
            self.transformer = OPTModel(config, dtype)
        elif kind in LLAMA_FAMILY:
            self.transformer = LlamaModel(config, dtype)
        else:
            self.transformer = T5EncoderModel(config, dtype)
        self.width = (config.d_model if kind in T5_FAMILY else config.dim
                      if kind == "distilbert" else config.n_embd
                      if kind == "gpt2" else config.word_embed_proj_dim
                      if kind == "opt" else config.hidden_size)
        self.proj = projection_head(self.width, output_dim, proj_type, dtype)

    def forward(self, text: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mask = (text != self.pad_id).to(torch.int32)
        if self.takes_ids:
            if self.config.model_type in PAD_OFFSET_POSITIONS:
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


def local_directory(hf_model_name: str) -> str:
    """``hf_model_name`` where it is a local directory; a hub name is
    refused."""
    if not os.path.isdir(hf_model_name):
        raise NotImplementedError(
            f"hf_model_name {hf_model_name!r} is not a local directory: a "
            f"hub name needs a download ({NOT_QUEUED}); point it at a "
            f"directory holding {CONFIG_NAME} and {FLAX_WEIGHTS_NAME}, or "
            "pass the config's fields as text_hf_model_config")
    return hf_model_name


def hf_config_dict(text_cfg) -> Dict[str, Any]:
    """The HF config's fields: ``hf_model_config`` where it is given (it
    wins over ``hf_model_name``, as in JAX), else the ``config.json`` of
    the ``hf_model_name`` directory."""
    if text_cfg.hf_model_config:
        return text_cfg.hf_model_config
    path = os.path.join(local_directory(text_cfg.hf_model_name), CONFIG_NAME)
    if not os.path.isfile(path):
        raise OSError(f"{text_cfg.hf_model_name} does not appear to have a "
                      f"file named {CONFIG_NAME}")
    with open(path) as f:
        return json.load(f)


def build_hf_text_tower(text_cfg, embed_dim: int,
                        dtype: torch.dtype = torch.float32) -> HFTextTower:
    """``text_cfg`` with ``hf_model_config`` or a local ``hf_model_name``
    directory -> the tower, with its own random weights
    (``load_hf_pretrained`` loads the directory's).  The pooler is
    ``hf_pooler_type`` or the architecture's (``DEFAULT_POOLER``), the pad id
    the config's (``text_cfg.pad_id`` where it has none)."""
    config = resolve_hf_config(hf_config_dict(text_cfg))
    pooler = text_cfg.hf_pooler_type or DEFAULT_POOLER.get(
        config.model_type, "mean_pooler")
    pad = config.pad_token_id
    return HFTextTower(config, embed_dim, pooler_type=pooler,
                       proj_type=text_cfg.hf_proj_type or "mlp",
                       pad_id=text_cfg.pad_id if pad is None else pad,
                       dtype=dtype)


def read_hf_weights(directory: str) -> Tuple[str, Dict[str, Any]]:
    """The weights of a local directory, from the file
    ``FlaxAutoModel.from_pretrained`` picks there: ``("flax", tree)`` from
    ``flax_model.msgpack`` or its sharded index, ``("pt", state dict)`` from
    a ``model.safetensors`` that torch wrote.  A directory with
    ``pytorch_model.bin`` alone raises, as JAX's load does, which passes no
    ``from_pt``."""
    from .checkpoint import read_safetensors
    from .msgpack import read_msgpack, read_msgpack_index

    def path(name: str) -> str:
        return os.path.join(directory, name)

    if os.path.isfile(path(FLAX_WEIGHTS_NAME)):
        return "flax", read_msgpack(path(FLAX_WEIGHTS_NAME))
    if os.path.isfile(path(FLAX_WEIGHTS_INDEX_NAME)):
        return "flax", read_msgpack_index(path(FLAX_WEIGHTS_INDEX_NAME))
    if os.path.isfile(path(SAFE_WEIGHTS_NAME)):
        state, metadata = read_safetensors(path(SAFE_WEIGHTS_NAME))
        layout = (metadata or {}).get("format")
        if layout != "pt":
            raise OSError(
                f"{path(SAFE_WEIGHTS_NAME)}: a safetensors archive of "
                f"{layout!r} layout; the port reads torch's (\"pt\")")
        return "pt", state
    if os.path.isfile(path(SAFE_WEIGHTS_INDEX_NAME)):
        raise NotImplementedError(
            f"{path(SAFE_WEIGHTS_INDEX_NAME)}: transformers' Flax loader, "
            "and so the JAX package, refuses sharded safetensors "
            "checkpoints (\"Support for sharded checkpoints using "
            "safetensors is coming soon!\")")
    if os.path.isfile(path(WEIGHTS_NAME)):
        raise OSError(
            f"Error no file named {FLAX_WEIGHTS_NAME} found in directory "
            f"{directory} but there is a file for PyTorch weights. Use "
            "`from_pt=True` to load this model from those weights.")
    raise OSError(f"Error no file named {FLAX_WEIGHTS_NAME} or {WEIGHTS_NAME} "
                  f"found in directory {directory}.")


def load_hf_pretrained(model: nn.Module, hf_model_name: str) -> List[str]:
    """The weights of the local directory ``hf_model_name`` into the HF
    tower's encoder (``model.text.transformer``), as JAX's
    ``load_hf_pretrained_params`` puts ``FlaxAutoModel.from_pretrained``'s
    under ``text/hf``; returns the encoder's parameters the file lacks.
    Those keep the port's own initial values, where transformers draws
    fresh ones, and are named in a warning; leaves the tower does not have
    (a head model's ``lm_head`` or ``cls``, T5's decoder) are left out."""
    from .convert import hf_pretrained_state_dict

    kind, weights = read_hf_weights(local_directory(hf_model_name))
    encoder = model.text.transformer
    state, missing, unexpected = hf_pretrained_state_dict(
        weights, kind, encoder, model.text.config.model_type)
    with torch.no_grad():
        for name, p in encoder.named_parameters():
            if name in state:
                p.copy_(state[name])
    if unexpected:
        logger.info("%s: %d leaves the HF text tower does not use, under %s",
                    hf_model_name, len(unexpected),
                    sorted({k.split("/")[0].split(".")[0]
                            for k in unexpected}))
    if missing:
        logger.warning(
            "%s lacks these weights of the HF text tower, which keep their "
            "initial values: %s", hf_model_name, sorted(missing))
    return missing
