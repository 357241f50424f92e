"""The local half of the HF-hub export (counterpart of
``cosmos_tpu/models/push_to_hf_hub.py:20-97``): ``save_for_hf`` writes a
directory with the model's weights as OpenCLIP reads them
(``open_clip_pytorch_model.bin``, the port's state dict), as flax reads
them (``open_clip_model.msgpack``, the JAX package's parameter tree, built
by inverting the weight bridge's name map) and its config
(``open_clip_config.json``, ``save_config_for_hf``); ``generate_readme``
writes the model card.  The uploads (``push_to_hf_hub``,
``push_pretrained_to_hf_hub``) are refused: they need the network.

``save_for_hf`` takes the model alone, which holds its weights; the JAX
package's takes ``(model, params, ...)``.  It exports what the JAX
package's bridge can name: the native ViT and the ModifiedResNet CLIP (and
CoCa, whose tree the port's bridge names).  An HF text tower raises, as
the JAX package's ``params_to_torch_state_dict`` does on an HF tree; so
does a timm-family tower, on which JAX's export fails too (its
``params_to_torch_state_dict`` reads ``params["visual"]["transformer"]``).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from pathlib import Path
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

HF_WEIGHTS_NAME = "open_clip_pytorch_model.bin"
HF_FLAX_WEIGHTS_NAME = "open_clip_model.msgpack"
HF_CONFIG_NAME = "open_clip_config.json"

# config fields of this package's own (SigLIP and HF plumbing) that
# OpenCLIP's CLIPVisionCfg/CLIPTextCfg would refuse, left out as JAX's
# export leaves them out
_REPO_ONLY_VISION = ("class_token", "patch_bias", "no_proj")
_REPO_ONLY_TEXT = ("hf_model_config",)


def save_config_for_hf(model, config_path: str,
                       preprocess_cfg: Optional[Dict] = None) -> None:
    vision_cfg = {
        k: v for k, v in dataclasses.asdict(model.cfg.vision_cfg).items()
        if k not in _REPO_ONLY_VISION
    }
    text_cfg = {
        k: v for k, v in dataclasses.asdict(model.cfg.text_cfg).items()
        if k not in _REPO_ONLY_TEXT and v is not None
    }
    cfg = {
        "model_cfg": {
            "embed_dim": model.cfg.embed_dim,
            "vision_cfg": vision_cfg,
            "text_cfg": text_cfg,
            "quick_gelu": model.cfg.quick_gelu,
        },
        "preprocess_cfg": preprocess_cfg
        or {
            "mean": (0.48145466, 0.4578275, 0.40821073),
            "std": (0.26862954, 0.26130258, 0.27577711),
            "size": model.cfg.vision_cfg.image_size,
        },
    }
    Path(config_path).write_text(json.dumps(cfg, indent=2))


def _to_flax(value: torch.Tensor, tf: Optional[str]) -> torch.Tensor:
    """``convert._from_flax`` inverted."""
    if tf == "t":
        return value.t()
    if tf == "conv":  # OIHW -> HWIO
        return value.permute(2, 3, 1, 0)
    if tf is not None:
        raise ValueError(tf)
    return value


def params_tree(model: torch.nn.Module) -> Dict[str, Any]:
    """The JAX package's parameter tree of ``model`` (float32 CPU tensors):
    the weight bridge's name map, inverted (a ModifiedResNet's BatchNorm
    statistics among its parameters, as JAX's tree keeps them)."""
    from .convert import model_name_map

    if getattr(model, "text_cfg", None) is not None and model.text_cfg.is_hf:
        raise NotImplementedError(
            "save_for_hf on an HF text tower: the JAX package's weight "
            "bridge (params_to_torch_state_dict) has no names for it and "
            "its save_for_hf fails there")
    if not any(hasattr(model.visual, m) for m in ("transformer", "attnpool")):
        raise NotImplementedError(
            "save_for_hf exports the native ViT and the ModifiedResNet "
            "tower, as JAX's does: its params_to_torch_state_dict reads "
            "params['visual']['transformer'] and fails on a timm-family "
            "tower's tree")
    sd = model.state_dict()
    tree: Dict[str, Any] = {}
    for key, path, tf in model_name_map(model):
        if key not in sd:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = _to_flax(sd[key].detach().float().cpu(),
                                  tf).contiguous()
    return _sorted(tree)


def _sorted(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Keys in JAX's order (its pytrees flatten a dict by sorted keys), so
    that the flax file is the bytes JAX writes."""
    return {k: _sorted(v) if isinstance(v, dict) else v
            for k, v in sorted(tree.items())}


def save_for_hf(model: torch.nn.Module, save_directory: str) -> None:
    from .factory import get_model_preprocess_cfg
    from .msgpack import write_msgpack

    tree = params_tree(model)
    os.makedirs(save_directory, exist_ok=True)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(sd, os.path.join(save_directory, HF_WEIGHTS_NAME))
    write_msgpack(tree, os.path.join(save_directory, HF_FLAX_WEIGHTS_NAME))
    save_config_for_hf(model, os.path.join(save_directory, HF_CONFIG_NAME),
                       preprocess_cfg=get_model_preprocess_cfg(model))
    logger.info(f"saved HF export to {save_directory}")


def generate_readme(model_card: Dict, model_name: str) -> str:
    lines = ["---", "tags:", "- clip", "- cosmos-tpu",
             "library_name: open_clip", "---", "",
             f"# Model card for {model_name}", ""]
    if "description" in model_card:
        lines += [model_card["description"], ""]
    for section, text in model_card.get("sections", {}).items():
        lines += [f"## {section}", "", str(text), ""]
    return "\n".join(lines)
