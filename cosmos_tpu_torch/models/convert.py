"""Weights into the port: the JAX package's parameter tree and reference
OpenCLIP/COSMOS ``.pt`` checkpoints, both as state dicts of this package's
``CLIP``, which keeps OpenCLIP's names.

The name map is this package's own copy of the one in
``cosmos_tpu/models/checkpoint.py`` (native-ViT towers only).  Transforms
from the flax layout: ``"t"`` transposes a Dense kernel ``[in, out]`` to
torch's ``[out, in]``; ``"conv"`` reorders an HWIO kernel to OIHW.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Entry = Tuple[str, Tuple[str, ...], Optional[str]]


def _block_entries(prefix_t: str, prefix_f: Tuple[str, ...],
                   i: int) -> List[Entry]:
    t = f"{prefix_t}.resblocks.{i}"
    f = prefix_f + (f"resblocks_{i}",)
    return [
        (f"{t}.ln_1.weight", f + ("ln_1", "scale"), None),
        (f"{t}.ln_1.bias", f + ("ln_1", "bias"), None),
        (f"{t}.attn.in_proj_weight", f + ("attn", "in_proj_kernel"), "t"),
        (f"{t}.attn.in_proj_bias", f + ("attn", "in_proj_bias"), None),
        (f"{t}.attn.out_proj.weight", f + ("attn", "out_proj", "kernel"), "t"),
        (f"{t}.attn.out_proj.bias", f + ("attn", "out_proj", "bias"), None),
        (f"{t}.ls_1.gamma", f + ("ls_1", "gamma"), None),
        (f"{t}.ln_2.weight", f + ("ln_2", "scale"), None),
        (f"{t}.ln_2.bias", f + ("ln_2", "bias"), None),
        (f"{t}.mlp.c_fc.weight", f + ("mlp", "c_fc", "kernel"), "t"),
        (f"{t}.mlp.c_fc.bias", f + ("mlp", "c_fc", "bias"), None),
        (f"{t}.mlp.c_proj.weight", f + ("mlp", "c_proj", "kernel"), "t"),
        (f"{t}.mlp.c_proj.bias", f + ("mlp", "c_proj", "bias"), None),
        (f"{t}.ls_2.gamma", f + ("ls_2", "gamma"), None),
    ]


def _cross_pool_entries(prefix_t: str,
                        prefix_f: Tuple[str, ...]) -> List[Entry]:
    return [
        (f"{prefix_t}.ln_q.weight", prefix_f + ("ln_q", "scale"), None),
        (f"{prefix_t}.ln_q.bias", prefix_f + ("ln_q", "bias"), None),
        (f"{prefix_t}.ln_k.weight", prefix_f + ("ln_k", "scale"), None),
        (f"{prefix_t}.ln_k.bias", prefix_f + ("ln_k", "bias"), None),
        (f"{prefix_t}.attn.in_proj_weight",
         prefix_f + ("attn", "in_proj_kernel"), "t"),
        (f"{prefix_t}.attn.in_proj_bias",
         prefix_f + ("attn", "in_proj_bias"), None),
        (f"{prefix_t}.attn.out_proj.weight",
         prefix_f + ("attn", "out_proj", "kernel"), "t"),
        (f"{prefix_t}.attn.out_proj.bias",
         prefix_f + ("attn", "out_proj", "bias"), None),
    ]


def build_name_map(vision_layers: int, text_layers: int) -> List[Entry]:
    """(torch key, flax path, transform) for every parameter a native-ViT
    COSMOS CLIP may have; entries whose flax path is absent are skipped."""
    entries: List[Entry] = [
        ("logit_scale", ("logit_scale",), None),
        ("token_embedding.weight",
         ("text", "token_embedding", "embedding"), None),
        ("positional_embedding", ("text", "positional_embedding"), None),
        ("ln_final.weight", ("text", "ln_final", "scale"), None),
        ("ln_final.bias", ("text", "ln_final", "bias"), None),
        ("text_projection", ("text", "text_projection_kernel"), None),
        ("visual.conv1.weight", ("visual", "conv1_kernel"), "conv"),
        ("visual.class_embedding", ("visual", "class_embedding"), None),
        ("visual.positional_embedding",
         ("visual", "positional_embedding"), None),
        ("visual.ln_pre.weight", ("visual", "ln_pre", "scale"), None),
        ("visual.ln_pre.bias", ("visual", "ln_pre", "bias"), None),
        ("visual.ln_post.weight", ("visual", "ln_post", "scale"), None),
        ("visual.ln_post.bias", ("visual", "ln_post", "bias"), None),
        ("visual.proj", ("visual", "proj"), None),
    ]
    for i in range(vision_layers):
        entries += _block_entries("visual.transformer",
                                  ("visual", "transformer"), i)
    for i in range(text_layers):
        entries += _block_entries("transformer", ("text", "transformer"), i)
    entries += [
        ("distill_logit_scale", ("distill_logit_scale",), None),
        ("image_token_mapping.weight",
         ("image_token_mapping", "kernel"), "t"),
        ("image_token_mapping.bias", ("image_token_mapping", "bias"), None),
        ("text_token_mapping.weight", ("text_token_mapping", "kernel"), "t"),
        ("text_token_mapping.bias", ("text_token_mapping", "bias"), None),
    ]
    entries += _cross_pool_entries("visual.attn_cross_pool",
                                   ("visual", "attn_cross_pool"))
    entries += _cross_pool_entries("text_attn_cross_pool",
                                   ("text", "attn_cross_pool"))
    return entries


def _from_flax(value: np.ndarray, tf: Optional[str]) -> np.ndarray:
    if tf is None:
        return value
    if tf == "t":
        return value.T
    if tf == "conv":  # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    raise ValueError(tf)


def _count_blocks(tower: Dict[str, Any]) -> int:
    return len([k for k in tower["transformer"] if k.startswith("resblocks")])


def state_dict_from_jax_params(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP param tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as this package's state dict."""
    name_map = build_name_map(_count_blocks(params["visual"]),
                              _count_blocks(params["text"]))
    out: Dict[str, torch.Tensor] = {}
    for tkey, fpath, tf in name_map:
        node: Any = params
        try:
            for p in fpath:
                node = node[p]
        except KeyError:
            continue
        value = np.array(_from_flax(np.asarray(node), tf), order="C")
        out[tkey] = torch.from_numpy(value)
    return out


def load_checkpoint(path: str, which: str = "student"
                    ) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` checkpoint as a state dict for ``CLIP``.

    Takes a bare state dict or a training checkpoint
    ``{"student": ..., "teacher": ..., ...}`` (``which`` picks one) or
    ``{"state_dict": ...}``; strips DistributedDataParallel's ``module.``
    prefix and drops the non-parameter ``attn_mask`` buffer.  The file is
    read with ``weights_only=True``: tensors and plain containers only."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and which in ckpt:
        sd = ckpt[which]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()
            if not k.endswith("attn_mask")}
