"""Weights into the port: the JAX package's parameter tree and reference
OpenCLIP/COSMOS ``.pt`` checkpoints, both as state dicts of this package's
``CLIP``, which keeps OpenCLIP's names.

The name map is this package's own copy of the one in
``cosmos_tpu/models/checkpoint.py``.  Transforms from the flax layout:
``"t"`` transposes a Dense kernel ``[in, out]`` to torch's ``[out, in]``;
``"conv"`` reorders an HWIO kernel to OIHW; ``"cls"`` and ``"pos"`` add the
leading unit axes of timm's ``cls_token`` ``[1, 1, W]`` and ``pos_embed``
``[1, N, W]``.

The other vision towers (``vision_entries``): a timm-family tower takes
OpenCLIP's ``TimmModel`` names, ``visual.trunk.<timm key>`` in the layout
the JAX package's ``convert_timm_vit``/``convert_timm_eva``/
``convert_timm_convnext`` read, and ``visual.head.proj`` or
``visual.head.mlp.fc1/fc2``; the FastViT trunk and the MCi stem take the
JAX tree's paths with dots (a ``kernel`` as ``weight``); ModifiedResNet
takes OpenAI's names, ``build_resnet_vision_map``'s.
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
        # SigLIP-initialised models (init_logit_bias); OpenCLIP's name
        ("logit_bias", ("logit_bias",), None),
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


def _leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _leaf(name: str, value) -> Tuple[str, Optional[str]]:
    """A flax leaf name -> (torch's, transform)."""
    if name == "kernel":
        return "weight", "conv" if np.ndim(value) == 4 else "t"
    return {"scale": "weight", "mean": "running_mean",
            "var": "running_var"}.get(name, name), None


# trunk leaves of the timm ViT and EVA02 at the trunk's top level
_TRUNK_LEAVES = {
    "conv1_kernel": ("patch_embed.proj.weight", "conv"),
    "conv1_bias": ("patch_embed.proj.bias", None),
    "class_embedding": ("cls_token", "cls"),
    "positional_embedding": ("pos_embed", "pos"),
}
# module renames inside a block: timm ViT and EVA02
_VIT_BLOCK = {"ln_1": "norm1", "ln_2": "norm2", "out_proj": "proj",
              "c_fc": "fc1", "c_proj": "fc2", "inner_ln": "norm"}
_EVA_MLP = {"w1": "mlp.fc1_g", "w2": "mlp.fc1_x", "ffn_ln": "mlp.norm",
            "w3": "mlp.fc2"}


def _trunk_key(path: Tuple[str, ...], value) -> Tuple[str, Optional[str]]:
    """A leaf path under ``visual/trunk`` -> (torch key below
    ``visual.trunk.``, transform)."""
    if len(path) == 1:
        if path[0] in _TRUNK_LEAVES:
            return _TRUNK_LEAVES[path[0]]
        m = re.fullmatch(r"stem(\d+)_(kernel|bias)", path[0])
        if m:  # the MCi stem
            return (f"stem{m[1]}.{'weight' if m[2] == 'kernel' else 'bias'}",
                    "conv" if m[2] == "kernel" else None)
    *mods, leaf = path
    name, tf = _leaf(leaf, value)
    if mods[0] == "ln_post":                               # ViT, EVA02
        return f"norm.{name}", tf
    if mods[0] == "transformer":                           # timm ViT
        i = mods[1].split("_")[1]
        rest = [_VIT_BLOCK.get(m, m) for m in mods[2:]]
        if leaf == "in_proj_kernel":
            rest, name, tf = rest + ["qkv"], "weight", "t"
        elif leaf == "in_proj_bias":
            rest, name = rest + ["qkv"], "bias"
        return ".".join([f"blocks.{i}", *rest, name]), tf
    if re.fullmatch(r"resblocks_\d+", mods[0]):            # EVA02
        i = mods[0].split("_")[1]
        rest = [_EVA_MLP.get(m, _VIT_BLOCK.get(m, m)) for m in mods[1:]]
        return ".".join([f"blocks.{i}", *rest, name]), tf
    m = re.fullmatch(r"stages_(\d+)_blocks_(\d+)", mods[0])  # ConvNeXt
    if m:
        rest = [{"mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}.get(x, x)
                for x in mods[1:]]
        return ".".join([f"stages.{m[1]}.blocks.{m[2]}", *rest, name]), tf
    convnext = {"stem_conv": "stem.0", "stem_norm": "stem.1",
                "head_norm": "head.norm"}
    if mods[0] in convnext:
        return f"{convnext[mods[0]]}.{name}", tf
    m = re.fullmatch(r"down_(norm|conv)_(\d+)", mods[0])
    if m:
        return (f"stages.{m[2]}.downsample.{0 if m[1] == 'norm' else 1}."
                f"{name}", tf)
    return ".".join([*mods, name]), tf                     # FastViT


def _resnet_key(path: Tuple[str, ...], value) -> Tuple[str, Optional[str]]:
    """A leaf path under a ModifiedResNet ``visual`` -> (torch key below
    ``visual.``, transform): OpenAI's names."""
    *mods, leaf = path
    name, tf = _leaf(leaf, value)
    m = re.fullmatch(r"layer(\d+)_(\d+)", mods[0])
    if m:
        sub = {"downsample_conv": "downsample.0",
               "downsample_bn": "downsample.1"}.get(mods[1], mods[1])
        return f"layer{m[1]}.{m[2]}.{sub}.{name}", tf
    return ".".join([*mods, name]), tf


def vision_entries(visual: Dict[str, Any]) -> List[Entry]:
    """(torch key, flax path, transform) of every leaf of a timm-family or
    ModifiedResNet ``visual`` subtree; ``[]`` for the native ViT, whose
    entries ``build_name_map`` lists."""
    entries: List[Entry] = []
    if "trunk" in visual:
        for path, value in _leaves(visual["trunk"]):
            key, tf = _trunk_key(path, value)
            entries.append((f"visual.trunk.{key}",
                            ("visual", "trunk") + path, tf))
        head = {"head": "head.proj", "head_fc1": "head.mlp.fc1",
                "head_fc2": "head.mlp.fc2"}
        for path, value in _leaves(visual):
            if path[0] in head:
                name, tf = _leaf(path[-1], value)
                entries.append((f"visual.{head[path[0]]}.{name}",
                                ("visual",) + path, tf))
    elif "attnpool" in visual:
        for path, value in _leaves(visual):
            key, tf = _resnet_key(path, value)
            entries.append((f"visual.{key}", ("visual",) + path, tf))
    return entries


def _from_flax(value: np.ndarray, tf: Optional[str]) -> np.ndarray:
    if tf is None:
        return value
    if tf == "t":
        return value.T
    if tf == "conv":  # HWIO -> OIHW
        return value.transpose(3, 2, 0, 1)
    if tf == "cls":
        return value.reshape(1, 1, -1)
    if tf == "pos":
        return value[None]
    raise ValueError(tf)


def _count_blocks(tower: Dict[str, Any]) -> int:
    return len([k for k in tower.get("transformer", {})
                if k.startswith("resblocks")])


def state_dict_from_jax_params(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP param tree (leaves as numpy arrays, or
    anything ``np.asarray`` takes) as this package's state dict."""
    name_map = build_name_map(_count_blocks(params["visual"]),
                              _count_blocks(params["text"]))
    name_map += vision_entries(params["visual"])
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
