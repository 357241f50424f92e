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

The third-party layouts (``detect_format``, ``convert_state_dict``: bare
timm trunks, big_vision SigLIP, Apple's MobileCLIP) follow at the end; ``models/checkpoint.py``
reads the files.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import is_coca

logger = logging.getLogger(__name__)

Entry = Tuple[str, Tuple[str, ...], Optional[str]]


def _block_entries(prefix_t: str, prefix_f: Tuple[str, ...],
                   i: int, stack: str = "resblocks") -> List[Entry]:
    """A residual block's entries; ``stack`` ``cross_attn`` names CoCa's
    decoder's cross-attention blocks, which add ``ln_1_kv``."""
    t = f"{prefix_t}.{stack}.{i}"
    f = prefix_f + (f"{stack}_{i}",)
    kv = [(f"{t}.ln_1_kv.{n}", f + ("ln_1_kv", m), None)
          for n, m in (("weight", "scale"), ("bias", "bias"))]
    return (kv if stack == "cross_attn" else []) + [
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


def _text_entries(prefix_t: str) -> List[Entry]:
    """The text tower's entries but its blocks: CLIP's at the top level
    (``prefix_t`` empty), CoCa's under ``text.``."""
    t = prefix_t
    return [
        (f"{t}token_embedding.weight",
         ("text", "token_embedding", "embedding"), None),
        (f"{t}positional_embedding", ("text", "positional_embedding"), None),
        (f"{t}ln_final.weight", ("text", "ln_final", "scale"), None),
        (f"{t}ln_final.bias", ("text", "ln_final", "bias"), None),
        (f"{t}text_projection", ("text", "text_projection_kernel"), None),
        # a text tower with proj_bias: an nn.Linear
        (f"{t}text_projection.weight", ("text", "text_projection", "kernel"),
         "t"),
        (f"{t}text_projection.bias", ("text", "text_projection", "bias"),
         None),
    ]


def _stack_entries(prefix_t: str, prefix_f: Tuple[str, ...],
                   layers: int) -> List[Entry]:
    return [e for i in range(layers)
            for e in _block_entries(prefix_t, prefix_f, i)]


def _vit_entries(layers: int) -> List[Entry]:
    """The native ViT's entries, SigLIP's parts with the JAX tree's paths
    with dots (``conv1.bias``, ``attn_pool.*``: JAX's own bridge has no
    names for them and drops them)."""
    pool = [("visual.attn_pool.probe", ("visual", "attn_pool", "probe"),
             None),
            ("visual.attn_pool.ln.weight",
             ("visual", "attn_pool", "ln", "scale"), None),
            ("visual.attn_pool.ln.bias",
             ("visual", "attn_pool", "ln", "bias"), None)]
    for n in ("q", "kv", "out", "c_fc", "c_proj"):
        pool += [(f"visual.attn_pool.{n}.weight",
                  ("visual", "attn_pool", n, "kernel"), "t"),
                 (f"visual.attn_pool.{n}.bias",
                  ("visual", "attn_pool", n, "bias"), None)]
    entries: List[Entry] = [
        ("visual.conv1.weight", ("visual", "conv1_kernel"), "conv"),
        ("visual.conv1.bias", ("visual", "conv1_bias"), None),
        ("visual.class_embedding", ("visual", "class_embedding"), None),
        ("visual.positional_embedding",
         ("visual", "positional_embedding"), None),
        ("visual.ln_pre.weight", ("visual", "ln_pre", "scale"), None),
        ("visual.ln_pre.bias", ("visual", "ln_pre", "bias"), None),
        ("visual.ln_post.weight", ("visual", "ln_post", "scale"), None),
        ("visual.ln_post.bias", ("visual", "ln_post", "bias"), None),
        ("visual.proj", ("visual", "proj"), None),
    ] + pool
    return entries + _stack_entries("visual.transformer",
                                    ("visual", "transformer"), layers)


def build_name_map(vision_layers: int, text_layers: int) -> List[Entry]:
    """(torch key, flax path, transform) for every parameter a native-ViT
    COSMOS CLIP may have; entries whose flax path is absent are skipped."""
    entries: List[Entry] = [
        ("logit_scale", ("logit_scale",), None),
        # SigLIP-initialised models (init_logit_bias); OpenCLIP's name
        ("logit_bias", ("logit_bias",), None),
    ]
    entries += _text_entries("")
    entries += _vit_entries(vision_layers)
    entries += _stack_entries("transformer", ("text", "transformer"),
                              text_layers)
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


def build_coca_name_map(vision_layers: int, text_layers: int,
                        decoder_layers: int) -> List[Entry]:
    """(torch key, flax path, transform) for every parameter of CoCa:
    OpenCLIP's CoCa names, and the JAX tree's paths with dots for the
    pooler (``attn_pool.*``, ``ln_attn_pool.*``).  The pooler's separate
    q/k/v weights, which a CoCa whose widths differ has, have no JAX
    counterpart (JAX's CoCa does not build there): their paths name what
    JAX's tree would call them, and the bridge skips them."""
    entries: List[Entry] = [("logit_scale", ("logit_scale",), None),
                            ("text.cls_emb", ("text", "cls_emb"), None)]
    entries += _text_entries("text.")
    entries += _stack_entries("text.transformer", ("text", "transformer"),
                              text_layers)
    entries += _vit_entries(vision_layers)
    entries += [("attn_pool.query", ("attn_pool", "query"), None)]
    entries += _cross_pool_entries("attn_pool", ("attn_pool",))
    entries += [(f"attn_pool.attn.{n}_proj_weight",
                 ("attn_pool", "attn", f"{n}_proj_kernel"), "t")
                for n in "qkv"]
    entries += [("ln_attn_pool.weight", ("ln_attn_pool", "scale"), None),
                ("ln_attn_pool.bias", ("ln_attn_pool", "bias"), None)]
    for i in range(decoder_layers):
        for stack in ("resblocks", "cross_attn"):
            entries += _block_entries("text_decoder", ("text_decoder",), i,
                                      stack)
    entries += [
        ("text_decoder.ln_final.weight",
         ("text_decoder", "ln_final", "scale"), None),
        ("text_decoder.ln_final.bias",
         ("text_decoder", "ln_final", "bias"), None),
        ("text_decoder.text_projection",
         ("text_decoder", "text_projection_kernel"), None),
    ]
    return entries


def model_name_map(model: torch.nn.Module) -> List[Entry]:
    """The name map of a native-ViT ``CLIP`` or of ``CoCa``, at the
    model's depths (a CLIP's other vision towers have 0 ViT layers)."""
    visual = getattr(model.visual, "transformer", None)
    v_layers = len(visual.resblocks) if visual is not None else 0
    if is_coca(model):
        return build_coca_name_map(v_layers,
                                   len(model.text.transformer.resblocks),
                                   len(model.text_decoder.resblocks))
    return build_name_map(v_layers, len(model.transformer.resblocks))


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


def _from_flax(value: torch.Tensor, tf: Optional[str]) -> torch.Tensor:
    if tf is None:
        return value
    if tf == "t":
        return value.t()
    if tf == "conv":  # HWIO -> OIHW
        return value.permute(3, 2, 0, 1)
    if tf == "cls":
        return value.reshape(1, 1, -1)
    if tf == "pos":
        return value[None]
    raise ValueError(tf)


def _tensor(value: Any) -> torch.Tensor:
    """A leaf as a CPU tensor of its own dtype (a tensor stays as it is, so
    that a bfloat16 leaf, which numpy lacks, passes)."""
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.array(np.asarray(value), order="C"))


def _count_blocks(tower: Dict[str, Any]) -> int:
    return len([k for k in tower.get("transformer", {})
                if k.startswith("resblocks")])


def state_dict_from_jax_params(params: Dict[str, Any]
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's CLIP or CoCa param tree (leaves as tensors, numpy
    arrays or anything ``np.asarray`` takes) as this package's state
    dict."""
    if "text_decoder" in params:
        name_map = build_coca_name_map(
            _count_blocks(params["visual"]), _count_blocks(params["text"]),
            len([k for k in params["text_decoder"]
                 if k.startswith("resblocks")]))
    else:
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
        out[tkey] = _from_flax(_tensor(node), tf).contiguous()
    return out


# --- third-party checkpoint formats ---------------------------------------
#
# Counterpart of ``cosmos_tpu/models/convert.py`` and ``convert_util.py``.
# Every converter returns tensors under this package's names, which are
# the source's own for the timm trunks (OpenCLIP's ``TimmModel`` keeps
# them under ``visual.trunk.``), so converting is mostly renaming and
# checking.  ``convert_state_dict`` returns the model's full state dict.

_MC_IMG = "image_encoder.model."
_MC_TXT = "text_encoder."


def np_(v: Any) -> np.ndarray:
    """A checkpoint value as a numpy array."""
    return np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)


def tensor_(v: Any) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else torch.from_numpy(
        np.array(np.asarray(v), order="C"))


def rename_(sd: Dict[str, Any], pairs) -> Dict[str, torch.Tensor]:
    """``{dst: sd[src]}`` for each ``(dst, src)``."""
    return {dst: tensor_(sd[src]) for dst, src in pairs}


def cvnets_block(sd: Dict[str, Any], b: str, dst: str
                 ) -> Dict[str, torch.Tensor]:
    """One CVNets/Apple TransformerEncoder block (``<b>.pre_norm_mha.{0,1}``,
    ``<b>.pre_norm_ffn.{0,1,4}``) under OpenCLIP's resblock names at
    ``dst``: shared by the MobileCLIP text tower and MobileCLIP-B's trunk
    (``timm_model.convert_mobileclip_vit``, whose ``dst`` names are timm's)."""
    timm = dst.startswith("blocks.")
    names = (("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1",
              "mlp.fc2") if timm else
             ("ln_1", "attn.in_proj_", "attn.out_proj", "ln_2", "mlp.c_fc",
              "mlp.c_proj"))
    ln1, qkv, out, ln2, fc1, fc2 = names
    sep = "." if timm else ""
    pairs = [
        (f"{dst}.{ln1}.weight", f"{b}.pre_norm_mha.0.weight"),
        (f"{dst}.{ln1}.bias", f"{b}.pre_norm_mha.0.bias"),
        (f"{dst}.{qkv}{sep}weight", f"{b}.pre_norm_mha.1.qkv_proj.weight"),
        (f"{dst}.{qkv}{sep}bias", f"{b}.pre_norm_mha.1.qkv_proj.bias"),
        (f"{dst}.{out}.weight", f"{b}.pre_norm_mha.1.out_proj.weight"),
        (f"{dst}.{out}.bias", f"{b}.pre_norm_mha.1.out_proj.bias"),
        (f"{dst}.{ln2}.weight", f"{b}.pre_norm_ffn.0.weight"),
        (f"{dst}.{ln2}.bias", f"{b}.pre_norm_ffn.0.bias"),
        (f"{dst}.{fc1}.weight", f"{b}.pre_norm_ffn.1.weight"),
        (f"{dst}.{fc1}.bias", f"{b}.pre_norm_ffn.1.bias"),
        (f"{dst}.{fc2}.weight", f"{b}.pre_norm_ffn.4.weight"),
        (f"{dst}.{fc2}.bias", f"{b}.pre_norm_ffn.4.bias"),
    ]
    return rename_(sd, pairs)


def detect_format(sd: Dict[str, Any]) -> str:
    """The layout of a state dict, by the JAX package's fingerprints."""
    keys = set(sd)
    if any(k.startswith("params/img") or k.startswith("img/") for k in keys):
        return "big_vision_siglip"
    if any(k.startswith("image_encoder.model") for k in keys):
        return "mobileclip"
    if "visual.conv1.weight" in keys or "module.visual.conv1.weight" in keys:
        return "open_clip"
    if "cls_token" in keys and "blocks.0.attn.q_proj.weight" in keys:
        return "timm_eva"
    if "cls_token" in keys and "blocks.0.attn.qkv.weight" in keys:
        return "timm_vit"
    if "stem.0.weight" in keys and "stages.0.blocks.0.conv_dw.weight" in keys:
        return "timm_convnext"
    return "unknown"


def _maybe_load_timm_head(sd: Dict[str, Any], out: Dict[str, torch.Tensor],
                          head_key: str = "head") -> None:
    """Load a timm checkpoint's classifier head into the linear projection
    head ``visual.head.proj`` when the shapes match (timm's ``*_clip_*``
    towers carry the CLIP projection there; an in1k head of 1000 classes
    and an MLP head are left alone).  Mutates ``out``."""
    w = sd.get(f"{head_key}.weight")
    if "visual.head.proj.weight" not in out or w is None:
        return
    w = tensor_(w)
    if tuple(w.shape) != tuple(out["visual.head.proj.weight"].shape):
        return
    out["visual.head.proj.weight"] = w
    b = sd.get(f"{head_key}.bias")
    if "visual.head.proj.bias" in out and b is not None:
        b = tensor_(b)
        if tuple(b.shape) == tuple(out["visual.head.proj.bias"].shape):
            out["visual.head.proj.bias"] = b
    logger.info("loaded timm classifier head as the CLIP projection "
                "(shape-matched %s)", tuple(w.shape))


def _replace_strict(target: Dict[str, torch.Tensor],
                    new: Dict[str, torch.Tensor], what: str,
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """``target`` with its keys under ``prefix`` replaced by ``new``: every
    such key must be filled, every converted tensor must have a slot of its
    shape."""
    unused = sorted(set(new) - set(target))
    if unused:
        raise ValueError(
            f"converted {what} tensors have no slot in the model: "
            f"{unused[:8]} — build the model from the matching config")
    out = dict(target)
    for key, ref in target.items():
        if not key.startswith(prefix):
            continue
        if key not in new:
            raise KeyError(f"converted checkpoint missing {key}")
        val = new[key]
        if tuple(val.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(val.shape)} vs {tuple(ref.shape)}")
        out[key] = val
    return out


_TRUNK_NEEDED = {
    "timm_vit": ("timm ViT", "vit_base_patch16_224"),
    "timm_eva": ("timm EVA02", "eva02_base_patch14_224"),
}


def convert_state_dict(model: torch.nn.Module, sd: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """Format dispatch: ``sd`` in any layout ``detect_format`` knows as the
    full state dict of ``model`` (the JAX package's ``convert_state_dict``)."""
    from .checkpoint import torch_state_dict_to_model

    fmt = detect_format(sd)
    if fmt == "open_clip":
        return torch_state_dict_to_model(model, sd)
    if fmt == "big_vision_siglip":
        return convert_big_vision_siglip(model, sd)
    if fmt in ("timm_vit", "timm_eva", "timm_convnext"):
        if not hasattr(getattr(model, "visual", None), "trunk"):
            if fmt == "timm_convnext":
                raise ValueError(
                    "bare timm ConvNeXt checkpoint needs a timm vision "
                    "tower: build the model with vision_cfg timm_model_name "
                    "(e.g. create_model('convnext_base_w'))")
            what, example = _TRUNK_NEEDED[fmt]
            raise ValueError(
                f"bare {what} checkpoint needs a timm vision tower: "
                "build the model with vision_cfg timm_model_name "
                f"(e.g. create_model(..., vision_timm_model_name="
                f"'{example}'))")
        if fmt == "timm_vit":
            from .timm_model import convert_timm_vit, infer_timm_vit_name
            trunk = convert_timm_vit(sd, infer_timm_vit_name(sd))
        elif fmt == "timm_eva":
            from .eva import convert_timm_eva, infer_timm_eva_name
            trunk = convert_timm_eva(sd, infer_timm_eva_name(sd))
        else:
            from .convnext import (convert_timm_convnext,
                                   infer_timm_convnext_name)
            trunk = convert_timm_convnext(sd, infer_timm_convnext_name(sd))
        out = _replace_strict(
            model.state_dict(),
            {f"visual.trunk.{k}": v for k, v in trunk.items()},
            fmt.replace("_", " "), prefix="visual.trunk.")
        _maybe_load_timm_head(sd, out, "head.fc" if fmt == "timm_convnext"
                              else "head")
        return out
    if fmt == "mobileclip":
        return convert_mobileclip(model, sd)
    raise ValueError(f"unrecognized checkpoint format (keys: {list(sd)[:5]})")


# --- big_vision SigLIP (.npz) ----------------------------------------------
#
# The big_vision layout goes into the JAX package's parameter tree, as its
# ``convert_big_vision_siglip`` builds it, then through the bridge's names.
# The model must be SigLIP-shaped: a no-CLS ViT with a biased patch
# embedding, the MAP head and no projection; a text tower without a causal
# mask, 'last' pooling and a biased projection; a logit bias.


def _bv(sd: Dict[str, Any], key: str) -> np.ndarray:
    for prefix in ("params/", ""):
        if prefix + key in sd:
            return np_(sd[prefix + key])
    raise KeyError(key)


def _bv_ln(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"scale": _bv(sd, f"{prefix}/scale"),
            "bias": _bv(sd, f"{prefix}/bias")}


def _bv_attention(sd: Dict[str, Any], att: str
                  ) -> Dict[str, np.ndarray]:
    """A MultiHeadDotProductAttention's q, k, v and out as [in, out]
    kernels and flat biases."""
    d = _bv(sd, f"{att}/query/kernel").shape[0]
    out = {}
    for n in ("query", "key", "value"):
        out[n] = (_bv(sd, f"{att}/{n}/kernel").reshape(d, -1),
                  _bv(sd, f"{att}/{n}/bias").reshape(-1))
    out["out"] = (_bv(sd, f"{att}/out/kernel").reshape(-1, d),
                  _bv(sd, f"{att}/out/bias"))
    return out


def _bv_dense(sd: Dict[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {"kernel": _bv(sd, f"{prefix}/kernel"),
            "bias": _bv(sd, f"{prefix}/bias")}


def _bv_block(sd: Dict[str, Any], p: str) -> Dict[str, Any]:
    """One big_vision encoderblock in the JAX tree's resblock layout."""
    att = _bv_attention(sd, f"{p}/MultiHeadDotProductAttention_0")
    qkv = [att[n] for n in ("query", "key", "value")]
    return {
        "ln_1": _bv_ln(sd, f"{p}/LayerNorm_0"),
        "ln_2": _bv_ln(sd, f"{p}/LayerNorm_1"),
        "attn": {
            "in_proj_kernel": np.concatenate([k for k, _ in qkv], axis=1),
            "in_proj_bias": np.concatenate([b for _, b in qkv]),
            "out_proj": dict(zip(("kernel", "bias"), att["out"])),
        },
        "mlp": {"c_fc": _bv_dense(sd, f"{p}/MlpBlock_0/Dense_0"),
                "c_proj": _bv_dense(sd, f"{p}/MlpBlock_0/Dense_1")},
    }


def _bv_blocks(sd: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    blocks = {}
    i = 0
    while (f"params/{prefix}/encoderblock_{i}/LayerNorm_0/scale" in sd
           or f"{prefix}/encoderblock_{i}/LayerNorm_0/scale" in sd):
        blocks[f"resblocks_{i}"] = _bv_block(sd, f"{prefix}/encoderblock_{i}")
        i += 1
    return blocks


def convert_big_vision_siglip(model: torch.nn.Module, sd: Dict[str, Any]
                              ) -> Dict[str, torch.Tensor]:
    """A big_vision SigLIP checkpoint (``params/img/...``, ``params/txt/...``,
    ``t``, ``b``; with or without the ``params/`` prefix) as the full
    float32 state dict of ``model``.  Parameters the checkpoint lacks keep
    the model's values; a converted tensor the model has no slot for, or a
    slot of another shape, raises."""
    mp = "img/MAPHead_0"
    att = _bv_attention(sd, f"{mp}/MultiHeadDotProductAttention_0")
    pe = _bv(sd, "img/pos_embedding")
    visual = {
        "conv1_kernel": _bv(sd, "img/embedding/kernel"),      # HWIO
        "conv1_bias": _bv(sd, "img/embedding/bias"),
        "positional_embedding": pe.reshape(-1, pe.shape[-1]),  # no CLS row
        "transformer": _bv_blocks(sd, "img/Transformer"),
        "ln_post": _bv_ln(sd, "img/Transformer/encoder_norm"),
        "attn_pool": {
            "probe": _bv(sd, f"{mp}/probe"),
            "q": dict(zip(("kernel", "bias"), att["query"])),
            "kv": {"kernel": np.concatenate([att["key"][0], att["value"][0]],
                                            axis=1),
                   "bias": np.concatenate([att["key"][1], att["value"][1]])},
            "out": dict(zip(("kernel", "bias"), att["out"])),
            "ln": _bv_ln(sd, f"{mp}/LayerNorm_0"),
            "c_fc": _bv_dense(sd, f"{mp}/MlpBlock_0/Dense_0"),
            "c_proj": _bv_dense(sd, f"{mp}/MlpBlock_0/Dense_1"),
        },
    }
    tpe = _bv(sd, "txt/pos_embedding")
    text = {
        "token_embedding": {"embedding": _bv(sd, "txt/Embed_0/embedding")},
        "positional_embedding": tpe.reshape(-1, tpe.shape[-1]),
        "transformer": _bv_blocks(sd, "txt/Encoder_0"),
        "ln_final": _bv_ln(sd, "txt/Encoder_0/encoder_norm"),
        "text_projection": _bv_dense(sd, "txt/head"),
    }
    tree = {"visual": visual, "text": text,
            "logit_scale": _bv(sd, "t").reshape(()),
            "logit_bias": _bv(sd, "b").reshape(())}
    new = state_dict_from_jax_params(tree)
    target = model.state_dict()
    unused = sorted(set(new) - set(target))
    if unused:
        raise ValueError(
            f"converted SigLIP tensors have no slot in the target model: "
            f"{unused[:8]} — build the model with the SigLIP vision/text "
            "config (pool_type='map', class_token=False, patch_bias=True, "
            "init_logit_bias)")
    out = dict(target)
    for key, value in new.items():
        if tuple(value.shape) != tuple(target[key].shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(value.shape)} "
                             f"vs {tuple(target[key].shape)}")
        out[key] = value.float()
    logger.info("converted SigLIP npz: %d vision + %d text blocks",
                len(visual["transformer"]), len(text["transformer"]))
    return out


# --- MobileCLIP (Apple ml-mobileclip checkpoints) -------------------------
#
# The image trunk goes through the fusing converter (``fastvit.py``: the
# train-form branches folded into the deploy convs) or, for B, the hybrid
# ViT's (``timm_model.convert_mobileclip_vit``); the text tower maps key
# for key onto the CLIP text tower.  MobileCLIP-S0's convolutional text
# tower is refused, as the JAX package refuses it.


def _convert_mobileclip_text(sd: Dict[str, Any], n_layers: int
                             ) -> Dict[str, torch.Tensor]:
    p = _MC_TXT
    pe_key = f"{p}positional_embedding.pos_embed.pos_embed"
    if pe_key not in sd:
        raise NotImplementedError(
            "MobileCLIP text tower is not the base transformer layout "
            "(MobileCLIP-S0's MCt convolutional text tower?) — "
            "unsupported, matching the reference (convert.py:184)"
        )
    emb = tensor_(sd[f"{p}embedding_layer.weight"])
    out = {
        "token_embedding.weight": emb,
        "positional_embedding": tensor_(sd[pe_key]).reshape(-1, emb.shape[1]),
        **rename_(sd, [("ln_final.weight", f"{p}final_layer_norm.weight"),
                       ("ln_final.bias", f"{p}final_layer_norm.bias")]),
    }
    for i in range(n_layers):
        out.update(cvnets_block(sd, f"{p}transformer.{i}",
                                f"transformer.resblocks.{i}"))
    # a bare [width, embed] matrix, or an nn.Linear with or without bias
    if f"{p}projection_layer" in sd:
        out["text_projection"] = tensor_(sd[f"{p}projection_layer"])
    elif f"{p}projection_layer.weight" in sd:
        w = tensor_(sd[f"{p}projection_layer.weight"])
        if f"{p}projection_layer.bias" in sd:
            out["text_projection.weight"] = w
            out["text_projection.bias"] = tensor_(
                sd[f"{p}projection_layer.bias"])
        else:
            out["text_projection"] = w.t().contiguous()
    else:
        raise KeyError("MobileCLIP text projection not found "
                       "(text_encoder.projection_layer)")
    return out


def _mc_image_head(sd: Dict[str, Any], target: Tuple[int, ...]
                   ) -> Dict[str, torch.Tensor]:
    """Apple's image projection as ``visual.head.proj``: S1/S2 keep a bare
    ``[in, out]`` matrix at ``head.proj``, B a Linear-oriented
    ``classifier.proj``/``classifier.weight``.  A bare matrix is oriented
    by the head's shape; a square one by the key's convention.  ``target``
    is the head's ``[in, out]``."""
    for base, transpose_default in (("head.proj", False),
                                    ("classifier.proj", True),
                                    ("head.weight", True),
                                    ("classifier.weight", True)):
        key = f"{_MC_IMG}{base}"
        if key not in sd:
            continue
        kern = tensor_(sd[key])                      # [in, out] form
        if tuple(kern.shape) != target and tuple(kern.shape[::-1]) == target:
            kern = kern.t()
        elif (tuple(kern.shape) == target == target[::-1]
              and transpose_default):
            kern = kern.t()
        head = {"visual.head.proj.weight": kern.t().contiguous()}
        bias = f"{key.rsplit('.', 1)[0]}.bias"
        if bias in sd:
            head["visual.head.proj.bias"] = tensor_(sd[bias])
        return head
    raise KeyError("MobileCLIP image projection not found "
                   "(image_encoder.model.{head,classifier}.*)")


def convert_mobileclip(model: torch.nn.Module, sd: Dict[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """An Apple MobileCLIP checkpoint (S1/S2 FastViT/MCi trunks, B's hybrid
    ViT) as the full state dict of ``model``."""
    from .fastvit import convert_mobileclip_image, infer_fastvit_name
    from .timm_model import convert_mobileclip_vit, infer_mci_vit_name

    visual = getattr(model, "visual", None)
    if not hasattr(visual, "trunk"):
        raise ValueError(
            "MobileCLIP checkpoint needs a timm-adapter vision tower: "
            "build the model from the MobileCLIP-S1/S2/B config "
            "(create_model('MobileCLIP-B'))")
    target = model.state_dict()
    if f"{_MC_IMG}patch_emb.0.block.conv.weight" in sd:
        if "visual.trunk.stem0.weight" not in target:
            raise ValueError(
                "MobileCLIP-B checkpoint needs the hybrid-ViT vision "
                "tower: build the model from the MobileCLIP-B config "
                "(create_model('MobileCLIP-B'))")
        name = infer_mci_vit_name(sd, _MC_IMG)
        trunk = convert_mobileclip_vit(sd, name, _MC_IMG)
    else:
        if f"{_MC_IMG}patch_embed.0.rbr_conv.0.conv.weight" not in sd:
            raise ValueError(
                "unrecognized MobileCLIP image tower layout (expected "
                "image_encoder.model.patch_embed.0.rbr_conv.* FastViT keys "
                "or patch_emb.0.block.conv.* hybrid-ViT keys)")
        name = infer_fastvit_name(sd, _MC_IMG)
        trunk = convert_mobileclip_image(sd, name, _MC_IMG)
    new = {f"visual.trunk.{k}": v for k, v in trunk.items()}
    if "visual.head.proj.weight" not in target:
        raise ValueError(
            "converted MobileCLIP tensors have no slot at visual.head — "
            "model config must be the MobileCLIP shape (timm fastvit_mci* "
            "trunk, 'avg' pool, bias-free 'linear' proj)")
    new.update(_mc_image_head(
        sd, tuple(target["visual.head.proj.weight"].shape[::-1])))
    n_txt = len(model.transformer.resblocks)
    new.update(_convert_mobileclip_text(sd, n_txt))
    new["logit_scale"] = tensor_(sd["logit_scale"]).reshape(())
    out = _replace_strict(target, new, "MobileCLIP")
    logger.info("converted MobileCLIP checkpoint: %s trunk (fused to "
                "deploy form) + %d text blocks", name, n_txt)
    return out
