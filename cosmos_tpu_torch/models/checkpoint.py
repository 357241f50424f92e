"""Checkpoint files into a model (counterpart of
``cosmos_tpu/models/checkpoint.py:199-402``).

``read_checkpoint`` reads a file as a state dict; ``load_checkpoint`` loads
one into a ``CLIP`` in place.  The files it reads:

- a reference-format ``.pt``: a bare state dict, a training checkpoint
  ``{"student": ..., "teacher": ..., ...}`` (``which`` picks one) or
  ``{"state_dict": ...}``, read with ``torch.load(weights_only=True)``;
- a TorchScript archive (OpenAI's releases), read with ``torch.jit.load``;
  its ``state_dict()`` has the reference names;
- a flax ``.msgpack``/``.flax`` parameter file (``models/msgpack.py``),
  through the bridge's names (``convert.state_dict_from_jax_params``),
  loaded with every key required, as flax's ``from_bytes`` requires them;
- a third-party layout (bare timm trunks, Apple's MobileCLIP), found by
  ``convert.detect_format`` and converted by ``convert.convert_state_dict``.

A pickled ``nn.Module`` is refused: the JAX package reads with
``weights_only=False``, which runs the file's pickled code.
``read_safetensors`` reads a ``.safetensors`` file (an HF text tower's
``model.safetensors``, ``hf_model.load_hf_pretrained``).

A reference state dict loads as ``torch_state_dict_to_params`` loads it:
``module.`` is stripped, ``attn_mask`` dropped, the CustomTextCLIP ``text.``
prefix normalised, the two forms of ``text_projection`` (a bare matrix or
an ``nn.Linear``) accepted, an absent ``distill_logit_scale`` skipped,
leaves that differ only in rank reshaped, the vision position table resized
bicubically and the text table linearly, and each other missing key warned
about and kept at its initial value unless ``strict``.  Any other shape
mismatch raises.  Keys outside the JAX name map (a timm-family trunk, the
layer scales, ``logit_bias``) load by name, where the JAX package keeps
their initial values or cannot read the file.
"""

from __future__ import annotations

import json
import logging
import math
import pickle
import re
import zipfile
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .vit import interpolate_pos_embed

logger = logging.getLogger(__name__)

MSGPACK_SUFFIXES = (".msgpack", ".flax")

# the text projection's other form: a checkpoint carries one, the model
# has one, and a mismatch keeps the model's initial value silently
_ALT_FORMS = {
    "text_projection": "text_projection.weight",
    "text_projection.weight": "text_projection",
    "text_projection.bias": "text_projection",
}


def resize_pos_embed(pe: torch.Tensor, target_len: int) -> torch.Tensor:
    """Bicubic-resize a ``[1+N, D]`` vision position table to
    ``[target_len, D]`` (``F.interpolate``, ``align_corners=False``)."""
    if pe.shape[0] == target_len:
        return pe
    src = int(round(math.sqrt(pe.shape[0] - 1)))
    dst = int(round(math.sqrt(target_len - 1)))
    return interpolate_pos_embed(pe, (src, src), (dst, dst))


def resize_text_pos_embed(pe: torch.Tensor, target_len: int) -> torch.Tensor:
    """Linear-resize an ``[L, D]`` text position table to ``target_len``
    rows with ``align_corners=False`` semantics: row i reads source
    position ``(i + 0.5) * L / target_len - 0.5``, clamped to the table."""
    src = pe.shape[0]
    if src == target_len:
        return pe
    x = (torch.arange(target_len, dtype=torch.float64) + 0.5) * (
        src / target_len) - 0.5
    x = x.clamp(0.0, src - 1.0)
    i0 = x.floor().long()
    i1 = (i0 + 1).clamp(max=src - 1)
    w = (x - i0)[:, None].to(pe.dtype)
    return pe[i0] * (1 - w) + pe[i1] * w


def _is_torchscript(path: str) -> bool:
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as z:
        return any(n.split("/", 1)[-1] == "constants.pkl"
                   for n in z.namelist())


def _torch_load(path: str) -> Any:
    if _is_torchscript(path):
        return torch.jit.load(path, map_location="cpu").state_dict()
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        raise ValueError(
            f"{path}: not a plain checkpoint of tensors and containers (a "
            "pickled nn.Module or other object?); objects are refused, "
            "since loading them runs the file's code: save "
            "model.state_dict() instead") from e


def read_checkpoint(path: str, which: str = "student"
                    ) -> Dict[str, torch.Tensor]:
    """A checkpoint file as a state dict: a ``.msgpack``/``.flax`` file
    through the bridge's names; a ``.npz`` as its arrays; a ``.pt`` as its
    ``which`` entry, its ``state_dict`` entry or itself.  ``module.`` is
    stripped and ``attn_mask`` dropped; other names are the file's."""
    if path.endswith(MSGPACK_SUFFIXES):
        from .convert import state_dict_from_jax_params
        from .msgpack import read_msgpack

        return state_dict_from_jax_params(read_msgpack(path))
    if path.endswith(".npz"):
        with np.load(path) as npz:
            return {k: torch.from_numpy(npz[k]) for k in npz.files}
    ckpt = _torch_load(path)
    if isinstance(ckpt, dict) and which in ckpt:
        sd = ckpt[which]
    elif isinstance(ckpt, dict) and "state_dict" in ckpt:
        sd = ckpt["state_dict"]
    else:
        sd = ckpt
    return _strip(sd)


# the dtype names of the safetensors format
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool}


def read_safetensors(path: str):
    """A ``.safetensors`` file (an 8-byte little-endian header length, a
    JSON header of each tensor's dtype, shape and byte range, the bytes):
    ``({name: tensor}, the header's ``__metadata__`` or None)``, with no
    ``safetensors`` package."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        data = f.read()
    metadata = header.pop("__metadata__", None)
    out = {}
    for name, info in header.items():
        start, end = info["data_offsets"]
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        if end == start:
            out[name] = torch.empty(info["shape"], dtype=dtype)
            continue
        raw = torch.frombuffer(bytearray(data[start:end]), dtype=torch.uint8)
        out[name] = raw.view(dtype).reshape(info["shape"])
    return out, metadata


def _strip(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Without DistributedDataParallel's ``module.`` and the non-parameter
    ``attn_mask`` buffers."""
    return {re.sub(r"^module\.", "", k): v for k, v in sd.items()
            if not k.endswith("attn_mask")}


def normalize_state_dict(sd: Dict[str, Any], text_tower: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """``_strip``, and a CustomTextCLIP text tower
    (``text.transformer.resblocks.*``) moved to the top level, unless the
    model keeps its text tower under ``text.`` (``text_tower``: CoCa)."""
    sd = {k: torch.as_tensor(v) for k, v in _strip(sd).items()}
    if not text_tower and any(k.startswith("text.transformer.resblocks.")
                              for k in sd):
        sd = {(k[len("text."):] if k.startswith("text.") else k): v
              for k, v in sd.items()}
    return sd


def torch_state_dict_to_model(model: nn.Module, state_dict: Dict[str, Any],
                              strict: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """A reference state dict as the full state dict of ``model``: every
    key of the model, from the checkpoint where it has one (resized or
    reshaped as the module docstring says), else the model's own value."""
    target = model.state_dict()
    sd = normalize_state_dict(state_dict, text_tower=any(
        k.startswith("text.") for k in target))
    native_vit = hasattr(getattr(model, "visual", None), "class_embedding")
    out: Dict[str, torch.Tensor] = {}
    for key, ref in target.items():
        if key not in sd:
            out[key] = ref
            if key == "distill_logit_scale":
                continue  # a plain CLIP checkpoint in a COSMOS model
            if _ALT_FORMS.get(key) in sd:
                continue
            msg = f"missing torch key {key}"
            if strict:
                raise KeyError(msg)
            logger.warning(msg)
            continue
        val = sd[key]
        if key == "visual.positional_embedding" and native_vit:
            val = resize_pos_embed(val, ref.shape[0])
        elif key == "positional_embedding":
            val = resize_text_pos_embed(val, ref.shape[0])
        if val.shape != ref.shape:
            if val.numel() != ref.numel():
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint "
                    f"{tuple(val.shape)}, model {tuple(ref.shape)}")
            val = val.reshape(ref.shape)
        out[key] = val.to(ref.dtype)
    extra = sorted(set(sd) - set(target))
    if extra:
        logger.info(f"unused torch keys: {extra[:8]}"
                    f"{'...' if len(extra) > 8 else ''}")
    return out


def load_checkpoint(model: nn.Module, path: str, *, which: str = "student",
                    strict: bool = False) -> nn.Module:
    """Load the checkpoint at ``path`` into ``model`` in place and return
    it (the JAX package returns a new parameter tree).  ``which`` picks
    the student or the teacher of a training checkpoint; ``strict`` makes
    a key the model has and the file lacks an error."""
    from .convert import convert_state_dict, detect_format

    sd = read_checkpoint(path, which)
    if path.endswith(MSGPACK_SUFFIXES):
        strict = True
    if detect_format(sd) not in ("open_clip", "unknown"):
        new = convert_state_dict(model, sd)
    else:
        new = torch_state_dict_to_model(model, sd, strict=strict)
    with torch.no_grad():
        model.load_state_dict(new, strict=True)
    return model
