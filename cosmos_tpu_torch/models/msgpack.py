"""A reader and a writer of flax's ``serialization.to_bytes`` files
(``.msgpack`` / ``.flax`` parameter exports, ``cosmos_tpu/training/
checkpoint.py`` ``save_params_msgpack``), in plain Python: the card's
machine has no ``msgpack`` package.

The format is MessagePack (https://github.com/msgpack/msgpack/blob/master/
spec.md): maps of string keys down to the leaves, a leaf an extension of
type 1 (an ndarray: a packed ``(shape, dtype name, C-order bytes)``), 3 (a
numpy scalar, packed the same way) or 2 (a complex, packed ``(real,
imag)``).  flax splits an array above 2**30 bytes into a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
which ``read_msgpack`` joins again and ``write_msgpack`` writes so.
transformers shards a large model over several such files, each a map of
``a/b/c`` paths to leaves, listed by the ``weight_map`` of an index
(``read_msgpack_index``).  A
``bfloat16`` leaf, whose dtype numpy does not know, is read as ``uint16``
and viewed as ``torch.bfloat16``, and written so.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
# flax's MAX_CHUNK_SIZE: arrays of more bytes are written in chunks
MAX_CHUNK_SIZE = 2 ** 30


class _Ext:
    __slots__ = ("code", "data")

    def __init__(self, code: int, data: bytes):
        self.code, self.data = code, data


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    """One MessagePack object at ``pos``: (value, next position)."""
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b >= 0xE0:
        return b - 0x100, pos
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in (0xC4, 0xC5, 0xC6):                      # bin 8/16/32
        n, pos = _uint(buf, pos, 1 << (b - 0xC4))
        return bytes(buf[pos:pos + n]), pos + n
    if b in (0xC7, 0xC8, 0xC9):                      # ext 8/16/32
        n, pos = _uint(buf, pos, 1 << (b - 0xC7))
        code = struct.unpack_from(">b", buf, pos)[0]
        return _Ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b == 0xCA:
        return struct.unpack_from(">f", buf, pos)[0], pos + 4
    if b == 0xCB:
        return struct.unpack_from(">d", buf, pos)[0], pos + 8
    if 0xCC <= b <= 0xCF:                            # uint 8..64
        return _uint(buf, pos, 1 << (b - 0xCC))
    if 0xD0 <= b <= 0xD3:                            # int 8..64
        size = 1 << (b - 0xD0)
        fmt = {1: ">b", 2: ">h", 4: ">i", 8: ">q"}[size]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if 0xD4 <= b <= 0xD8:                            # fixext 1..16
        n = 1 << (b - 0xD4)
        code = struct.unpack_from(">b", buf, pos)[0]
        return _Ext(code, bytes(buf[pos + 1:pos + 1 + n])), pos + 1 + n
    if b in (0xD9, 0xDA, 0xDB):                      # str 8/16/32
        n, pos = _uint(buf, pos, 1 << (b - 0xD9))
        return bytes(buf[pos:pos + n]).decode(), pos + n
    if b in (0xDC, 0xDD):                            # array 16/32
        n, pos = _uint(buf, pos, 2 if b == 0xDC else 4)
        return _array(buf, pos, n)
    if b in (0xDE, 0xDF):                            # map 16/32
        n, pos = _uint(buf, pos, 2 if b == 0xDE else 4)
        return _map(buf, pos, n)
    raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at {pos - 1}")


def _uint(buf: bytes, pos: int, size: int) -> Tuple[int, int]:
    return int.from_bytes(buf[pos:pos + size], "big"), pos + size


def _array(buf: bytes, pos: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf: bytes, pos: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def unpackb(buf: bytes) -> Any:
    """One MessagePack document; extensions come back as ``_Ext``."""
    value, pos = _unpack(memoryview(buf), 0)
    if pos != len(buf):
        raise ValueError(f"msgpack: {len(buf) - pos} trailing bytes")
    return value


def _ndarray(data: bytes) -> torch.Tensor:
    shape, dtype, raw = unpackb(data)
    if isinstance(dtype, bytes):
        dtype = dtype.decode()
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, np.uint16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    arr = np.frombuffer(raw, np.dtype(dtype)).reshape(shape)
    return torch.from_numpy(arr.copy())


def _leaf(value: Any) -> Any:
    if isinstance(value, _Ext):
        if value.code == _EXT_NDARRAY:
            return _ndarray(value.data)
        if value.code == _EXT_NPSCALAR:
            return _ndarray(value.data).reshape(())
        if value.code == _EXT_COMPLEX:
            re_, im = unpackb(value.data)
            return complex(re_, im)
        raise ValueError(f"msgpack: unknown extension type {value.code}")
    if isinstance(value, dict):
        if value.get("__msgpack_chunked_array__"):
            shape = [value["shape"][str(i)] for i in range(len(value["shape"]))]
            chunks = [_leaf(value["chunks"][str(i)])
                      for i in range(len(value["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _leaf(v) for k, v in value.items()}
    return value


def read_msgpack(path: str) -> Dict[str, Any]:
    """A flax ``to_bytes`` file as a nested dict of tensors."""
    with open(path, "rb") as f:
        return _leaf(unpackb(f.read()))


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """``{"a/b/c": leaf}`` as the nested ``{"a": {"b": {"c": leaf}}}``."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        *parents, leaf = key.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def read_msgpack_index(path: str) -> Dict[str, Any]:
    """A sharded flax checkpoint (``flax_model.msgpack.index.json``): every
    shard its ``weight_map`` names, read and joined into one nested tree,
    as transformers' ``load_flax_sharded_weights`` joins them."""
    with open(path) as f:
        shards = sorted(set(json.load(f)["weight_map"].values()))
    flat: Dict[str, Any] = {}
    for shard in shards:
        flat.update(_flatten(read_msgpack(os.path.join(os.path.dirname(path),
                                                       shard))))
    return _unflatten(flat)


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int,
              codes: Tuple[int, ...]) -> None:
    """A length header: the fixed form below ``fix_max``, else the first
    of ``codes`` (8/16/32-bit or 16/32-bit lengths) that holds ``n``."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    sizes = (1, 2, 4) if len(codes) == 3 else (2, 4)
    for code, size in zip(codes, sizes):
        if n < 1 << (8 * size):
            out.append(code)
            out += n.to_bytes(size, "big")
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            size = next(s for s in (1, 2, 4, 8) if obj < 1 << (8 * s))
            out.append(0xCC + (1, 2, 4, 8).index(size))
            out += obj.to_bytes(size, "big")
        else:
            size = next(s for s in (1, 2, 4, 8) if obj >= -(1 << (8 * s - 1)))
            out.append(0xD0 + (1, 2, 4, 8).index(size))
            out += obj.to_bytes(size, "big", signed=True)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode()
        _pack_len(out, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(out, len(data), None, -1, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, _Ext):
        n = len(obj.data)
        if n in (1, 2, 4, 8, 16):
            out.append(0xD4 + (1, 2, 4, 8, 16).index(n))
        else:
            _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
        out += struct.pack(">b", obj.code)
        out += obj.data
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """One MessagePack document (``_Ext`` values as extensions)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _ndarray_ext(t: torch.Tensor) -> _Ext:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes()
    else:
        arr = t.numpy()
        name, raw = arr.dtype.name, arr.tobytes()
    return _Ext(_EXT_NDARRAY, packb((list(t.shape), name, raw)))


def _write_leaf(value: Any) -> Any:
    if isinstance(value, dict):
        return {str(k): _write_leaf(v) for k, v in value.items()}
    t = torch.as_tensor(value)
    if t.numel() * t.element_size() > MAX_CHUNK_SIZE:
        step = max(1, MAX_CHUNK_SIZE // t.element_size())
        flat = t.reshape(-1)
        chunks = [flat[i:i + step] for i in range(0, flat.numel(), step)]
        return {"__msgpack_chunked_array__": True,
                "shape": {str(i): n for i, n in enumerate(t.shape)},
                "chunks": {str(i): _ndarray_ext(c)
                           for i, c in enumerate(chunks)}}
    return _ndarray_ext(t)


def write_msgpack(tree: Dict[str, Any], path: str) -> None:
    """A nested dict of tensors (or arrays) as a flax ``to_bytes`` file,
    which flax's ``from_bytes`` and ``read_msgpack`` read back."""
    with open(path, "wb") as f:
        f.write(packb(_write_leaf(tree)))
