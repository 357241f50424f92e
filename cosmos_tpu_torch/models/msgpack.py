"""A reader of flax's ``serialization.to_bytes`` files (``.msgpack`` /
``.flax`` parameter exports, ``cosmos_tpu/training/checkpoint.py``
``save_params_msgpack``), in plain Python: the card's machine has no
``msgpack`` package.

The format is MessagePack (https://github.com/msgpack/msgpack/blob/master/
spec.md): maps of string keys down to the leaves, a leaf an extension of
type 1 (an ndarray: a packed ``(shape, dtype name, C-order bytes)``), 3 (a
numpy scalar, packed the same way) or 2 (a complex, packed ``(real,
imag)``).  flax splits an array above 2**30 bytes into a map
``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``,
which ``read_msgpack`` joins again.  A ``bfloat16`` leaf, whose dtype numpy
does not know, is read as ``uint16`` and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


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
