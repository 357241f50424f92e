"""ctypes bindings of the port's native data path, ``csrc/tario.cpp``
(counterpart of ``cosmos_tpu/data/native.py``): a threaded tar shard
streamer and libjpeg decode with DCT-domain scaling.

``load()`` compiles ``tario.cpp`` with ``g++`` at first use into
``build/cosmos_tpu_torch/`` at the root of the checkout, under a file lock,
landing the library by atomic rename; the name hashes the source, the
headers, the flags (the libjpeg library among them) and the compiler's
version, so an unchanged build is loaded as it is.  It compiles against the
libjpeg 6.2 headers in ``csrc/jpeg/`` (libjpeg-turbo's, with their
license) and links by path against a ``libjpeg.so.62``: the system's, or
else the one Pillow bundles (with an rpath to it).  Where no library can be
built, ``load()`` raises, naming what it lacked: nothing falls back to PIL
without a word.

This module imports neither torch nor anything that does: the loader's
worker processes load it.
"""

from __future__ import annotations

import ctypes
import fcntl
import glob
import hashlib
import importlib.util
import io
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "tario.cpp"
JPEG_INCLUDE = CSRC / "jpeg"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cosmos_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# where a system libjpeg-turbo 6.2 library lives on the usual layouts
_SYSTEM_LIB_GLOBS = ("/usr/lib/x86_64-linux-gnu/libjpeg.so.62*",
                     "/usr/lib64/libjpeg.so.62*", "/usr/lib/libjpeg.so.62*",
                     "/usr/local/lib/libjpeg.so.62*")

# (compiler, build directory) -> the loaded library: a process builds and
# loads once, and a decode costs no compiler query
_loaded: Dict[Tuple[str, str], ctypes.CDLL] = {}


def find_libjpeg() -> str:
    """The path of a libjpeg 6.2 shared library: the system's, else the one
    Pillow's wheel bundles (``pillow.libs/libjpeg-*.so.62*``)."""
    for pattern in _SYSTEM_LIB_GLOBS:
        found = sorted(glob.glob(pattern))
        if found:
            return found[0]
    spec = importlib.util.find_spec("PIL")
    if spec is not None and spec.origin:
        libs = Path(spec.origin).resolve().parents[1] / "pillow.libs"
        found = sorted(glob.glob(str(libs / "libjpeg*.so.62*")))
        if found:
            return found[0]
    raise RuntimeError(
        "no libjpeg 6.2 library found (looked for libjpeg.so.62 under "
        f"{', '.join(p.rsplit('/', 1)[0] for p in _SYSTEM_LIB_GLOBS)} and in "
        "Pillow's pillow.libs); the native data path links against one")


def _compiler_version(compiler: str) -> str:
    try:
        proc = subprocess.run([compiler, "--version"], capture_output=True,
                              text=True)
    except OSError as e:
        raise RuntimeError(
            f"C++ compiler {compiler!r} not found ({e.strerror}); the native "
            "data path (cosmos_tpu_torch/data/csrc/tario.cpp) is compiled "
            "from source at first use") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} --version failed: {proc.stderr}")
    return proc.stdout.splitlines()[0] if proc.stdout else ""


def _build_command(compiler: str, libjpeg: str, out: str) -> List[str]:
    return [compiler, *CXX_FLAGS, f"-I{JPEG_INCLUDE}", str(SOURCE), "-o", out,
            libjpeg, f"-Wl,-rpath,{Path(libjpeg).parent}", "-lpthread"]


def library_path(compiler: str = "g++", build_dir: Path = BUILD_DIR) -> Path:
    """Where the build for this source, these headers, flags, libjpeg and
    compiler lives (built or not)."""
    libjpeg = find_libjpeg()
    digest = hashlib.sha256()
    digest.update(SOURCE.read_bytes())
    for h in sorted(JPEG_INCLUDE.glob("*.h")):
        digest.update(h.read_bytes())
    digest.update(" ".join(_build_command(compiler, libjpeg, "")).encode())
    digest.update(_compiler_version(compiler).encode())
    return Path(build_dir) / f"libtario-{digest.hexdigest()[:16]}.so"


def _build(compiler: str, lib_path: Path) -> None:
    """Compile into ``lib_path`` under an exclusive file lock, by way of a
    temporary file renamed into place: a concurrent process waits, then
    finds the library whole."""
    lib_path.parent.mkdir(parents=True, exist_ok=True)
    with open(lib_path.parent / ".libtario.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib_path.exists():
            return
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib_path.parent)
        os.close(fd)
        try:
            cmd = _build_command(compiler, find_libjpeg(), tmp)
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{compiler} failed ({proc.returncode}) building the "
                    f"native data path:\n{' '.join(cmd)}\n{proc.stderr}")
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    lib.tario_decode_jpeg.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.tario_decode_jpeg.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tario_jpeg_dims.restype = ctypes.c_int
    lib.tario_jpeg_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.tario_free.restype = None
    lib.tario_free.argtypes = [ctypes.c_void_p]
    lib.tario_open.restype = ctypes.c_void_p
    lib.tario_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                               ctypes.c_int]
    lib.tario_next.restype = ctypes.c_void_p
    lib.tario_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.tario_member.restype = ctypes.POINTER(ctypes.c_ubyte)
    lib.tario_member.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_long)]
    lib.tario_sample_key.restype = ctypes.c_char_p
    lib.tario_sample_key.argtypes = [ctypes.c_void_p]
    lib.tario_release_sample.restype = None
    lib.tario_release_sample.argtypes = [ctypes.c_void_p]
    lib.tario_close.restype = None
    lib.tario_close.argtypes = [ctypes.c_void_p]


def _check_decode(lib: ctypes.CDLL, path: Path) -> None:
    """Decode one small JPEG: a libjpeg whose ABI differs from the headers'
    fails ``jpeg_CreateDecompress``'s version and struct-size checks, which
    would otherwise turn every decode into None."""
    from PIL import Image

    buf = io.BytesIO()
    Image.new("RGB", (16, 8), (200, 30, 90)).save(buf, "JPEG")
    if _decode(lib, buf.getvalue(), 1) is None:
        raise RuntimeError(
            f"{path} cannot decode a JPEG: its libjpeg does not match the "
            f"6.2 headers in {JPEG_INCLUDE}")


def load(compiler: str = "g++", build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The native library, built first where it is not yet; raises
    ``RuntimeError`` naming the compiler, the library or the headers it
    could not use."""
    key = (compiler, str(build_dir))
    if key in _loaded:
        return _loaded[key]
    lib_path = library_path(compiler, build_dir)
    if not lib_path.exists():
        _build(compiler, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    _declare(lib)
    _check_decode(lib, lib_path)
    _loaded[key] = lib
    return lib


def available() -> bool:
    """Whether the native library builds and loads here."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _decode(lib: ctypes.CDLL, data: bytes, denom: int
            ) -> Optional[np.ndarray]:
    w, h = ctypes.c_int(), ctypes.c_int()
    ptr = lib.tario_decode_jpeg(data, len(data), denom, ctypes.byref(w),
                                ctypes.byref(h))
    if not ptr:
        return None
    try:
        return np.ctypeslib.as_array(ptr, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.tario_free(ptr)


def scale_denom(lib: ctypes.CDLL, data: bytes,
                min_size: Optional[int]) -> int:
    """The largest DCT scale denominator in {8, 4, 2} whose output short
    side stays >= ``min_size``, else 1 (and 1 without ``min_size`` or for
    bytes whose header does not parse)."""
    if min_size is None:
        return 1
    w, h = ctypes.c_int(), ctypes.c_int()
    if lib.tario_jpeg_dims(data, len(data), ctypes.byref(w),
                           ctypes.byref(h)) != 0:
        return 1
    short = min(w.value, h.value)
    for d in (8, 4, 2):
        if short // d >= min_size:
            return d
    return 1


def decode_jpeg_scaled(data: bytes, min_size: Optional[int] = None
                       ) -> Optional[np.ndarray]:
    """A JPEG as an RGB uint8 array [H, W, 3], or None where libjpeg refuses
    it (corrupt, CMYK).  With ``min_size`` it decodes at the largest DCT
    scale (1/8, 1/4, 1/2) whose short side stays >= ``min_size``: a 2000 px
    photo bound for a 224 px crop decodes at 1/4 for ``min_size`` 448."""
    lib = load()
    return _decode(lib, data, scale_denom(lib, data, min_size))


class NativeTarStream:
    """Iterator over ``{"__key__": bytes, ext: bytes}`` samples of tar
    shards, read ahead by a native background thread (at most ``capacity``
    samples queued)."""

    def __init__(self, paths, capacity: int = 64):
        self._handle = None
        self._lib = load()
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self._handle = self._lib.tario_open(arr, len(paths), capacity)

    def __iter__(self) -> Iterator[Dict[str, bytes]]:
        lib = self._lib
        while self._handle:
            n = ctypes.c_int()
            s = lib.tario_next(self._handle, ctypes.byref(n))
            if not s:
                return
            sample: Dict[str, bytes] = {"__key__": lib.tario_sample_key(s)}
            for i in range(n.value):
                ext = ctypes.c_char_p()
                size = ctypes.c_long()
                ptr = lib.tario_member(s, i, ctypes.byref(ext),
                                       ctypes.byref(size))
                sample[ext.value.decode()] = ctypes.string_at(ptr, size.value)
            lib.tario_release_sample(s)
            yield sample

    def close(self) -> None:
        if self._handle:
            self._lib.tario_close(self._handle)
            self._handle = None

    def __enter__(self) -> "NativeTarStream":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
