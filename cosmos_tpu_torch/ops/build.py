"""Build the port's CUDA kernels at first use and load them with ctypes.

Each kernel source under ``ops/csrc/`` has a plain C interface.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/cosmos_tpu_torch/`` at the root of the checkout, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one loads the library already
there.  Each source has its own lock, so several
sources compile at once (``build_all``).  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
# every kernel of the port: K1, K2 (ops/fused_attention.py), K3, K4, K5, K6
# (ops/experimental/)
SOURCES = ("fused_attention_fwd.cu", "fused_attention_bwd.cu",
           "layer_norm_fwd.cu", "layer_norm_bwd.cu", "ln_matmul.cu",
           "mlp_block.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "cosmos_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()                 # guards _source_locks
_source_locks: Dict[str, threading.Lock] = {}
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each library built by
# this process, by source name
build_logs: Dict[str, str] = {}


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are compiled from source at first use"
    )


def load_kernel_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` (once per content hash) and load it."""
    with _lock:
        source_lock = _source_locks.setdefault(source, threading.Lock())
    with source_lock:
        if source in _loaded:
            return _loaded[source]
        src = CSRC / source
        headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
        digest = hashlib.sha256(
            src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        lib_path = BUILD_DIR / f"{src.stem}-{digest}.so"
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {src}:\n"
                    f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
                )
            build_logs[source] = proc.stdout + proc.stderr
            # rename is atomic: a concurrent process sees no half-written file
            os.replace(tmp, lib_path)
        _loaded[source] = ctypes.CDLL(str(lib_path))
        return _loaded[source]


def build_all(sources: Iterable[str] = SOURCES) -> None:
    """Compile (or load) several sources (by default every kernel of the
    port), one nvcc process for each, all started together."""
    sources = list(sources)
    with ThreadPoolExecutor(max_workers=max(len(sources), 1)) as pool:
        for _ in pool.map(load_kernel_library, sources):
            pass
