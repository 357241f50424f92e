"""Checks and launch plumbing shared by the fused-LayerNorm wrappers."""

from __future__ import annotations

from typing import Optional

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(op: str, name: str, t: torch.Tensor,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None, align: int = 16) -> None:
    """Raise unless ``t`` is a contiguous, ``align``-byte aligned CUDA tensor
    of ``dtype`` (float32 or bfloat16 when None) on ``device``."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: {name} is on {t.device}; no kernel there")
    if device is not None and t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, expected {device}")
    if dtype is None and t.dtype not in DTYPE_CODES:
        raise TypeError(f"{op}: {name} dtype {t.dtype} not supported "
                        "(float32 or bfloat16)")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{op}: {name} dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{op}: {name} must be {align}-byte aligned")


def check_device(op: str, *tensors: torch.Tensor) -> None:
    """Raise unless each tensor is on the CPU (the plain version) or on a
    card (the kernel): checked before the operator dispatches, since a
    tensor elsewhere (``meta``) would reach the fake implementation."""
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{op}: a tensor is on {t.device}; no kernel "
                             "there")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will record a call on these inputs: only then
    does a wrapper go through its autograd Function and save anything."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def call_on(device: torch.device, fn, pack, *args) -> int:
    """``fn(pack(*args, stream))``, with ``stream`` the handle of PyTorch's
    current stream on ``device``, made the current device only when it is
    not already: ``pack`` lays the arguments out as the kernel library's
    argument struct, so one pointer crosses ctypes.  The handle comes from
    the raw getter that PyTorch's own generated kernels use:
    ``torch.cuda.current_stream().cuda_stream`` builds a Stream object
    (PERF.md, PR 6, for both costs on the card's host)."""
    index = device.index
    if index == torch.cuda.current_device():
        return fn(pack(*args, torch._C._cuda_getCurrentRawStream(index)))
    with torch.cuda.device(device):
        return fn(pack(*args, torch._C._cuda_getCurrentRawStream(index)))


def raise_on_error(op: str, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{op}: kernel launch failed with cudaError {rc} at {what}")
