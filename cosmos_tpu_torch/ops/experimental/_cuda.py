"""Checks and launch plumbing shared by the fused-LayerNorm wrappers."""

from __future__ import annotations

from typing import Optional

import torch

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda(op: str, name: str, t: torch.Tensor,
               dtype: Optional[torch.dtype] = None,
               device: Optional[torch.device] = None) -> None:
    """Raise unless ``t`` is a contiguous, 16-byte aligned CUDA tensor of
    ``dtype`` (float32 or bfloat16 when None) on ``device``."""
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
    if t.data_ptr() % 16:
        raise ValueError(f"{op}: {name} must be 16-byte aligned")


def needs_grad(*tensors: torch.Tensor) -> bool:
    """True when autograd will record a call on these inputs: only then
    does a wrapper go through its autograd Function and save anything."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def raise_on_error(op: str, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{op}: kernel launch failed with cudaError {rc} at {what}")
