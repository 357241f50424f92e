"""Precision policy helpers (counterpart of
``cosmos_tpu/training/precision.py``): a precision flag as the compute
dtype of the inputs, the dtype of a manual weight cast, and whether it is
mixed.  Parameters stay float32 and the compute dtype is threaded into the
modules (``models/factory.py`` ``resolve_dtype``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.factory import resolve_dtype


def get_input_dtype(precision: str) -> torch.dtype:
    """The dtype images enter the step in."""
    return resolve_dtype(precision)


def get_cast_dtype(precision: str) -> Optional[torch.dtype]:
    """The dtype the weights themselves are cast to: only for the 'pure'
    modes; amp and fp32 return None."""
    if precision in ("fp16", "pure_fp16"):
        return torch.float16
    if precision in ("pure_bf16",):
        return torch.bfloat16
    return None


def is_mixed_precision(precision: str) -> bool:
    return resolve_dtype(precision) == torch.bfloat16
