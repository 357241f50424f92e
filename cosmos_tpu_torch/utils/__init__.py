"""Small shared utilities (counterpart of ``cosmos_tpu/utils/__init__.py``).

``freeze_batch_stats``, ``enable_compilation_cache``,
``_stabilize_mosaic_cache_key`` and ``strip_module_locations`` work around
Flax or the XLA runtime and have no counterpart here.
"""

from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn


Weights = Union[nn.Module, Dict[str, torch.Tensor]]


def count_params(weights: Weights) -> int:
    """Elements of a module's parameters, or of a state dict's tensors."""
    tensors = (weights.parameters() if isinstance(weights, nn.Module)
               else weights.values())
    return sum(t.numel() for t in tensors)


def convert_weights_to_lp(weights: Weights, dtype: torch.dtype = torch.float16
                          ) -> Weights:
    """Cast every floating-point tensor to ``dtype``: a module's parameters
    and buffers in place (returned), or a state dict as a new one.  The
    usual policy keeps the parameters float32 and sets the compute dtype
    (``create_model(precision="bf16")``)."""
    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.to(dtype) if t.is_floating_point() else t

    if isinstance(weights, nn.Module):
        return weights._apply(cast)
    return {k: cast(v) for k, v in weights.items()}


def convert_weights_to_fp16(weights: Weights) -> Weights:
    return convert_weights_to_lp(weights, torch.float16)
