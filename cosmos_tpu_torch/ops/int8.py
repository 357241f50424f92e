"""Int8 weight quantization (counterpart of ``cosmos_tpu/ops/int8.py``).

Symmetric per-output-channel int8 weights with float32 scales, and a
product of int8 activations (quantized per row on the fly) with int8
weights accumulated in int32.  The JAX package's product is an XLA
``dot_general``, not a Pallas kernel; here it is ``torch._int_mm`` on the
card (cuBLASLt's int8 GEMM: rows > 16, K and N multiples of 8) and, on the
CPU or at other shapes, the same integers from a float64 product, which is
exact while ``K * 127**2 < 2**53``.  As in the JAX package, the product is
for weight compression and export (a 4x smaller state dict, dequantized on
load), not for faster serving.

Layouts.  A Linear weight is torch's ``[N, K]`` (out, in): its output
channels are rows, where JAX's ``[K, N]`` kernel has them as columns, so
``quantize_weight`` reduces over dim 1 by default.  The bare matrices
``visual.proj`` and ``text_projection`` (``[in, out]``) and an embedding
``[V, D]`` are stored as the JAX package stores them and reduce over
dim 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

_BARE = ("visual.proj", "text_projection")


def _per_127(absmax: torch.Tensor) -> torch.Tensor:
    """``max(absmax / 127, 1e-12)`` by a true division on every device:
    CUDA divides by a Python scalar as a product with its reciprocal,
    which can differ from the quotient in the last bit."""
    return torch.clamp(absmax / absmax.new_tensor(127.0), min=1e-12)


def quantize_weight(w: torch.Tensor, in_dim: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(int8 weights, float32 scale per output channel)``; ``in_dim`` is
    the input-feature dim the absolute maximum is taken over."""
    w32 = w.float()
    scale = _per_127(w32.abs().amax(dim=in_dim))
    s = scale.unsqueeze(in_dim)
    q = torch.clamp(torch.round(w32 / s), -127, 127).to(torch.int8)
    return q, scale


def quantize_activations(x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 quantization of ``[.., K]``."""
    x32 = x.float()
    scale = _per_127(x32.abs().amax(dim=-1, keepdim=True))
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _int_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [N, K].T`` in int32, exactly."""
    m, k = xq.shape
    n = wq.shape[0]
    if xq.is_cuda and m > 16 and k % 8 == 0 and n % 8 == 0:
        return torch._int_mm(xq.contiguous(), wq.contiguous().t())
    if k * 127 * 127 >= 1 << 53:
        raise ValueError(f"K = {k} is too long for an exact float64 product")
    return (xq.double() @ wq.double().t()).to(torch.int32)


def int8_matmul(x: torch.Tensor, w_int8: torch.Tensor,
                w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x [.., K]`` times int8 weights ``[N, K]`` (a Linear's layout)
    with int32 accumulation: ``[.., N]`` in ``out_dtype``."""
    xq, x_scale = quantize_activations(x)
    lead = x.shape[:-1]
    acc = _int_product(xq.reshape(-1, x.shape[-1]), w_int8)
    acc = acc.reshape(*lead, w_int8.shape[0])
    return (acc.float() * x_scale * w_scale).to(out_dtype)


def quant_in_dim(key: str, value: torch.Tensor) -> Optional[int]:
    """The input dim of a state-dict entry the JAX package quantizes (its
    ``kernel``, ``in_proj_kernel``, ``embedding``, ``proj`` and
    ``text_projection_kernel`` leaves), or None."""
    if value.ndim != 2 or not value.is_floating_point():
        return None
    if key in _BARE or key.endswith("token_embedding.weight"):
        return 0
    if key.endswith((".weight", "in_proj_weight")):
        return 1
    return None


def quantize_dense_params(state_dict: Dict[str, torch.Tensor],
                          min_size: int = 1 << 16
                          ) -> Dict[str, torch.Tensor]:
    """The state dict with each large matrix ``k`` replaced by ``k_int8``
    and ``k_scale`` (for export)."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        dim = quant_in_dim(k, v)
        if dim is not None and v.numel() >= min_size:
            out[k + "_int8"], out[k + "_scale"] = quantize_weight(v, dim)
        else:
            out[k] = v
    return out


def dequantize_dense_params(state_dict: Dict[str, torch.Tensor]
                            ) -> Dict[str, torch.Tensor]:
    """The inverse of ``quantize_dense_params``: each ``k_int8``/``k_scale``
    pair folded back into a float32 ``k``."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in state_dict.items():
        if k.endswith("_int8"):
            base = k[:-len("_int8")]
            scale = state_dict[base + "_scale"]
            dim = quant_in_dim(base, v.float())
            out[base] = v.float() * scale.unsqueeze(dim)
        elif k.endswith("_scale") and k[:-len("_scale")] + "_int8" in \
                state_dict:
            continue
        else:
            out[k] = v
    return out


def quantized_bytes(state_dict: Dict[str, torch.Tensor]) -> Tuple[int, int]:
    """(bytes after int8 quantization, bytes at float32)."""
    q = quantize_dense_params(state_dict)
    after = sum(t.numel() * t.element_size() for t in q.values())
    before = sum(t.numel() * 4 for t in state_dict.values())
    return after, before
