"""Packed-QKV fused attention forward (counterpart of
``cosmos_tpu/ops/fused_attention.py``).

``fused_attention_qkv(qkv, num_heads, causal)`` computes, per head,
softmax(q kᵀ/√Dh [+ causal]) v over a packed ``[B, L, 3D]`` tensor whose
last-axis thirds are q|k|v, head h at columns ``[h*Dh, (h+1)*Dh)`` of each
third (torch's ``in_proj`` packing), and returns ``[B, L, D]`` in the input
dtype.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/fused_attention_fwd.cu`` (built at first use, see ``ops/build.py``)
or raises; there is no fallback.  On a CPU tensor it computes the same
function with ``fused_attention_qkv_reference``, the plain PyTorch version
that the tests and ``chip_smoke.py`` hold the kernel to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import load_kernel_library

SOURCE = "fused_attention_fwd.cu"
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # gridDim.z

# kernel launches by this process; chip_smoke.py zeroes and reads it
launches = 0


def supported(num_heads: int, d: int) -> bool:
    """True when the kernel takes this geometry: the head dim is 64 or 128."""
    return d % num_heads == 0 and d // num_heads in HEAD_DIMS


def _geometry(qkv: torch.Tensor, num_heads: int):
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(
            f"fused_attention_qkv: expected a packed [B, L, 3D] tensor, got "
            f"shape {tuple(qkv.shape)}")
    b, l, d3 = qkv.shape
    d = d3 // 3
    if not supported(num_heads, d):
        raise ValueError(
            f"fused_attention_qkv: unsupported geometry D={d} "
            f"num_heads={num_heads} (need a head dim in {HEAD_DIMS})")
    return b, l, d, d // num_heads


def fused_attention_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                  causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: heads split in torch, float32
    logits and max-subtracted softmax, P cast to the input dtype, P·V
    accumulated in float32, output in the input dtype."""
    b, l, d, dh = _geometry(qkv, num_heads)

    def heads(t):
        return t.reshape(b, l, num_heads, dh).transpose(1, 2).float()

    q, k, v = (heads(t) for t in qkv.split(d, dim=-1))
    s = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
    if causal:
        above = torch.ones(l, l, dtype=torch.bool, device=qkv.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    p = torch.softmax(s, dim=-1).to(qkv.dtype).float()
    o = torch.matmul(p, v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, l, d)


@functools.lru_cache(maxsize=None)
def _function():
    fn = load_kernel_library(SOURCE).cosmos_fused_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) the kernel library now rather than at first call."""
    _function()


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ/√Dh [+ causal]) v over a packed [B, L, 3D] tensor."""
    global launches
    b, l, d, dh = _geometry(qkv, num_heads)
    if qkv.device.type == "cpu":
        return fused_attention_qkv_reference(qkv, num_heads, causal)
    if qkv.device.type != "cuda":
        raise ValueError(
            f"fused_attention_qkv: no kernel for device {qkv.device}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"fused_attention_qkv: dtype {qkv.dtype} not supported "
            f"(float32 or bfloat16)")
    if not qkv.is_contiguous():
        raise ValueError("fused_attention_qkv: qkv must be contiguous")
    if qkv.data_ptr() % 16:
        raise ValueError("fused_attention_qkv: qkv must be 16-byte aligned")
    if not 0 < b <= _MAX_BATCH or l < 1:
        raise ValueError(
            f"fused_attention_qkv: need 1 <= B <= {_MAX_BATCH} and L >= 1, "
            f"got B={b} L={l}")
    out = torch.empty(b, l, d, dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _function()(
            qkv.data_ptr(), out.data_ptr(), b, l, num_heads, dh,
            _DTYPE_CODES[qkv.dtype], int(causal),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_attention_qkv: kernel launch failed with cudaError {rc} "
            f"at B={b} L={l} heads={num_heads} Dh={dh} dtype={qkv.dtype}")
    launches += 1
    return out
