"""Packed-QKV fused attention, forward and backward (counterpart of
``cosmos_tpu/ops/fused_attention.py``).

``fused_attention_qkv(qkv, num_heads, causal)`` computes, per head,
softmax(q kᵀ/√Dh [+ causal]) v over a packed ``[B, L, 3D]`` tensor whose
last-axis thirds are q|k|v, head h at columns ``[h*Dh, (h+1)*Dh)`` of each
third (torch's ``in_proj`` packing), and returns ``[B, L, D]`` in the input
dtype.  It is differentiable on every device: when a gradient is required
it runs as a ``torch.autograd.Function`` whose backward is the JAX
package's custom VJP (P recomputed in float32, ``dv`` from P rounded to the
input dtype, ``ds`` rounded to the input dtype before ``dq`` and ``dk``),
and returns the packed ``d(qkv)``.

On a CUDA tensor the forward launches the hand-written Hopper kernel K1
(``csrc/fused_attention_fwd.cu``) and the backward K2
(``csrc/fused_attention_bwd.cu``), both built at first use (see
``ops/build.py``), or raises; there is no fallback.  On a CPU tensor they
compute the same functions with ``fused_attention_qkv_reference`` and
``fused_attention_qkv_backward_reference``, the plain PyTorch versions that
the tests and ``chip_smoke.py`` hold the kernels to.

Both are operators of the ``cosmos_tpu_torch`` namespace
(``torch.ops.cosmos_tpu_torch.fused_attention_fwd`` and
``fused_attention_bwd``): a CPU implementation (the plain version), a CUDA
one (the kernel), a fake one (shapes only, for ``torch.export`` and fake
tensors) and a FLOP formula (SDPA's, for ``FlopCounterMode``).  The
autograd Function calls them, and the forward operator is called directly
where no gradient is needed.  Selective checkpointing therefore sees K1:
``everything_saveable`` keeps its output, every other remat policy
recomputes it, as JAX's policies treat the Pallas call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import (register_flop_formula,
                                      sdpa_backward_flop_count,
                                      sdpa_flop_count)

from .build import build_all, load_kernel_library

SOURCE = "fused_attention_fwd.cu"       # K1
SOURCE_BWD = "fused_attention_bwd.cu"   # K2
HEAD_DIMS = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535  # gridDim.z

# kernel launches by this process (K1, and K2 counted once per backward
# call of its two passes); chip_smoke.py zeroes and reads them
launches = 0
launches_bwd = 0


def _head_group(num_heads: int, dh: int) -> int:
    """The JAX kernel's heads per grid step (``cosmos_tpu/ops/
    fused_attention.py`` ``_head_group``): the widest group of 4, 2 or 1
    heads whose width is a multiple of 128 and that divides the head count;
    0 when there is none (an odd head count at Dh 64)."""
    for hg in (4, 2, 1):
        if num_heads % hg == 0 and (hg * dh) % 128 == 0:
            return hg
    return 0


# the JAX kernel's per-grid-step VMEM budget (``cosmos_tpu/ops/
# fused_attention.py`` ``_COMPILE_SAFE_WS``): a length whose one-row
# backward working set exceeds it goes to JAX's XLA path, and so to the
# plain path here
_COMPILE_SAFE_WS = 12 * 1024 * 1024


def _working_set(blk: int, l: int, d: int, dh: int, itemsize: int,
                 backward: bool) -> int:
    """The JAX kernel's VMEM bytes for one batch block (``_working_set``
    there): the in/out slabs, the float32 P/dP matrices and head slices."""
    slabs = 3 * l * d + l * d
    if backward:
        slabs += 3 * l * d + l * d
    varying = 2 * l * l * 4 + 6 * l * dh * itemsize
    return blk * (slabs * itemsize + varying)


def supported(num_heads: int, d: int, l: Optional[int] = None,
              itemsize: int = 2) -> bool:
    """JAX's routing gate (``cosmos_tpu/ops/fused_attention.py``
    ``supported``): the head dim is 64 or 128, the heads form a group as
    the JAX kernel's do (an odd count at Dh 64 takes the stock path), and,
    when the length is known, the one-row backward working set at the
    input's ``itemsize`` fits ``_COMPILE_SAFE_WS``: at ViT-B width L <= 680
    in bfloat16 and L <= 426 in float32.  The kernels themselves do not
    bound L; a length the gate refuses takes the plain path, as JAX's takes
    XLA."""
    if d % num_heads or d // num_heads not in HEAD_DIMS:
        return False
    dh = d // num_heads
    if _head_group(num_heads, dh) == 0:
        return False
    if l is not None and _working_set(1, l, d, dh, itemsize,
                                      backward=True) > _COMPILE_SAFE_WS:
        return False
    return True


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
            f"num_heads={num_heads} (need a head dim in {HEAD_DIMS} and "
            "heads that form a group: an even count at head dim 64)")
    return b, l, d, d // num_heads


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    # [B, L, D] -> [B, H, L, Dh] in float32
    b, l, d = t.shape
    return t.reshape(b, l, num_heads, d // num_heads).transpose(1, 2).float()


def _probabilities(q, k, causal: bool) -> torch.Tensor:
    """float32 softmax of the scaled logits (max-subtracted)."""
    l = q.shape[-2]
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        above = torch.ones(l, l, dtype=torch.bool, device=q.device).triu(1)
        s = s.masked_fill(above, float("-inf"))
    return torch.softmax(s, dim=-1)


def fused_attention_qkv_reference(qkv: torch.Tensor, num_heads: int,
                                  causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K1: heads split in torch, float32 logits and
    max-subtracted softmax, P cast to the input dtype, P·V accumulated in
    float32, output in the input dtype."""
    b, l, d, _ = _geometry(qkv, num_heads)
    q, k, v = (_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    p = _probabilities(q, k, causal).to(qkv.dtype).float()
    o = torch.matmul(p, v).to(qkv.dtype)
    return o.transpose(1, 2).reshape(b, l, d)


def fused_attention_qkv_backward_reference(qkv: torch.Tensor,
                                           dout: torch.Tensor,
                                           num_heads: int,
                                           causal: bool = False
                                           ) -> torch.Tensor:
    """Plain PyTorch version of K2: the JAX package's custom VJP
    (``cosmos_tpu/ops/fused_attention.py:199-221``), not autograd of the
    plain forward.  float32 logits and normalised float32 P; ``dv`` from P
    cast to the input dtype; ``ds = P·(dP − Σ dP·P)·scale`` cast to the
    input dtype before ``dq = ds·k`` and ``dk = dsᵀ·q``; every product
    accumulated in float32.  Returns the packed ``[B, L, 3D]`` d(qkv) in
    the input dtype."""
    b, l, d, dh = _geometry(qkv, num_heads)
    if dout.shape != (b, l, d):
        raise ValueError(
            f"fused_attention_qkv backward: dout shape {tuple(dout.shape)}, "
            f"expected {(b, l, d)}")
    dtype = qkv.dtype
    q, k, v = (_heads(t, num_heads) for t in qkv.split(d, dim=-1))
    do = _heads(dout.to(dtype), num_heads)
    p = _probabilities(q, k, causal)
    dv = torch.matmul(p.to(dtype).float().transpose(-1, -2), do)
    dp = torch.matmul(do, v.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) * dh ** -0.5
    ds = ds.to(dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return torch.cat([t.to(dtype).transpose(1, 2).reshape(b, l, d)
                      for t in (dq, dk, dv)], dim=-1)


@functools.lru_cache(maxsize=None)
def _function():
    fn = load_kernel_library(SOURCE).cosmos_fused_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _function_bwd():
    fn = load_kernel_library(SOURCE_BWD).cosmos_fused_attention_bwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) K1's and K2's libraries now, in parallel, rather
    than at first call."""
    build_all([SOURCE, SOURCE_BWD])
    _function()
    _function_bwd()


def _check_cuda(name: str, t: torch.Tensor, b: int, l: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"fused_attention_qkv: no kernel for device {t.device}")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(
            f"fused_attention_qkv: {name} dtype {t.dtype} not supported "
            f"(float32 or bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"fused_attention_qkv: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"fused_attention_qkv: {name} must be 16-byte aligned")
    if not 0 < b <= _MAX_BATCH or l < 1:
        raise ValueError(
            f"fused_attention_qkv: need 1 <= B <= {_MAX_BATCH} and L >= 1, "
            f"got B={b} L={l}")


def _fwd_cuda(qkv: torch.Tensor, num_heads: int, causal: bool) -> torch.Tensor:
    """The operator's CUDA implementation: K1."""
    global launches
    b, l, d, dh = _geometry(qkv, num_heads)
    _check_cuda("qkv", qkv, b, l)
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


def _bwd_cuda(qkv: torch.Tensor, dout: torch.Tensor, num_heads: int,
              causal: bool) -> torch.Tensor:
    """The operator's CUDA implementation: K2."""
    global launches_bwd
    b, l, d, dh = _geometry(qkv, num_heads)
    if dout.shape != (b, l, d) or dout.dtype != qkv.dtype:
        raise ValueError(
            f"fused_attention_qkv backward: dout {tuple(dout.shape)} "
            f"{dout.dtype}, expected {(b, l, d)} {qkv.dtype}")
    # the gradient autograd hands over may be a strided view (an expand or a
    # transpose downstream); K2 reads rows by a fixed stride, so copy it
    # into a dense tensor here
    dout = dout.contiguous()
    _check_cuda("qkv", qkv, b, l)
    _check_cuda("dout", dout, b, l)
    if dout.device != qkv.device:
        raise ValueError("fused_attention_qkv backward: qkv and dout are on "
                         f"{qkv.device} and {dout.device}")
    dqkv = torch.empty_like(qkv)
    # per-row float32 (max, sum, delta) that pass A writes for pass B
    ws = torch.empty(3, b, num_heads, l, dtype=torch.float32,
                     device=qkv.device)
    with torch.cuda.device(qkv.device):
        rc = _function_bwd()(
            qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), ws.data_ptr(),
            b, l, num_heads, dh, _DTYPE_CODES[qkv.dtype], int(causal),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_attention_qkv backward: kernel launch failed with "
            f"cudaError {rc} at B={b} L={l} heads={num_heads} Dh={dh} "
            f"dtype={qkv.dtype}")
    launches_bwd += 1
    return dqkv


# K1 and K2 as operators of the cosmos_tpu_torch namespace, so that
# torch.export, FlopCounterMode and selective checkpointing see them: the
# CPU implementation is the plain version (looked up at call time), the
# CUDA one the kernel, the fake one the output's shape
_LIB = torch.library.Library("cosmos_tpu_torch", "FRAGMENT")
_LIB.define("fused_attention_fwd(Tensor qkv, int num_heads, bool causal) "
            "-> Tensor")
_LIB.define("fused_attention_bwd(Tensor qkv, Tensor dout, int num_heads, "
            "bool causal) -> Tensor")
_LIB.impl("fused_attention_fwd",
          lambda qkv, num_heads, causal: fused_attention_qkv_reference(
              qkv, num_heads, causal), "CPU")
_LIB.impl("fused_attention_fwd", _fwd_cuda, "CUDA")
_LIB.impl("fused_attention_bwd",
          lambda qkv, dout, num_heads, causal:
          fused_attention_qkv_backward_reference(qkv, dout, num_heads,
                                                 causal), "CPU")
_LIB.impl("fused_attention_bwd", _bwd_cuda, "CUDA")


@torch.library.register_fake("cosmos_tpu_torch::fused_attention_fwd",
                             lib=_LIB)
def _fwd_fake(qkv, num_heads, causal):
    b, l, d, _ = _geometry(qkv, num_heads)
    return qkv.new_empty(b, l, d)


@torch.library.register_fake("cosmos_tpu_torch::fused_attention_bwd",
                             lib=_LIB)
def _bwd_fake(qkv, dout, num_heads, causal):
    _geometry(qkv, num_heads)
    return qkv.new_empty(qkv.shape)


def _sdpa_shape(qkv_shape, num_heads):
    b, l, d3 = qkv_shape
    return (b, num_heads, l, d3 // 3 // num_heads)


@register_flop_formula(torch.ops.cosmos_tpu_torch.fused_attention_fwd)
def _fwd_flops(qkv_shape, num_heads, causal, out_shape=None, **kwargs):
    """SDPA's count, 4·B·L²·D, the full L² when causal too."""
    s = _sdpa_shape(qkv_shape, num_heads)
    return sdpa_flop_count(s, s, s)


@register_flop_formula(torch.ops.cosmos_tpu_torch.fused_attention_bwd)
def _bwd_flops(qkv_shape, dout_shape, num_heads, causal, out_shape=None,
               **kwargs):
    """SDPA backward's count: five L²-sized products, 10·B·L²·D."""
    s = _sdpa_shape(qkv_shape, num_heads)
    return sdpa_backward_flop_count(s, s, s, s)


_FWD = torch.ops.cosmos_tpu_torch.fused_attention_fwd.default
_BWD = torch.ops.cosmos_tpu_torch.fused_attention_bwd.default


def _check_device(*tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(
                f"fused_attention_qkv: no kernel for device {t.device}")


def fused_attention_qkv_backward(qkv: torch.Tensor, dout: torch.Tensor,
                                 num_heads: int,
                                 causal: bool = False) -> torch.Tensor:
    """Packed d(qkv) ``[B, L, 3D]`` from (qkv, dout): K2 on a CUDA tensor,
    ``fused_attention_qkv_backward_reference`` on a CPU tensor."""
    _check_device(qkv, dout)
    return _BWD(qkv, dout, num_heads, causal)


class _FusedAttentionQKV(torch.autograd.Function):
    """K1 forward, K2 backward; saves only ``qkv``."""

    @staticmethod
    def forward(ctx, qkv, num_heads, causal):
        ctx.num_heads, ctx.causal = num_heads, causal
        ctx.save_for_backward(qkv)
        return _FWD(qkv, num_heads, causal)

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        (qkv,) = ctx.saved_tensors
        return (fused_attention_qkv_backward(qkv, dout, ctx.num_heads,
                                             ctx.causal), None, None)


def fused_attention_qkv(qkv: torch.Tensor, num_heads: int,
                        causal: bool = False) -> torch.Tensor:
    """softmax(q kᵀ/√Dh [+ causal]) v over a packed [B, L, 3D] tensor.

    Under grad mode, for a ``qkv`` that requires a gradient, the output
    carries the autograd node whose backward is K2 (or its plain version
    on the CPU); otherwise (``no_grad``, ``inference_mode``, a constant
    input) nothing is saved and only the forward runs."""
    _geometry(qkv, num_heads)
    _check_device(qkv)
    if torch.is_grad_enabled() and qkv.requires_grad:
        return _FusedAttentionQKV.apply(qkv, num_heads, causal)
    return _FWD(qkv, num_heads, causal)
