"""Single-pass fused LayerNorm, forward K3 and backward K4 (counterpart of
``cosmos_tpu/ops/experimental/layer_norm.py``).

``fused_layer_norm(x, scale, bias, eps)`` normalises the last axis of a
``[B, L, D]`` tensor with float32 single-pass statistics
(E[x²] − E[x]², clamped at 0), ``y = ((x − mean)·rstd)·scale + bias`` in
float32, cast to ``x.dtype``; ``scale`` and ``bias`` are float32 ``[D]``.
Its forward keeps the float32 ``mean`` and ``rstd`` (``[B, L, 1]``) for the
backward, which gives ``dx`` in ``x.dtype`` and float32 ``dscale``,
``dbias`` summed over every row.  ``hybrid_layer_norm`` is the same
function with the plain PyTorch forward and the same backward.

On a CUDA tensor the forward launches K3 (``csrc/layer_norm_fwd.cu``) and
the backward K4 (``csrc/layer_norm_bwd.cu``), both built at first use (see
``ops/build.py``), or raise; there is no fallback.  On a CPU tensor they
compute the same functions with ``layer_norm_fwd_reference`` and
``layer_norm_bwd_reference``, the plain versions that the tests and
``chip_smoke.py`` hold the kernels to.

``supported(x)`` is a copy of the JAX package's predicate, so that the same
LayerNorms take the fused path in both packages.  Its 12 MiB working-set
rule is a TPU VMEM budget; the CUDA kernels have no such limit, but the
predicate is kept so that the routing matches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from ..build import build_all, load_kernel_library
from ._cuda import (DTYPE_CODES, check_cuda, needs_grad, raise_on_error,
                    stream)

SOURCE = "layer_norm_fwd.cu"       # K3
SOURCE_BWD = "layer_norm_bwd.cu"   # K4
_VMEM_BUDGET = 12 * 1024 * 1024
_MAX_D_BWD = 7168     # K4's per-warp column sums: 32·D bytes of shared memory
_BWD_WARPS = 4        # warps per block of K4's rows pass
_BWD_MAX_BLOCKS = 1024

# kernel launches by this process (K3; K4 counted once per call of its two
# passes); chip_smoke.py zeroes and reads them
launches = 0
launches_bwd = 0


def _row_bytes(d: int, itemsize: int) -> int:
    return d * (3 * itemsize + 2 * 4)


def supported(x: torch.Tensor) -> bool:
    """``cosmos_tpu/ops/experimental/layer_norm.py:100-106``: a 3-D input
    with D % 128 == 0, an even batch, and one batch row's backward working
    set within 12 MiB."""
    if x.dim() != 3:
        return False
    b, l, d = x.shape
    return (d % 128 == 0 and b % 2 == 0
            and l * _row_bytes(d, x.element_size()) <= _VMEM_BUDGET)


def layer_norm_fwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             bias: torch.Tensor, eps: float = 1e-5
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3 (and the hybrid's forward, JAX's
    ``_hln_math``): ``(y, mean, rstd)``, the statistics float32 with a
    trailing unit axis."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    msq = (xf * xf).mean(-1, keepdim=True)
    var = (msq - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    y = ((xf - mean) * rstd * scale + bias).to(x.dtype)
    return y, mean, rstd


def layer_norm_bwd_reference(x: torch.Tensor, scale: torch.Tensor,
                             mean: torch.Tensor, rstd: torch.Tensor,
                             g: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K4 (the TPU kernel's formula,
    ``layer_norm.py:57-80``): ``(dx, dscale, dbias)``."""
    xf = x.float()
    gf = g.float()
    d = x.shape[-1]
    xh = (xf - mean) * rstd
    gs = gf * scale
    m1 = gs.sum(-1, keepdim=True) / d
    m2 = (gs * xh).sum(-1, keepdim=True) / d
    dx = (rstd * (gs - m1 - xh * m2)).to(x.dtype)
    rows = tuple(range(x.dim() - 1))
    return dx, (gf * xh).sum(rows), gf.sum(rows)


@functools.lru_cache(maxsize=None)
def _function():
    fn = load_kernel_library(SOURCE).cosmos_layer_norm_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _function_bwd():
    fn = load_kernel_library(SOURCE_BWD).cosmos_layer_norm_bwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) K3's and K4's libraries now, in parallel."""
    build_all([SOURCE, SOURCE_BWD])
    _function()
    _function_bwd()


def _check_params(op: str, x: torch.Tensor, *params: torch.Tensor) -> int:
    if x.dim() < 1 or x.shape[-1] % 8:
        raise ValueError(f"{op}: need a last axis that is a multiple of 8, "
                         f"got shape {tuple(x.shape)}")
    d = x.shape[-1]
    check_cuda(op, "x", x)
    for i, p in enumerate(params):
        if p.shape != (d,):
            raise ValueError(f"{op}: parameter {i} has shape "
                             f"{tuple(p.shape)}, expected ({d},)")
        check_cuda(op, f"parameter {i}", p, torch.float32, x.device)
    return d


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: K3 on a CUDA tensor, the plain version on a CPU
    tensor."""
    global launches
    if x.device.type == "cpu":
        return layer_norm_fwd_reference(x, scale, bias, eps)
    op = "fused_layer_norm"
    x = x.contiguous()
    d = _check_params(op, x, scale, bias)
    r = x.numel() // d
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1] + (1,), dtype=torch.float32,
                       device=x.device)
    rstd = torch.empty_like(mean)
    if r:
        with torch.cuda.device(x.device):
            rc = _function()(
                x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                mean.data_ptr(), rstd.data_ptr(), r, d, eps,
                DTYPE_CODES[x.dtype], stream(x))
        raise_on_error(op, rc, f"R={r} D={d} dtype={x.dtype}")
        launches += 1
    return y, mean, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)``: K4 on a CUDA tensor, the plain version on a
    CPU tensor."""
    global launches_bwd
    if x.device.type == "cpu" and g.device.type == "cpu":
        return layer_norm_bwd_reference(x, scale, mean, rstd, g)
    op = "fused_layer_norm backward"
    # autograd may hand over a strided gradient; K4 reads rows densely
    x, g = x.contiguous(), g.contiguous()
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"{op}: gradient {tuple(g.shape)} {g.dtype}, "
                         f"expected {tuple(x.shape)} {x.dtype}")
    d = _check_params(op, x, scale)
    if d > _MAX_D_BWD:
        raise ValueError(f"{op}: D={d} above the kernel's {_MAX_D_BWD}")
    check_cuda(op, "gradient", g, x.dtype, x.device)
    r = x.numel() // d
    for name, t in (("mean", mean), ("rstd", rstd)):
        check_cuda(op, name, t, torch.float32, x.device)
        if t.numel() != r:
            raise ValueError(f"{op}: {name} has {t.numel()} rows, x {r}")
    dx = torch.empty_like(x)
    dsb = torch.zeros(2, d, dtype=torch.float32, device=x.device)
    if r:
        rows_per_block = max(_BWD_WARPS, -(-r // _BWD_MAX_BLOCKS))
        nblocks = -(-r // rows_per_block)
        partial = torch.empty(2, nblocks, d, dtype=torch.float32,
                              device=x.device)
        with torch.cuda.device(x.device):
            rc = _function_bwd()(
                x.data_ptr(), g.data_ptr(), scale.data_ptr(), mean.data_ptr(),
                rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                dsb.data_ptr(), r, d, rows_per_block, DTYPE_CODES[x.dtype],
                stream(x))
        raise_on_error(op, rc, f"R={r} D={d} dtype={x.dtype}")
        launches_bwd += 1
    return dx, dsb[0], dsb[1]


class _FusedLayerNorm(torch.autograd.Function):
    """K3 forward, K4 backward; saves x, scale and the statistics."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        return (*layer_norm_bwd(x, scale, mean, rstd, g), None)


class _HybridLayerNorm(torch.autograd.Function):
    """Plain forward, K4 backward (JAX's ``hybrid_layer_norm``)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps):
        y, mean, rstd = layer_norm_fwd_reference(x, scale, bias, eps)
        ctx.save_for_backward(x, scale, mean, rstd)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, scale, mean, rstd = ctx.saved_tensors
        return (*layer_norm_bwd(x, scale, mean, rstd, g), None)


def fused_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis, K3 forward and K4 backward.  Under
    ``no_grad`` (or with nothing requiring a gradient) only K3 runs."""
    if needs_grad(x, scale, bias):
        return _FusedLayerNorm.apply(x, scale, bias, eps)
    return layer_norm_fwd(x, scale, bias, eps)[0]


def hybrid_layer_norm(x: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis: the plain forward (the same function
    as ``models.layers.LayerNorm``), K4 backward."""
    if needs_grad(x, scale, bias):
        return _HybridLayerNorm.apply(x, scale, bias, eps)
    return layer_norm_fwd_reference(x, scale, bias, eps)[0]
