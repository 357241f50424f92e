"""Fused LayerNorm → matmul, K5 (counterpart of
``cosmos_tpu/ops/experimental/ln_matmul.py``).

``ln_matmul(x, g, b, w, bias, eps)`` computes ``LayerNorm(x; g, b) @ wᵀ +
bias`` over the last axis of ``x`` (compute dtype), with ``w`` in torch's
``[O, D]`` layout and float32 ``g``, ``b``:

- the normalised rows (float32 single-pass statistics) are rounded to the
  compute dtype before the product (``ln_matmul.py:70``);
- ``w`` is cast to the compute dtype; the product accumulates in float32;
- ``bias`` is rounded to the compute dtype and added in float32, as on the
  JAX package's only path to this kernel, the self-attention's packed QKV
  projection, which passes the bias already cast (``attention.py:120``);
- the result is cast to the compute dtype.

The backward is the JAX custom VJP (``ln_matmul.py:141-168``) in plain
torch ops: the normalisation recomputed from ``x``, every product in
float32 from compute-dtype operands.  ``dw`` is rounded to the compute
dtype, as JAX rounds it to the dtype of the weight its attention path
passes; ``dbias``, ``dg`` and ``db`` stay float32.

On a CUDA tensor the forward launches K5 (``csrc/ln_matmul.cu``), built at
first use, or raises; on a CPU tensor it computes ``ln_matmul_reference``,
the plain version the tests and ``chip_smoke.py`` hold the kernel to.  The
forward is the operator ``torch.ops.cosmos_tpu_torch.ln_matmul_fwd`` (those
two implementations, a fake one and a FLOP formula).  The
TPU kernel's VMEM budget (``_pick_row_block`` refuses float32 ViT-B widths)
has no counterpart: K5 takes any number of rows, with ``D`` a multiple of
64 up to 1024 and ``O`` a multiple of 64 (``check_shapes``; the bf16
kernel's last column tile of 256 is partial where ``O % 256`` is not 0).

Under tensor parallelism a fused block passes its column-parallel
``in_proj_weight``/``in_proj_bias`` as DTensors ``Shard(0)`` on the model
axis: ``ln_matmul`` then runs K5 through the operator's DTensor rule (``x2``,
``g``, ``b`` replicated; ``w``, ``bias`` ``Shard(0)``; ``out`` ``Shard(1)``,
``stats`` replicated) on each rank's local column shard, ``O / tp`` wide,
and returns the feature-sharded ``[..., O]`` DTensor that K1's rule
all-gathers.  No rank builds the whole weight.  The backward gives each rank
its shard's ``dw``/``dbias`` and sums the partial ``dx``, ``dg`` and ``db``
over the model group in float32 (one all-reduce), before ``dx`` is rounded.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from ..build import build_all, load_kernel_library
from . import _tp
from ._cuda import (DTYPE_CODES, check_cuda, check_device, needs_grad,
                    raise_on_error, stream)

SOURCE = "ln_matmul.cu"    # K5
# the kernel's tiles (csrc/ln_matmul.cu): bfloat16 BM rows x BN columns per
# block, k-slices of BK in a ring of STAGES; float32 F32_ROWS rows per block
BM, BN, BK, STAGES = 128, 256, 64, 4
O_STEP = 64                # O's granule: the output's TMA boxes are 64 wide
F32_ROWS = 32
SMEM_LIMIT = 232448        # bytes of shared memory a block can have

# kernel launches by this process; chip_smoke.py zeroes and reads it
launches = 0


def ln_stats(x2: torch.Tensor, eps: float
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(xhat, rstd)`` in float32: single-pass statistics, as JAX's
    ``_ln_stats``."""
    xf = x2.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean.square()).clamp_min(0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mean) * rstd, rstd


def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (2-D) with a float32 result: the products of the operands'
    dtype summed in float32 (JAX's ``preferred_element_type=float32``)."""
    if a.dtype == torch.float32 or a.device.type == "cpu":
        return torch.mm(a.float(), b.float())
    return torch.mm(a, b, out_dtype=torch.float32)


def ln_backward(dy: torch.Tensor, xhat: torch.Tensor, rstd: torch.Tensor,
                g: torch.Tensor, dtype: torch.dtype):
    """``(dx, dg, db)`` from the float32 gradient ``dy`` of the normalised
    rows (JAX's tail of ``_bwd``)."""
    dg = (dy * xhat).sum(0)
    db = dy.sum(0)
    dxhat = dy * g
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    return (rstd * (dxhat - m1 - xhat * m2)).to(dtype), dg, db


def ln_matmul_reference(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        w: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of K5: ``x2`` [R, D] and ``w`` [O, D] in the
    compute dtype, ``g``, ``b`` [D] and ``bias`` [O] float32."""
    xhat, _ = ln_stats(x2, eps)
    y = (xhat * g + b).to(x2.dtype)
    return (mm_f32(y, w.t()) + bias).to(x2.dtype)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of K5 at width ``d``."""
    if dtype == torch.bfloat16:
        # the x and W ring, row statistics, g and b, the barriers, and the
        # slack that aligns the base to 1024 bytes
        return (STAGES * (BM + BN) * BK * 2 + BM * 8 + d * 8
                + 2 * STAGES * 8 + 1024)
    return F32_ROWS * (d + 8) * 4      # the [32][D + 8] row tile


def check_shapes(x2: torch.Tensor, w: torch.Tensor) -> None:
    """Raise unless K5 takes ``x2`` [R, D] and ``w`` [O, D]: any R, D a
    multiple of 64 up to 1024, O a positive multiple of 64 (a tensor-
    parallel shard of ViT-B-16's 2304 is 1152 at tp 2, 576 at tp 4)."""
    if x2.dim() != 2 or w.dim() != 2 or w.shape[1] != x2.shape[1]:
        raise ValueError(f"ln_matmul: x {tuple(x2.shape)} and w "
                         f"{tuple(w.shape)} are not [R, D] and [O, D]")
    d, o = x2.shape[1], w.shape[0]
    if (d % BK or not BK <= d <= 1024 or o % O_STEP or o < O_STEP
            or smem_bytes(d, x2.dtype) > SMEM_LIMIT):
        raise ValueError(f"ln_matmul: need D % {BK} == 0, D <= 1024 and "
                         f"O % {O_STEP} == 0, got D={d} O={o}")


@functools.lru_cache(maxsize=None)
def _function():
    fn = load_kernel_library(SOURCE).cosmos_ln_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) K5's library now."""
    build_all([SOURCE])
    _function()


def _fwd_cuda(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor, eps: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: K5.  ``(out, stats)``."""
    global launches
    op = "ln_matmul"
    check_cuda(op, "x", x2)
    check_shapes(x2, w)
    r, d = x2.shape
    o = w.shape[0]
    check_cuda(op, "w", w, x2.dtype, x2.device)
    for name, t, n in (("g", g, d), ("b", b, d), ("bias", bias, o)):
        if t.shape != (n,):
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)}, "
                             f"expected ({n},)")
        check_cuda(op, name, t, torch.float32, x2.device)
    out = torch.empty(r, o, dtype=x2.dtype, device=x2.device)
    # the bf16 kernel's per-row (mean, rstd), written by its first pass
    stats = torch.empty(r, 2, dtype=torch.float32, device=x2.device)
    if r:
        with torch.cuda.device(x2.device):
            rc = _function()(
                x2.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                bias.data_ptr(), out.data_ptr(), stats.data_ptr(), r, d, o,
                eps, DTYPE_CODES[x2.dtype], stream(x2))
        raise_on_error(op, rc, f"R={r} D={d} O={o} dtype={x2.dtype}")
        launches += 1
    return out, stats


def _fwd_cpu(x2, g, b, w, bias, eps):
    out = ln_matmul_reference(x2, g, b, w, bias, eps)
    _, rstd = ln_stats(x2, eps)
    return out, torch.cat([x2.float().mean(-1, keepdim=True), rstd], 1)


# K5 as an operator of the cosmos_tpu_torch namespace: the plain version
# on the CPU, the kernel on CUDA, a fake implementation for torch.export
# and fake tensors, and a FLOP formula (the product's 2·R·D·O)
_LIB = torch.library.Library("cosmos_tpu_torch", "FRAGMENT")
_LIB.define("ln_matmul_fwd(Tensor x2, Tensor g, Tensor b, Tensor w, "
            "Tensor bias, float eps) -> (Tensor, Tensor)")
_LIB.impl("ln_matmul_fwd", _fwd_cpu, "CPU")
_LIB.impl("ln_matmul_fwd", _fwd_cuda, "CUDA")


@torch.library.register_fake("cosmos_tpu_torch::ln_matmul_fwd", lib=_LIB)
def _fwd_fake(x2, g, b, w, bias, eps):
    r = x2.shape[0]
    return (x2.new_empty(r, w.shape[0]),
            x2.new_empty(r, 2, dtype=torch.float32))


@register_flop_formula(torch.ops.cosmos_tpu_torch.ln_matmul_fwd)
def _fwd_flops(x2_shape, g_shape, b_shape, w_shape, bias_shape, eps,
               out_shape=None, **kwargs) -> int:
    return 2 * x2_shape[0] * x2_shape[1] * w_shape[0]


_FWD = torch.ops.cosmos_tpu_torch.ln_matmul_fwd.default


def _column_sharding(x2, g, b, w, bias, eps) -> list:
    """K5's DTensor strategies on one mesh dim: all replicated, or the
    column-parallel split (``w`` and ``bias`` ``Shard(0)``, ``out``
    ``Shard(1)``); the statistics are the whole rows' on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    r = Replicate()
    rules = [([r, r], [r, r, r, r, r, None])]
    if any(p.is_shard(0) for p in w.placements):
        rules.append(([Shard(1), r], [r, r, r, Shard(0), Shard(0), None]))
    return rules


if torch.distributed.is_available():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(_FWD)(_column_sharding)


def ln_matmul_fwd(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  w: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5,
                  return_stats: bool = False):
    """``[R, O]``: K5 on a CUDA tensor, the plain version on a CPU tensor
    (arguments as ``ln_matmul_reference``).  With ``return_stats``,
    ``(out, stats)``: the float32 ``[R, 2]`` per-row (mean, rstd) that the
    bf16 kernel's first pass writes (K3 holds its statistics to them bit
    for bit); the float32 kernel leaves them unwritten."""
    check_device("ln_matmul", x2)
    out, stats = _FWD(x2, g, b, w, bias, eps)
    return (out, stats) if return_stats else out


def _forward(x, g, b, w, bias, eps):
    d = x.shape[-1]
    out = ln_matmul_fwd(x.reshape(-1, d).contiguous(), g.contiguous(),
                        b.contiguous(), w.to(x.dtype).contiguous(),
                        bias.to(x.dtype).float().contiguous(), eps)
    return out.reshape(x.shape[:-1] + (w.shape[0],))


class _LNMatmul(torch.autograd.Function):
    """K5 forward; JAX's custom VJP in plain torch ops.  Saves x and the
    parameters only."""

    @staticmethod
    def forward(ctx, x, g, b, w, bias, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, g, b, w)
        return _forward(x, g, b, w, bias, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, g, b, w = ctx.saved_tensors
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        g2 = grad.reshape(-1, grad.shape[-1]).to(x.dtype)
        wc = w.to(x.dtype)
        xhat, rstd = ln_stats(x2, ctx.eps)
        y = (xhat * g + b).to(x.dtype)
        dw = mm_f32(g2.t(), y).to(x.dtype).to(w.dtype)
        dbias = grad.reshape(-1, grad.shape[-1]).float().sum(0)
        dy = mm_f32(g2, wc)
        dx, dg, db = ln_backward(dy, xhat, rstd, g, x.dtype)
        return dx.reshape(x.shape), dg, db, dw, dbias, None


class _LNMatmulTP(torch.autograd.Function):
    """K5 on this rank's column shard of a tensor-parallel ``w`` and
    ``bias`` (DTensors ``Shard(0)``), through the operator's rule; returns
    the ``[..., O]`` DTensor sharded on its last dim.  The backward is
    ``_LNMatmul``'s on the local shard, the partial ``dx``, ``dg`` and
    ``db`` summed over the model group."""

    @staticmethod
    def forward(ctx, x, g, b, w, bias, eps):
        from torch.distributed.tensor import DTensor, Shard

        mesh = w.device_mesh
        d = x.shape[-1]
        ctx.eps, ctx.mesh = eps, mesh
        ctx.save_for_backward(x, g, b, w, bias)
        out = ln_matmul_fwd(_tp.replicated(x.reshape(-1, d), mesh),
                            _tp.replicated(g, mesh), _tp.replicated(b, mesh),
                            w.to(x.dtype).contiguous(),
                            bias.to(x.dtype).float().contiguous(), eps)
        local = out.to_local()
        return DTensor.from_local(
            local.reshape(x.shape[:-1] + (local.shape[-1],)), mesh,
            [Shard(x.dim() - 1)], run_check=False)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, g, b, w, bias = ctx.saved_tensors
        wl = w.to_local()
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        gl = _tp.local_columns(grad, ctx.mesh).reshape(-1, wl.shape[0])
        g2 = gl.to(x.dtype)
        xhat, rstd = ln_stats(x2, ctx.eps)
        y = (xhat * g + b).to(x.dtype)
        dw = mm_f32(g2.t(), y).to(x.dtype).to(wl.dtype)
        dbias = gl.float().sum(0)
        dy = mm_f32(g2, wl.to(x.dtype))
        dx, dg, db = _tp.sum_over(ctx.mesh, list(
            ln_backward(dy, xhat, rstd, g, torch.float32)))
        return (dx.to(x.dtype).reshape(x.shape), dg, db, _tp.like(dw, w),
                _tp.like(dbias, bias), None)


def ln_matmul(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """``LayerNorm(x; g, b) @ wᵀ + bias`` with the LayerNorm fused into the
    matmul (K5).  ``x`` [..., D] in the compute dtype, ``w`` [O, D],
    ``bias`` [O] (rounded to the compute dtype), ``g``, ``b`` [D].  A
    tensor-parallel ``w`` and ``bias`` (DTensors ``Shard(0)``): K5 on this
    rank's column shard, the result a DTensor sharded on its last dim."""
    if _tp.is_dtensor(w):
        return _LNMatmulTP.apply(x, g, b, w, bias, eps)
    if needs_grad(x, g, b, w, bias):
        return _LNMatmul.apply(x, g, b, w, bias, eps)
    return _forward(x, g, b, w, bias, eps)
