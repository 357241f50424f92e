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
``ops/build.py``), or raise; there is no fallback.  Both hold a warp's
rows in registers, the next row loaded while this one is reduced; how
many rows each block owns, how many blocks, and the shared memory are
``launch_geometry(R, D, dtype)``, a function of the shapes alone.  The
launch path is lean: one combined validity test (the detailed errors are
built only when it fails), no device switch when the input lies on the
current device, the arguments packed into one buffer, one allocation for
the statistics and one for K4's workspace and parameter gradients.  On a
CPU tensor they
compute the same functions with ``layer_norm_fwd_reference`` and
``layer_norm_bwd_reference``, the plain versions that the tests and
``chip_smoke.py`` hold the kernels to.  Both are operators of the
``cosmos_tpu_torch`` namespace (``torch.ops.cosmos_tpu_torch.layer_norm_fwd``,
``layer_norm_bwd``), with those two implementations, a fake one and a FLOP
formula; ``layer_norm_fwd``/``layer_norm_bwd`` here call them.

``supported(x)`` is a copy of the JAX package's predicate, so that the same
LayerNorms take the fused path in both packages.  Its 12 MiB working-set
rule is a TPU VMEM budget; the CUDA kernels have no such limit, but the
predicate is kept so that the routing matches.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple, Tuple

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from ..build import build_all, load_kernel_library
from ._cuda import (DTYPE_CODES, call_on, check_cuda, check_device,
                    needs_grad, raise_on_error)

SOURCE = "layer_norm_fwd.cu"       # K3
SOURCE_BWD = "layer_norm_bwd.cu"   # K4
_VMEM_BUDGET = 12 * 1024 * 1024
_F32 = torch.float32
# the kernels' partition (csrc/layer_norm_{fwd,bwd}.cu): blocks of 8 warps
# own whole tiles of TILE_ROWS rows, one row a warp, at most MAX_BLOCKS
# blocks (two on each of the H100's 132 SMs)
TILE_ROWS = 8
MAX_BLOCKS = 264
MAX_D_REGS = 1024        # K3 holds rows, K4 rows and column sums, in registers
SMEM_LIMIT = 232448      # bytes of shared memory a block can have
# the general paths: K3 a warp per row, GEN_ROWS_FWD rows a block; K4
# GEN_WARPS_BWD warps' float32 column sums, 2·D each, in shared memory
# (229,376 bytes at the widest D)
GEN_ROWS_FWD = 8
GEN_WARPS_BWD = 4
GEN_MAX_BLOCKS_BWD = 1024
MAX_D_BWD = 7168

# a launch's arguments as csrc/layer_norm_fwd.cu's LnFwdArgs and
# layer_norm_bwd.cu's LnBwdArgs lay them out (8-byte pointers, int64 R,
# 4-byte ints and float, padding before the stream)
_FWD_ARGS = struct.Struct("=6Qqif3i4xQ")
_BWD_ARGS = struct.Struct("=8Qq5i4xQ")

# kernel launches by this process (K3; K4 counted once per call of its two
# passes); chip_smoke.py zeroes and reads them
launches = 0
launches_bwd = 0


class Geometry(NamedTuple):
    """A launch of K3 or K4: each of ``blocks`` blocks owns
    ``rows_per_block`` consecutive rows, with ``smem`` bytes of dynamic
    shared memory."""
    rows_per_block: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=1024)
def launch_geometry(r: int, d: int, dtype: torch.dtype,
                    backward: bool = False) -> Geometry:
    """K3's (or with ``backward`` K4's) launch for ``r`` rows of width ``d``
    in ``dtype``: a function of these alone, never of the card, so the
    partition of rows, and with it the order of K4's column sums, is the
    same on every launch.  Up to ``MAX_D_REGS`` both kernels hand each of
    at most ``MAX_BLOCKS`` blocks whole tiles of ``TILE_ROWS`` rows; K4's
    blocks add their warps' column sums in ``64 * d`` bytes of shared
    memory.  Wider rows take the general paths.  ``dtype`` is part of the
    key, though no choice depends on it yet."""
    if d <= MAX_D_REGS:
        rows = TILE_ROWS * max(1, -(-(-(-r // TILE_ROWS)) // MAX_BLOCKS))
        return Geometry(rows, -(-r // rows), 64 * d if backward else 0)
    if backward:
        rows = max(GEN_WARPS_BWD, -(-r // GEN_MAX_BLOCKS_BWD))
        return Geometry(rows, -(-r // rows), GEN_WARPS_BWD * 2 * d * 4)
    return Geometry(GEN_ROWS_FWD, -(-r // GEN_ROWS_FWD), 0)


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
    fn.argtypes = [ctypes.c_char_p]        # a packed LnFwdArgs
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _function_bwd():
    fn = load_kernel_library(SOURCE_BWD).cosmos_layer_norm_bwd
    fn.argtypes = [ctypes.c_char_p]        # a packed LnBwdArgs
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) K3's and K4's libraries now, in parallel."""
    build_all([SOURCE, SOURCE_BWD])
    _function()
    _function_bwd()


def _check_params(op: str, x: torch.Tensor, *params: torch.Tensor) -> int:
    if x.dim() < 1 or x.shape[-1] % 8 or not x.shape[-1]:
        raise ValueError(f"{op}: need a last axis that is a positive "
                         f"multiple of 8, got shape {tuple(x.shape)}")
    d = x.shape[-1]
    check_cuda(op, "x", x)
    for i, p in enumerate(params):
        if p.shape != (d,):
            raise ValueError(f"{op}: parameter {i} has shape "
                             f"{tuple(p.shape)}, expected ({d},)")
        check_cuda(op, f"parameter {i}", p, _F32, x.device)
    return d


def _params_ok(d: int, dev: torch.device, *params: torch.Tensor) -> bool:
    return all(p.device == dev and p.dtype is _F32 and p.shape == (d,)
               and p.is_contiguous() and not p.data_ptr() % 16
               for p in params)


def _fwd_errors(op, x, scale, bias):
    """Raise the error that the first failed check of ``layer_norm_fwd``
    gives."""
    _check_params(op, x, scale, bias)
    raise AssertionError(f"{op}: the fast check failed, the detailed "
                         "checks passed")


def _fwd_cuda(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: K3.  ``(y, stats)``, the float32
    ``[2, ..., 1]`` mean and rstd in one allocation."""
    global launches
    dev = x.device
    op = "fused_layer_norm"
    if not x.is_contiguous():
        x = x.contiguous()
    shape = x.shape
    d = shape[-1] if shape else 0
    code = DTYPE_CODES.get(x.dtype)
    if (dev.type != "cuda" or code is None or not d or d % 8
            or x.data_ptr() % 16 or not _params_ok(d, dev, scale, bias)):
        _fwd_errors(op, x, scale, bias)
    r = x.numel() // d
    y = torch.empty_like(x)
    stats = torch.empty((2,) + shape[:-1] + (1,), dtype=_F32, device=dev)
    if r:
        m = stats.data_ptr()
        geo = launch_geometry(r, d, x.dtype)
        rc = call_on(dev, _function(), _FWD_ARGS.pack, x.data_ptr(),
                     scale.data_ptr(), bias.data_ptr(), y.data_ptr(), m,
                     m + 4 * r, r, d, eps, code, geo.rows_per_block,
                     geo.blocks)
        if rc:
            raise_on_error(op, rc, f"R={r} D={d} dtype={x.dtype}")
        launches += 1
    return y, stats


def _bwd_errors(op, x, scale, mean, rstd, g):
    """Raise the error that the first failed check of ``layer_norm_bwd``
    gives."""
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"{op}: gradient {tuple(g.shape)} {g.dtype}, "
                         f"expected {tuple(x.shape)} {x.dtype}")
    d = _check_params(op, x, scale)
    if d > MAX_D_BWD:
        raise ValueError(f"{op}: D={d} above the kernel's {MAX_D_BWD}")
    check_cuda(op, "gradient", g, x.dtype, x.device)
    r = x.numel() // d
    for name, t in (("mean", mean), ("rstd", rstd)):
        # read one float a row: natural alignment
        check_cuda(op, name, t, _F32, x.device, align=4)
        if t.numel() != r:
            raise ValueError(f"{op}: {name} has {t.numel()} rows, x {r}")
    raise AssertionError(f"{op}: the fast check failed, the detailed "
                         "checks passed")


def _bwd_cuda(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
              rstd: torch.Tensor, g: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's CUDA implementation: K4.  ``(dx, dparams)``, the
    float32 ``[2, D]`` dscale and dbias at the head of K4's workspace."""
    global launches_bwd
    dev = x.device
    op = "fused_layer_norm backward"
    # autograd may hand over a strided gradient; K4 reads rows densely
    if not x.is_contiguous():
        x = x.contiguous()
    if not g.is_contiguous():
        g = g.contiguous()
    shape = x.shape
    d = shape[-1] if shape else 0
    code = DTYPE_CODES.get(x.dtype)
    r = x.numel() // d if d else 0
    if (dev.type != "cuda" or code is None or not d or d % 8 or d > MAX_D_BWD
            or g.device != dev or g.dtype is not x.dtype or g.shape != shape
            or (x.data_ptr() | g.data_ptr()) % 16
            or not _params_ok(d, dev, scale)
            or not all(t.device == dev and t.dtype is _F32
                       and t.numel() == r and t.is_contiguous()
                       and not t.data_ptr() % 4 for t in (mean, rstd))):
        _bwd_errors(op, x, scale, mean, rstd, g)
    dx = torch.empty_like(x)
    geo = launch_geometry(r, d, x.dtype, True)
    # dscale, dbias and the blocks' partial rows [2][blocks][D]: one
    # allocation, every element written by K4
    work = torch.empty(2 * d * (1 + geo.blocks), dtype=_F32, device=dev)
    dparams, partial = work.split([2 * d, 2 * d * geo.blocks])
    if r:
        rc = call_on(dev, _function_bwd(), _BWD_ARGS.pack, x.data_ptr(),
                     g.data_ptr(), scale.data_ptr(), mean.data_ptr(),
                     rstd.data_ptr(), dx.data_ptr(), partial.data_ptr(),
                     dparams.data_ptr(), r, d, code, *geo)
        if rc:
            raise_on_error(op, rc, f"R={r} D={d} dtype={x.dtype}")
        launches_bwd += 1
    else:
        dparams.zero_()
    return dx, dparams.view(2, d)


def _fwd_cpu(x, scale, bias, eps):
    y, mean, rstd = layer_norm_fwd_reference(x, scale, bias, eps)
    return y.contiguous(), torch.stack([mean, rstd])


def _bwd_cpu(x, scale, mean, rstd, g):
    dx, ds, db = layer_norm_bwd_reference(x, scale, mean, rstd, g)
    return dx.contiguous(), torch.stack([ds, db])


# K3 and K4 as operators of the cosmos_tpu_torch namespace: the plain
# versions on the CPU, the kernels on CUDA, fake implementations for
# torch.export and fake tensors, and FLOP formulas (a LayerNorm has no
# matmul: 0, as FlopCounterMode counts aten's).  Each returns its float32
# pair (mean and rstd, dscale and dbias) as one tensor, which the wrappers
# split into views: one allocation, and no outputs that alias.
_LIB = torch.library.Library("cosmos_tpu_torch", "FRAGMENT")
_LIB.define("layer_norm_fwd(Tensor x, Tensor scale, Tensor bias, float eps)"
            " -> (Tensor, Tensor)")
_LIB.define("layer_norm_bwd(Tensor x, Tensor scale, Tensor mean, "
            "Tensor rstd, Tensor g) -> (Tensor, Tensor)")
_LIB.impl("layer_norm_fwd", _fwd_cpu, "CPU")
_LIB.impl("layer_norm_fwd", _fwd_cuda, "CUDA")
_LIB.impl("layer_norm_bwd", _bwd_cpu, "CPU")
_LIB.impl("layer_norm_bwd", _bwd_cuda, "CUDA")


@torch.library.register_fake("cosmos_tpu_torch::layer_norm_fwd", lib=_LIB)
def _fwd_fake(x, scale, bias, eps):
    return (x.new_empty(x.shape),
            x.new_empty((2,) + x.shape[:-1] + (1,), dtype=_F32))


@torch.library.register_fake("cosmos_tpu_torch::layer_norm_bwd", lib=_LIB)
def _bwd_fake(x, scale, mean, rstd, g):
    return x.new_empty(x.shape), x.new_empty((2, x.shape[-1]), dtype=_F32)


@register_flop_formula([torch.ops.cosmos_tpu_torch.layer_norm_fwd,
                        torch.ops.cosmos_tpu_torch.layer_norm_bwd])
def _no_matmul_flops(*args, **kwargs) -> int:
    return 0


_FWD = torch.ops.cosmos_tpu_torch.layer_norm_fwd.default
_BWD = torch.ops.cosmos_tpu_torch.layer_norm_bwd.default


def layer_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                   eps: float = 1e-5
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(y, mean, rstd)``: K3 on a CUDA tensor, the plain version on a CPU
    tensor.  ``mean`` and ``rstd`` are two views of one allocation."""
    check_device("fused_layer_norm", x)
    y, stats = _FWD(x, scale, bias, eps)
    mean, rstd = stats.unbind(0)
    return y, mean, rstd


def layer_norm_bwd(x: torch.Tensor, scale: torch.Tensor, mean: torch.Tensor,
                   rstd: torch.Tensor, g: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dx, dscale, dbias)``: K4 on a CUDA tensor, the plain version on a
    CPU tensor.  ``dscale`` and ``dbias`` are views of one allocation."""
    check_device("fused_layer_norm backward", x, g)
    dx, dparams = _BWD(x, scale, mean, rstd, g)
    ds, db = dparams.unbind(0)
    return dx, ds, db


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
