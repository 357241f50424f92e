"""Fused transformer-MLP block, K6 (counterpart of
``cosmos_tpu/ops/experimental/mlp_block.py``).

``mlp_block(x, g, b, w1, b1, w2, b2, eps, act)`` computes
``c_proj(act(c_fc(LayerNorm(x; g, b))))`` over the last axis of ``x``
(compute dtype), with ``w1`` [HD, D] and ``w2`` [D, HD] in torch's
``[out, in]`` layout and ``g``, ``b``, ``b1``, ``b2`` float32:

- the normalised rows are rounded to the compute dtype before ``c_fc``;
- ``h = act(y·w1ᵀ + b1)`` in float32, rounded to the compute dtype before
  ``c_proj`` (``mlp_block.py:73-75``);
- ``b1`` and ``b2`` stay float32, as in the fused JAX kernel (the unfused
  ``Linear`` rounds its bias to the compute dtype);
- every product accumulates in float32; the result is cast to the compute
  dtype.  ``act`` is ``gelu``, ``gelu_tanh`` or ``quick_gelu``.

The backward is the JAX custom VJP (``mlp_block.py:139-188``) in plain
torch ops: the normalised rows and the hidden are recomputed from ``x``
(one extra ``c_fc`` product), the activation's derivative is autograd of
the activation at the float32 pre-activation (JAX's ``jax.vjp``), every
product in float32 from compute-dtype operands; the weight gradients stay
float32, as JAX's are for the float32 parameters it passes.

On a CUDA tensor the forward launches K6 (``csrc/mlp_block.cu``), built at
first use, or raises; on a CPU tensor it computes ``mlp_block_reference``,
the plain version the tests and ``chip_smoke.py`` hold the kernel to.  The
forward is the operator ``torch.ops.cosmos_tpu_torch.mlp_block_fwd`` (those
two implementations, a fake one and a FLOP formula).  The
``[R, HD]`` hidden never exists in device memory in the forward.  The TPU
kernel's VMEM budget (``_pick_row_block`` raises for ViT-B widths in
float32) has no counterpart: K6 takes any number of rows, at ``D`` 512 or
768 (the widths of the ported towers) and ``HD`` a multiple of 128
(``check_shapes``).

Under tensor parallelism a fused block passes ``c_fc`` column-parallel
(``w1``, ``b1`` DTensors ``Shard(0)``) and ``c_proj`` row-parallel (``w2``
``Shard(1)``, ``b2`` replicated): ``mlp_block`` then runs K6 through the
operator's DTensor rule on each rank's hidden shard, ``HD / tp`` wide, whose
output is a partial sum over the model group (``Partial``; the rule takes
``b2`` as a partial too, and the wrapper passes zeros there).  The partials,
each rounded to the compute dtype by K6, are summed over the model group
in float32 (one all-reduce) and ``b2`` is added once after the sum, where
JAX's row-parallel rule places it (``cosmos_tpu/parallel/tp.py:96-97``),
before the result is rounded.  The backward gives each rank its shards'
``dw1``/``db1``/``dw2`` and the whole ``db2``, and sums the partial ``dx``,
``dg`` and ``db`` in float32.  No rank builds a whole weight.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable
from torch.utils.flop_counter import register_flop_formula

from ..build import build_all, load_kernel_library
from . import _tp
from ._cuda import (DTYPE_CODES, check_cuda, check_device, needs_grad,
                    raise_on_error, stream)
from .ln_matmul import ln_backward, ln_stats, mm_f32

SOURCE = "mlp_block.cu"    # K6
# the kernel's tiles (csrc/mlp_block.cu): bfloat16 BM rows per cluster of
# two blocks, hidden chunks of HC (HCW per warpgroup), W1 k-slices of BK1 in
# a ring of S1, W2 k-slices of BK2 in a ring of S2; float32 F32_ROWS rows
# per block and chunks of F32_HC
BM, HC, HCW, BK1, BK2, S1, S2 = 64, 128, 32, 64, 32, 6, 2
F32_ROWS, F32_HC = 32, 64
WIDTHS = (512, 768)        # the D the kernel is compiled for
SMEM_LIMIT = 232448

_ACT_CODES = {"gelu": 0, "gelu_tanh": 1, "quick_gelu": 2}

# kernel launches by this process; chip_smoke.py zeroes and reads it
launches = 0


def _act_fn(name: str):
    # models.layers imports this module, so its activations are looked up
    # at call time (JAX's mlp_block imports them from models.layers too)
    from ...models.layers import get_act_fn
    return get_act_fn(name)


def mlp_block_reference(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        b2: torch.Tensor, eps: float = 1e-5,
                        act: str = "gelu") -> torch.Tensor:
    """Plain PyTorch version of K6: ``x2`` [R, D], ``w1`` [HD, D] and ``w2``
    [D, HD] in the compute dtype; ``g``, ``b``, ``b1``, ``b2`` float32."""
    xhat, _ = ln_stats(x2, eps)
    y = (xhat * g + b).to(x2.dtype)
    h = _act_fn(act)(mm_f32(y, w1.t()) + b1).to(x2.dtype)
    return (mm_f32(h, w2.t()) + b2).to(x2.dtype)


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of one block of K6 at width ``d``."""
    if dtype == torch.bfloat16:
        # normalised rows, two h buffers of the cluster's chunk, the W1 and
        # W2 rings, the barriers, and the slack that aligns the base
        return (BM * d * 2 + 2 * 4 * BM * HCW * 2 + S1 * 2 * HCW * BK1 * 2
                + S2 * (d // 2) * BK2 * 2 + (2 * S1 + 2 * S2 + 4) * 8 + 1024)
    return F32_ROWS * (d + 8 + F32_HC + 8) * 4


def check_shapes(x2: torch.Tensor, w1: torch.Tensor,
                 w2: torch.Tensor) -> None:
    """Raise unless K6 takes ``x2`` [R, D], ``w1`` [HD, D] and ``w2``
    [D, HD]: any R, D 512 or 768, HD a multiple of 128."""
    if x2.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"mlp_block: x {tuple(x2.shape)} and w1 "
                         f"{tuple(w1.shape)} are not [R, D] and [HD, D]")
    d, hd = x2.shape[1], w1.shape[0]
    if (d not in WIDTHS or hd % HC
            or smem_bytes(d, x2.dtype) > SMEM_LIMIT):
        raise ValueError(f"mlp_block: need D in {WIDTHS} and HD % {HC} == 0,"
                         f" got D={d} HD={hd}")
    for name, t, shape in (("w1", w1, (hd, d)), ("w2", w2, (d, hd))):
        if t.shape != shape:
            raise ValueError(f"mlp_block: {name} shape {tuple(t.shape)}, "
                             f"expected {shape}")


@functools.lru_cache(maxsize=None)
def _function():
    fn = load_kernel_library(SOURCE).cosmos_mlp_block_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile (or load) K6's library now."""
    build_all([SOURCE])
    _function()


def _fwd_cuda(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, eps: float, act: str) -> torch.Tensor:
    """The operator's CUDA implementation: K6."""
    global launches
    op = "mlp_block"
    if act not in _ACT_CODES:
        raise ValueError(f"{op}: unknown activation {act!r}")
    check_cuda(op, "x", x2)
    check_shapes(x2, w1, w2)
    r, d = x2.shape
    hd = w1.shape[0]
    for name, t in (("w1", w1), ("w2", w2)):
        check_cuda(op, name, t, x2.dtype, x2.device)
    for name, t, n in (("g", g, d), ("b", b, d), ("b1", b1, hd),
                       ("b2", b2, d)):
        if t.shape != (n,):
            raise ValueError(f"{op}: {name} shape {tuple(t.shape)}, "
                             f"expected ({n},)")
        check_cuda(op, name, t, torch.float32, x2.device)
    out = torch.empty_like(x2)
    if r:
        with torch.cuda.device(x2.device):
            rc = _function()(
                x2.data_ptr(), g.data_ptr(), b.data_ptr(), w1.data_ptr(),
                b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                r, d, hd, eps, DTYPE_CODES[x2.dtype], _ACT_CODES[act],
                stream(x2))
        raise_on_error(op, rc, f"R={r} D={d} HD={hd} dtype={x2.dtype} "
                               f"act={act}")
        launches += 1
    return out


# K6 as an operator of the cosmos_tpu_torch namespace: the plain version
# on the CPU, the kernel on CUDA, a fake implementation for torch.export
# and fake tensors, and a FLOP formula (its two products, 4·R·D·HD)
_LIB = torch.library.Library("cosmos_tpu_torch", "FRAGMENT")
_LIB.define("mlp_block_fwd(Tensor x2, Tensor g, Tensor b, Tensor w1, "
            "Tensor b1, Tensor w2, Tensor b2, float eps, str act) -> Tensor")
_LIB.impl("mlp_block_fwd",
          lambda x2, g, b, w1, b1, w2, b2, eps, act: mlp_block_reference(
              x2, g, b, w1, b1, w2, b2, eps, act), "CPU")
_LIB.impl("mlp_block_fwd", _fwd_cuda, "CUDA")


@torch.library.register_fake("cosmos_tpu_torch::mlp_block_fwd", lib=_LIB)
def _fwd_fake(x2, g, b, w1, b1, w2, b2, eps, act):
    return x2.new_empty(x2.shape)


@register_flop_formula(torch.ops.cosmos_tpu_torch.mlp_block_fwd)
def _fwd_flops(x2_shape, g_shape, b_shape, w1_shape, *args, out_shape=None,
               **kwargs) -> int:
    return 4 * x2_shape[0] * x2_shape[1] * w1_shape[0]


_FWD = torch.ops.cosmos_tpu_torch.mlp_block_fwd.default


def _hidden_sharding(x2, g, b, w1, b1, w2, b2, eps, act) -> list:
    """K6's DTensor strategies on one mesh dim: all replicated, or the
    hidden split (``w1``, ``b1`` ``Shard(0)``, ``w2`` ``Shard(1)``), whose
    output, like ``b2``, is a partial sum over the dim."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    r = Replicate()
    rules = [([r], [r] * 7 + [None, None])]
    if any(p.is_shard(0) for p in w1.placements):
        rules.append(([Partial()], [r, r, r, Shard(0), Shard(0), Shard(1),
                                    Partial(), None, None]))
    return rules


if torch.distributed.is_available():
    from torch.distributed.tensor.experimental import register_sharding

    register_sharding(_FWD)(_hidden_sharding)


def mlp_block_fwd(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                  w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                  b2: torch.Tensor, eps: float = 1e-5,
                  act: str = "gelu") -> torch.Tensor:
    """``[R, D]``: K6 on a CUDA tensor, the plain version on a CPU tensor
    (arguments as ``mlp_block_reference``)."""
    if act not in _ACT_CODES:
        raise ValueError(f"mlp_block: unknown activation {act!r}")
    check_device("mlp_block", x2)
    return _FWD(x2, g, b, w1, b1, w2, b2, eps, act)


def _forward(x, g, b, w1, b1, w2, b2, eps, act):
    d = x.shape[-1]
    out = mlp_block_fwd(x.reshape(-1, d).contiguous(), g.contiguous(),
                        b.contiguous(), w1.to(x.dtype).contiguous(),
                        b1.float().contiguous(), w2.to(x.dtype).contiguous(),
                        b2.float().contiguous(), eps, act)
    return out.reshape(x.shape)


class _MLPBlock(torch.autograd.Function):
    """K6 forward; JAX's custom VJP in plain torch ops.  Saves x and the
    parameters only."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, eps, act):
        ctx.eps, ctx.act = eps, act
        ctx.save_for_backward(x, g, b, w1, b1, w2)
        return _forward(x, g, b, w1, b1, w2, b2, eps, act)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, g, b, w1, b1, w2 = ctx.saved_tensors
        dt = x.dtype
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        g2 = grad.reshape(-1, d).to(dt)
        w1c, w2c = w1.to(dt), w2.to(dt)
        # recompute: normalised rows, pre-activation, activation
        xhat, rstd = ln_stats(x2, ctx.eps)
        y = (xhat * g + b).to(dt)
        h_pre = (mm_f32(y, w1c.t()) + b1).detach().requires_grad_(True)
        with torch.enable_grad():
            a_act = _act_fn(ctx.act)(h_pre)
        a = a_act.detach().to(dt)
        dw2 = mm_f32(g2.t(), a)
        db2 = grad.reshape(-1, d).float().sum(0)
        da = mm_f32(g2, w2c)
        (dh,) = torch.autograd.grad(a_act, h_pre, da)
        dhc = dh.to(dt)
        db1 = dh.sum(0)
        dw1 = mm_f32(dhc.t(), y)
        dy = mm_f32(dhc, w1c)
        dx, dg, db = ln_backward(dy, xhat, rstd, g, dt)
        return (dx.reshape(x.shape), dg, db, dw1.to(w1.dtype), db1,
                dw2.to(w2.dtype), db2, None, None)


class _MLPBlockTP(torch.autograd.Function):
    """K6 on this rank's hidden shard of tensor-parallel weights through
    the operator's rule; the partials summed over the model group in
    float32 and ``b2`` added once after the sum.  The backward is
    ``_MLPBlock``'s on the local shards, the partial ``dx``, ``dg`` and
    ``db`` summed over the model group."""

    @staticmethod
    def forward(ctx, x, g, b, w1, b1, w2, b2, eps, act):
        from torch.distributed.tensor import DTensor, Partial

        mesh = w1.device_mesh
        d = x.shape[-1]
        ctx.eps, ctx.act, ctx.mesh = eps, act, mesh
        ctx.save_for_backward(x, g, b, w1, b1, w2, b2)
        zeros = DTensor.from_local(
            torch.zeros(d, dtype=torch.float32, device=x.device), mesh,
            [Partial()], run_check=False)
        part = mlp_block_fwd(_tp.replicated(x.reshape(-1, d), mesh),
                             _tp.replicated(g, mesh), _tp.replicated(b, mesh),
                             w1.to(x.dtype).contiguous(),
                             b1.float().contiguous(),
                             w2.to(x.dtype).contiguous(), zeros, eps, act)
        (total,) = _tp.sum_over(mesh, [part.to_local().float()])
        return (total + _tp.local(b2).float()).to(x.dtype).reshape(x.shape)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, g, b, w1, b1, w2, b2 = ctx.saved_tensors
        w1l, b1l, w2l = w1.to_local(), _tp.local(b1), w2.to_local()
        dt = x.dtype
        d = x.shape[-1]
        x2 = x.reshape(-1, d)
        g2 = grad.reshape(-1, d).to(dt)
        w1c, w2c = w1l.to(dt), w2l.to(dt)
        xhat, rstd = ln_stats(x2, ctx.eps)
        y = (xhat * g + b).to(dt)
        h_pre = (mm_f32(y, w1c.t()) + b1l).detach().requires_grad_(True)
        with torch.enable_grad():
            a_act = _act_fn(ctx.act)(h_pre)
        a = a_act.detach().to(dt)
        dw2 = mm_f32(g2.t(), a)
        db2 = grad.reshape(-1, d).float().sum(0)
        (dh,) = torch.autograd.grad(a_act, h_pre, mm_f32(g2, w2c))
        dhc = dh.to(dt)
        dw1 = mm_f32(dhc.t(), y)
        dx, dg, db = _tp.sum_over(ctx.mesh, list(ln_backward(
            mm_f32(dhc, w1c), xhat, rstd, g, torch.float32)))
        return (dx.to(dt).reshape(x.shape), dg, db,
                _tp.like(dw1.to(w1l.dtype), w1), _tp.like(dh.sum(0), b1),
                _tp.like(dw2.to(w2l.dtype), w2), _tp.like(db2, b2), None,
                None)


def mlp_block(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
              w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, eps: float = 1e-5,
              act: str = "gelu") -> torch.Tensor:
    """``c_proj(act(c_fc(LayerNorm(x; g, b))))`` as one kernel (K6); the
    weights in torch's ``[out, in]`` layout.  Tensor-parallel weights
    (``w1`` a DTensor ``Shard(0)``): K6 on this rank's hidden shard, the
    partials summed over the model group."""
    if _tp.is_dtensor(w1):
        return _MLPBlockTP.apply(x, g, b, w1, b1, w2, b2, eps, act)
    if needs_grad(x, g, b, w1, b1, w2, b2):
        return _MLPBlock.apply(x, g, b, w1, b1, w2, b2, eps, act)
    return _forward(x, g, b, w1, b1, w2, b2, eps, act)
