"""K1–K6 as operators of the ``cosmos_tpu_torch`` namespace: ``opcheck`` on
each (schema, fake implementation against the CPU one, autograd
registration, AOT dispatch) with CPU inputs; the FLOP formulas against
torch's SDPA and matmul conventions; each operator's CPU implementation
against the JAX package's Pallas kernel in interpret mode at one shape;
and the remat policies' treatment of K1 against JAX's treatment of its
Pallas call (counted in the jaxpr of the gradient)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import (FlopCounterMode,
                                      sdpa_backward_flop_count,
                                      sdpa_flop_count)

from cosmos_tpu.models.transformer import Transformer as JaxTransformer
from cosmos_tpu.ops.experimental import layer_norm as jln
from cosmos_tpu.ops.experimental.ln_matmul import ln_matmul as jax_ln_matmul
from cosmos_tpu.ops.experimental.mlp_block import mlp_block as jax_mlp_block
from cosmos_tpu.ops.fused_attention import fused_attention_qkv as jax_fa
from cosmos_tpu_torch.models.transformer import Transformer
from cosmos_tpu_torch.ops.experimental import layer_norm as tln

OPS = torch.ops.cosmos_tpu_torch
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randn(*shape, dtype=torch.float32, seed=0, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) * scale + shift
    return torch.from_numpy(x).to(dtype)


def _k1_args(dtype, causal, b=2, l=9, heads=2, dh=64):
    return (_randn(b, l, 3 * heads * dh, dtype=dtype, seed=1), heads, causal)


def _k2_args(dtype, causal, b=2, l=9, heads=2, dh=64):
    return (_randn(b, l, 3 * heads * dh, dtype=dtype, seed=1),
            _randn(b, l, heads * dh, dtype=dtype, seed=2), heads, causal)


def _k3_args(dtype):
    return (_randn(2, 5, 256, dtype=dtype, seed=3, scale=3.0, shift=1.0),
            _randn(256, seed=4, shift=1.0), _randn(256, seed=5), 1e-5)


def _k4_args(dtype):
    x, s, b, _ = _k3_args(dtype)
    _, mean, rstd = tln.layer_norm_fwd_reference(x, s, b)
    return (x, s, mean.contiguous(), rstd.contiguous(),
            _randn(2, 5, 256, dtype=dtype, seed=6))


def _k5_args(dtype):
    return (_randn(24, 128, dtype=dtype, seed=7, scale=2.0),
            _randn(128, seed=8, shift=1.0), _randn(128, seed=9),
            _randn(384, 128, dtype=dtype, seed=10, scale=0.05),
            _randn(384, seed=11), 1e-5)


def _k6_args(dtype, act="gelu"):
    return (_randn(24, 128, dtype=dtype, seed=12, scale=2.0),
            _randn(128, seed=13, shift=1.0), _randn(128, seed=14),
            _randn(256, 128, dtype=dtype, seed=15, scale=0.05),
            _randn(256, seed=16),
            _randn(128, 256, dtype=dtype, seed=17, scale=0.05),
            _randn(128, seed=18), 1e-5, act)


CASES = {
    "K1": (OPS.fused_attention_fwd.default,
           [_k1_args(d, c) for d in DTYPES.values() for c in (False, True)]),
    "K2": (OPS.fused_attention_bwd.default,
           [_k2_args(d, c) for d in DTYPES.values() for c in (False, True)]),
    "K3": (OPS.layer_norm_fwd.default, [_k3_args(d) for d in DTYPES.values()]),
    "K4": (OPS.layer_norm_bwd.default, [_k4_args(d) for d in DTYPES.values()]),
    "K5": (OPS.ln_matmul_fwd.default, [_k5_args(d) for d in DTYPES.values()]),
    "K6": (OPS.mlp_block_fwd.default,
           [_k6_args(torch.bfloat16, a)
            for a in ("gelu", "gelu_tanh", "quick_gelu")]
           + [_k6_args(torch.float32)]),
}


@pytest.mark.parametrize("case", [(k, i) for k, (_, args) in CASES.items()
                                  for i in range(len(args))],
                         ids=lambda c: f"{c[0]}-{c[1]}")
def test_opcheck(case):
    name, i = case
    op, args = CASES[name]
    torch.library.opcheck(op, args[i])


def test_every_kernel_is_an_operator_of_the_namespace():
    for name in ("fused_attention_fwd", "fused_attention_bwd",
                 "layer_norm_fwd", "layer_norm_bwd", "ln_matmul_fwd",
                 "mlp_block_fwd"):
        op = getattr(OPS, name).default
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(
                op.name(), key), (name, key)


def _count(fn, *args):
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("causal", [False, True])
def test_attention_flops_are_sdpa_conventions(causal):
    """K1 counts as SDPA's forward, K2 as its backward (torch's own
    ``sdpa_flop_count`` and ``sdpa_backward_flop_count``): 4·B·L²·D and
    10·B·L²·D, the full L² when causal too.  The forward is what the plain
    path's two attention products count."""
    b, l, heads, dh = 3, 11, 2, 64
    shape = (b, heads, l, dh)
    qkv, _, _ = _k1_args(torch.float32, causal, b, l, heads, dh)
    fwd = _count(OPS.fused_attention_fwd, qkv, heads, causal)
    assert fwd == sdpa_flop_count(shape, shape, shape) == (
        4 * b * l * l * heads * dh)
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2)
               for t in qkv.split(heads * dh, -1))
    assert fwd == _count(lambda: torch.softmax(q @ k.transpose(-1, -2), -1)
                         @ v)
    assert _count(OPS.fused_attention_bwd,
                  *_k2_args(torch.float32, causal, b, l, heads, dh)) == (
        sdpa_backward_flop_count(shape, shape, shape, shape)) == (
        10 * b * l * l * heads * dh)


def test_matmul_flops_are_their_matmuls():
    """K5 counts its product, K6 its two, as ``F.linear`` counts them; K3
    and K4 none, as aten's LayerNorm."""
    x, g, b, w, bias, eps = _k5_args(torch.float32)
    assert _count(OPS.ln_matmul_fwd, x, g, b, w, bias, eps) == _count(
        F.linear, x, w, bias) == 2 * 24 * 128 * 384
    x, g, b, w1, b1, w2, b2, eps, act = _k6_args(torch.float32)
    assert _count(OPS.mlp_block_fwd, x, g, b, w1, b1, w2, b2, eps, act) == (
        _count(lambda: F.linear(F.linear(x, w1, b1), w2, b2))) == (
        4 * 24 * 128 * 256)
    assert _count(OPS.layer_norm_fwd, *_k3_args(torch.float32)) == 0
    assert _count(OPS.layer_norm_bwd, *_k4_args(torch.float32)) == 0
    assert _count(F.layer_norm, x, (128,)) == 0


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


# float32 on both sides; the tolerances of each kernel's own test file
# (tests/test_torch_{fused_attention,fused_attention_bwd,layer_norm,
# ln_matmul}.py): summation order only
def test_attention_operators_equal_pallas():
    qkv, heads, causal = _k1_args(torch.float32, True, l=37)
    want = jax_fa(jnp.asarray(qkv.numpy()), heads, causal, True)
    np.testing.assert_allclose(_np(OPS.fused_attention_fwd(qkv, heads,
                                                           causal)),
                               _np(want), atol=2e-5)
    qkv, dout, heads, causal = _k2_args(torch.float32, True, l=37)
    _, vjp = jax.vjp(lambda x: jax_fa(x, heads, causal, True),
                     jnp.asarray(qkv.numpy()))
    np.testing.assert_allclose(
        _np(OPS.fused_attention_bwd(qkv, dout, heads, causal)),
        _np(vjp(jnp.asarray(dout.numpy()))[0]), atol=2e-5, rtol=1e-5)


def test_layer_norm_operators_equal_pallas():
    x, s, b, eps = _k3_args(torch.float32)
    g = _randn(2, 5, 256, seed=6)
    jy, res = jln._ln_fwd(jnp.asarray(x.numpy()), jnp.asarray(s.numpy()),
                          jnp.asarray(b.numpy()), eps, True)
    y, stats = OPS.layer_norm_fwd(x, s, b, eps)
    np.testing.assert_allclose(_np(y), _np(jy), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(stats[0]), _np(res[2]), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(stats[1]), _np(res[3]), rtol=1e-5)
    jdx, jds, jdb = jln._ln_bwd(eps, True, res, jnp.asarray(g.numpy()))
    dx, dparams = OPS.layer_norm_bwd(x, s, stats[0], stats[1], g)
    np.testing.assert_allclose(_np(dx), _np(jdx), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(dparams[0]), _np(jds), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(_np(dparams[1]), _np(jdb), atol=1e-4,
                               rtol=1e-5)


def test_fused_projection_operators_equal_pallas():
    x, g, b, w, bias, eps = _k5_args(torch.float32)
    want = jax_ln_matmul(*(jnp.asarray(t.numpy()) for t in (x, g, b)),
                         jnp.asarray(w.numpy().T), jnp.asarray(bias.numpy()),
                         eps, True)
    out, stats = OPS.ln_matmul_fwd(x, g, b, w, bias, eps)
    np.testing.assert_allclose(_np(out), _np(want), atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(stats[:, 0], x.mean(-1))
    x, g, b, w1, b1, w2, b2, eps, act = _k6_args(torch.float32)
    want = jax_mlp_block(*(jnp.asarray(t.numpy()) for t in (x, g, b)),
                         jnp.asarray(w1.numpy().T), jnp.asarray(b1.numpy()),
                         jnp.asarray(w2.numpy().T), jnp.asarray(b2.numpy()),
                         eps, act, True)
    np.testing.assert_allclose(
        _np(OPS.mlp_block_fwd(x, g, b, w1, b1, w2, b2, eps, act)),
        _np(want), atol=1e-5, rtol=1e-5)


def _pallas_calls(jaxpr) -> int:
    n = 0
    for eqn in jaxpr.eqns:
        n += eqn.primitive.name == "pallas_call"
        for v in eqn.params.values():
            for sub in v if isinstance(v, (list, tuple)) else (v,):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    n += _pallas_calls(inner)
    return n


@pytest.mark.parametrize("remat,policy", [
    (False, ""), (True, ""), (True, "nothing_saveable"),
    (True, "dots_saveable"), (True, "dots_with_no_batch_dims_saveable"),
    (True, "everything_saveable")])
def test_remat_treats_k1_as_jax_treats_its_pallas_call(remat, policy):
    """The K1 runs of one gradient of a 2-block stack: JAX's Pallas calls
    in the gradient's jaxpr (2 forward and 2 backward without remat, a
    forward again per block under every policy but
    ``everything_saveable``) against the port's K1 operator calls plus
    its K2 calls."""
    x = np.random.default_rng(0).standard_normal((2, 8, 128)).astype(
        np.float32)
    jm = JaxTransformer(width=128, layers=2, num_heads=2, use_flash=True,
                        remat=remat, remat_policy=policy)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jaxpr = jax.make_jaxpr(jax.grad(
        lambda p: jm.apply(p, jnp.asarray(x)).sum()))(jp)
    want = _pallas_calls(jaxpr.jaxpr)

    counts = {"fwd": 0, "bwd": 0}

    class Count(torch.utils._python_dispatch.TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is OPS.fused_attention_fwd.default:
                counts["fwd"] += 1
            elif func is OPS.fused_attention_bwd.default:
                counts["bwd"] += 1
            return func(*args, **(kwargs or {}))

    model = Transformer(128, 2, 2, remat=remat, remat_policy=policy)
    xt = torch.from_numpy(x).requires_grad_(True)
    with Count():
        model(xt).sum().backward()
    assert counts["fwd"] + counts["bwd"] == want
    assert counts["bwd"] == 2
    assert counts["fwd"] == (2 if policy == "everything_saveable"
                             or not remat else 4)
