"""Port's layers (cosmos_tpu_torch.models.layers) against cosmos_tpu's, on
the same numpy inputs and weights, in float32 and bfloat16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models import layers as jl
from cosmos_tpu_torch.models import layers as tl

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32: summation order only.  bf16: both sides round to bf16 once at the
# end of the op (LayerNorm, activations) or after each matmul (Mlp); allow
# one bf16 ulp (2^-8 relative) plus a small absolute floor near zero, and
# two for the Mlp's two rounded matmuls
TOL = {"f32": dict(atol=1e-5, rtol=1e-5), "bf16": dict(atol=1e-2, rtol=8e-3)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().detach().numpy()
    return np.asarray(x, dtype=np.float32)


def _inputs(shape, seed, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale + offset).astype(np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_norm(dt):
    jdt, tdt = DTYPES[dt]
    # an offset mean makes the single-pass E[x^2]-E[x]^2 form matter
    x = _inputs((3, 7, 96), 0, scale=2.0, offset=0.5)
    scale, bias = _inputs((96,), 1), _inputs((96,), 2)
    want = jl.LayerNorm().apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}},
        jnp.asarray(x, jdt))
    ln = tl.LayerNorm(96)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["gelu", "gelu_tanh", "quick_gelu"])
def test_activations(name, dt):
    jdt, tdt = DTYPES[dt]
    x = _inputs((4, 257), 3, scale=3.0)
    want = jl.get_act_fn(name)(jnp.asarray(x, jdt))
    got = tl.get_act_fn(name)(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layer_scale(dt):
    jdt, tdt = DTYPES[dt]
    x = _inputs((2, 5, 64), 4)
    gamma = _inputs((64,), 5)
    want = jl.LayerScale().apply({"params": {"gamma": jnp.asarray(gamma)}},
                                 jnp.asarray(x, jdt))
    ls = tl.LayerScale(64)
    with torch.no_grad():
        ls.gamma.copy_(torch.from_numpy(gamma))
        got = ls(torch.from_numpy(x).to(tdt))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_mlp(dt):
    jdt, tdt = DTYPES[dt]
    d, hdim = 64, 256
    x = _inputs((2, 9, d), 6)
    k1, b1 = _inputs((d, hdim), 7, d ** -0.5), _inputs((hdim,), 8, 0.1)
    k2, b2 = _inputs((hdim, d), 9, hdim ** -0.5), _inputs((d,), 10, 0.1)
    params = {"c_fc": {"kernel": k1, "bias": b1},
              "c_proj": {"kernel": k2, "bias": b2}}
    want = jl.Mlp(hidden_dim=hdim, out_dim=d, dtype=jdt).apply(
        {"params": params}, jnp.asarray(x, jdt))
    mlp = tl.Mlp(d, hdim, dtype=tdt)
    with torch.no_grad():
        mlp.c_fc.weight.copy_(torch.from_numpy(k1.T))
        mlp.c_fc.bias.copy_(torch.from_numpy(b1))
        mlp.c_proj.weight.copy_(torch.from_numpy(k2.T))
        mlp.c_proj.bias.copy_(torch.from_numpy(b2))
        got = mlp(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    tol = TOL[dt] if dt == "f32" else dict(atol=2e-2, rtol=1.6e-2)
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_l2_normalize(dt):
    jdt, tdt = DTYPES[dt]
    x = _inputs((5, 33), 11, scale=4.0)
    x[0] = 0.0  # the eps clamp: a zero row stays zero, no NaN
    want = jl.l2_normalize(jnp.asarray(x, jdt))
    got = tl.l2_normalize(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and not torch.isnan(got).any()
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


def test_linear_casts_weights_to_compute_dtype():
    lin = tl.Linear(8, 4, dtype=torch.bfloat16)
    tl.lecun_normal_(lin.weight, torch.Generator().manual_seed(0))
    torch.nn.init.zeros_(lin.bias)
    assert lin.weight.dtype == torch.float32
    assert lin(torch.randn(2, 8)).dtype == torch.bfloat16
