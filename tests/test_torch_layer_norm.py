"""The port's fused LayerNorm (cosmos_tpu_torch.ops.experimental.layer_norm)
against cosmos_tpu's: K3's and K4's plain versions against the Pallas
kernels (interpret mode on the CPU), the fused and hybrid autograd paths
against JAX's custom VJPs, the ``supported`` predicate, and the routing of
``models.layers.LayerNorm`` under ``FUSED_LN`` and ``HYBRID_LN``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.ops.experimental import layer_norm as jln
from cosmos_tpu_torch.models import layers
from cosmos_tpu_torch.ops.experimental import layer_norm as tln

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# float32 on both sides: the row sums run in another order (XLA's and
# torch's CPU reductions over D = 256); measured differences ~1e-6 on
# outputs of magnitude ~4.  bf16 outputs: one bf16 ulp of |y| < 8 (a last
# float32 bit can move the rounding) plus 1% relative.
TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=3.2e-2, rtol=1e-2)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _data(dtype, seed=7, shape=(4, 37, 256)):
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    s = (rng.standard_normal(shape[-1]) + 1).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    # the same rounded values on both sides
    x = np.array(jnp.asarray(x, jd).astype(jnp.float32))
    g = np.array(jnp.asarray(g, jd).astype(jnp.float32))
    jax_in = (jnp.asarray(x, jd), jnp.asarray(s), jnp.asarray(b),
              jnp.asarray(g, jd))
    torch_in = (torch.from_numpy(x).to(td), torch.from_numpy(s),
                torch.from_numpy(b), torch.from_numpy(g).to(td))
    return jax_in, torch_in


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_fwd_reference_equals_pallas_fwd(dtype):
    """K3's plain version against ``_ln_fwd``: y, mean and rstd."""
    (jx, js, jb, _), (tx, ts, tb, _) = _data(dtype)
    jy, (_, _, jmean, jrstd) = jln._ln_fwd(jx, js, jb, 1e-5, True)
    ty, tmean, trstd = tln.layer_norm_fwd_reference(tx, ts, tb, 1e-5)
    assert ty.dtype == tx.dtype and tmean.dtype == torch.float32
    assert tuple(tmean.shape) == tuple(jmean.shape) == (4, 37, 1)
    np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dtype])
    # float32 statistics of the same rounded inputs: summation order only
    np.testing.assert_allclose(_np(tmean), _np(jmean), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(_np(trstd), _np(jrstd), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bwd_reference_equals_pallas_bwd(dtype):
    """K4's plain version against ``_ln_bwd`` on the same saved statistics:
    dx, dscale and dbias."""
    (jx, js, jb, jg), (tx, ts, _, tg) = _data(dtype, seed=3)
    _, res = jln._ln_fwd(jx, js, jb, 1e-5, True)
    jdx, jds, jdb = jln._ln_bwd(1e-5, True, res, jg)
    mean = torch.from_numpy(np.asarray(res[2]))
    rstd = torch.from_numpy(np.asarray(res[3]))
    tdx, tds, tdb = tln.layer_norm_bwd_reference(tx, ts, mean, rstd, tg)
    assert tdx.dtype == tx.dtype and tds.dtype == tdb.dtype == torch.float32
    np.testing.assert_allclose(_np(tdx), _np(jdx), **TOL[dtype])
    # float32 sums over 148 rows in another order; |dscale| ~ 50
    np.testing.assert_allclose(_np(tds), _np(jds), atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(_np(tdb), _np(jdb), atol=1e-4, rtol=1e-5)


def _grads_jax(fn, x, s, b):
    def loss(x, s, b):
        return jnp.sum(jnp.sin(fn(x, s, b, 1e-5, True).astype(jnp.float32)))
    return loss(x, s, b), jax.grad(loss, argnums=(0, 1, 2))(x, s, b)


def _grads_torch(fn, x, s, b):
    x, s, b = (t.clone().requires_grad_(True) for t in (x, s, b))
    loss = torch.sin(fn(x, s, b, 1e-5).float()).sum()
    loss.backward()
    return loss.item(), (x.grad, s.grad, b.grad)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["fused", "hybrid"])
def test_autograd_path_equals_jax(path, dtype):
    """``fused_layer_norm`` / ``hybrid_layer_norm`` (the CPU paths: the
    plain versions inside the autograd Functions) against JAX's custom
    VJPs: the loss and the gradient of x, scale and bias."""
    (jx, js, jb, _), (tx, ts, tb, _) = _data(dtype, seed=11)
    jfn = {"fused": jln.fused_layer_norm, "hybrid": jln.hybrid_layer_norm}
    tfn = {"fused": tln.fused_layer_norm, "hybrid": tln.hybrid_layer_norm}
    jloss, jgrads = _grads_jax(jfn[path], jx, js, jb)
    tloss, tgrads = _grads_torch(tfn[path], tx, ts, tb)
    assert tgrads[0].dtype == tx.dtype
    # a float32 sum of 37888 terms of either sign in two orders: ~1e-3
    # apart; bf16: a one-ulp difference in y moves sin(y) by < 0.032 in a
    # few of the terms
    np.testing.assert_allclose(tloss, float(jloss),
                               atol=1e-2 if dtype == "f32" else 1e-1)
    for name, got, want in zip(("dx", "dscale", "dbias"), tgrads, jgrads):
        scale = max(1.0, np.abs(_np(want)).max())
        # relative to the largest gradient: float32 sums over 148 rows, and
        # in bf16 one-ulp differences of y inside sin'(y)
        tol = 1e-5 if dtype == "f32" else 1e-2
        np.testing.assert_allclose(_np(got) / scale, _np(want) / scale,
                                   atol=tol, rtol=0, err_msg=name)


SHAPES = [
    ((4, 37, 256), "bf16"), ((4, 256), "bf16"), ((4, 37, 100), "bf16"),
    ((2, 8192, 768), "bf16"), ((3, 37, 256), "bf16"), ((128, 197, 768), "bf16"),
    ((384, 37, 768), "bf16"), ((288, 32, 512), "bf16"), ((64, 8, 512), "bf16"),
    ((128, 197, 768), "f32"), ((2, 1200, 768), "f32"), ((2, 1100, 768), "f32"),
]


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_supported_equals_jax(shape, dtype):
    jd, td = DTYPES[dtype]
    # the predicates read shapes and dtypes only: no data is allocated
    assert tln.supported(torch.empty(shape, dtype=td, device="meta")) == (
        jln.supported(jax.ShapeDtypeStruct(shape, jd)))


@pytest.mark.parametrize("toggle,target", [("FUSED_LN", "fused_layer_norm"),
                                           ("HYBRID_LN", "hybrid_layer_norm")])
def test_layer_norm_module_routing(monkeypatch, toggle, target):
    """With a toggle on, ``LayerNorm`` routes supported inputs to the fused
    path (FUSED_LN first, as in JAX) and the rest to the plain one, with
    the same outputs."""
    (_, _, _, _), (tx, ts, tb, _) = _data("f32", seed=5)
    ln = layers.LayerNorm(256)
    with torch.no_grad():
        ln.weight.copy_(ts)
        ln.bias.copy_(tb)
    plain = ln(tx).detach()
    calls = []
    real = getattr(tln, target)

    def spy(*args):
        calls.append(args[0].shape)
        return real(*args)

    monkeypatch.setattr(tln, target, spy)
    monkeypatch.setattr(layers, toggle, True)
    if toggle == "HYBRID_LN":
        monkeypatch.setattr(layers, "FUSED_LN", False)
    got = ln(tx)
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-6, rtol=1e-6)
    ln(tx[:3])       # odd batch: not supported, plain path
    ln(tx[0])        # 2-D: plain path
    assert calls == [tx.shape]


def test_layer_norm_wrappers_raise_off_the_cpu():
    """No fallback: a tensor on a device with no kernel (``meta`` here, as
    the tests have no card) raises instead of taking the plain version."""
    x = torch.zeros(2, 4, 128, device="meta")
    s = torch.zeros(128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm_fwd(x, s, s)
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm_bwd(x, s, s, s, x)
