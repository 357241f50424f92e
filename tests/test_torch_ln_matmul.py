"""The port's fused LayerNorm -> matmul (K5, ops.experimental.ln_matmul) and
fused MLP block (K6, ops.experimental.mlp_block) against cosmos_tpu's: the
plain forwards (the CPU path of the kernel wrappers) against the Pallas
kernels in interpret mode, and every gradient of the port's autograd
Functions against JAX's custom VJPs, for the three activations.

Weights are made in torch's [out, in] layout and handed to JAX transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.ops.experimental.ln_matmul import ln_matmul as jax_ln_matmul
from cosmos_tpu.ops.experimental.mlp_block import mlp_block as jax_mlp_block
from cosmos_tpu_torch.ops.experimental import ln_matmul as tlm
from cosmos_tpu_torch.ops.experimental import mlp_block as tmb

ACTS = ["gelu", "gelu_tanh", "quick_gelu"]
D, HD, O = 128, 256, 384


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _params(seed, names_shapes):
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, scale, shift in names_shapes:
        out[name] = (rng.standard_normal(shape) * scale + shift).astype(
            np.float32)
    return out


def _lm_data(seed=0):
    return _params(seed, [("x", (3, 24, D), 2.0, 0.5), ("g", (D,), 1.0, 1.0),
                          ("b", (D,), 1.0, 0.0), ("w", (O, D), 0.05, 0.0),
                          ("bias", (O,), 1.0, 0.0)])


def _mb_data(seed=0):
    return _params(seed, [("x", (3, 16, D), 2.0, 0.5), ("g", (D,), 1.0, 1.0),
                          ("b", (D,), 1.0, 0.0), ("w1", (HD, D), 0.05, 0.0),
                          ("b1", (HD,), 1.0, 0.0), ("w2", (D, HD), 0.05, 0.0),
                          ("b2", (D,), 1.0, 0.0)])


def _jax_lm(x, g, b, w, bias):
    # the attention path: kernel and bias cast to the compute dtype
    return jax_ln_matmul(x, g, b, w.T.astype(x.dtype), bias.astype(x.dtype),
                         1e-5, True)


def _jax_mb(act):
    def f(x, g, b, w1, b1, w2, b2):
        return jax_mlp_block(x, g, b, w1.T, b1, w2.T, b2, 1e-5, act, True)
    return f


def _torch_mb(act):
    def f(x, g, b, w1, b1, w2, b2):
        return tmb.mlp_block(x, g, b, w1, b1, w2, b2, 1e-5, act)
    return f


def _compare_grads(jfn, tfn, data, names, atol, rtol):
    """Loss sum(sin(out)) through both; the loss and every gradient."""
    jargs = [jnp.asarray(data[n]) for n in names]
    jloss, jgrads = jax.value_and_grad(
        lambda *a: jnp.sum(jnp.sin(jfn(*a))), argnums=tuple(range(len(names))))(
        *jargs)
    targs = [torch.from_numpy(data[n]).requires_grad_(True) for n in names]
    tloss = torch.sin(tfn(*targs)).sum()
    tloss.backward()
    # float32 sums of ~10^4 terms of either sign in two orders
    np.testing.assert_allclose(tloss.item(), float(jloss), atol=2e-3)
    for n, t, jg in zip(names, targs, jgrads):
        want = _np(jg)
        got = _np(t.grad)
        if want.shape != got.shape:      # a weight: JAX's [in, out]
            want = want.T
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol,
                                   err_msg=n)


def test_ln_matmul_forward_equals_jax_f32():
    d = _lm_data(1)
    want = _jax_lm(*(jnp.asarray(d[n]) for n in ("x", "g", "b", "w", "bias")))
    got = tlm.ln_matmul(*(torch.from_numpy(d[n])
                          for n in ("x", "g", "b", "w", "bias")))
    assert got.shape == (3, 24, O)
    # float32 dots over D = 128 in two orders
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


def test_ln_matmul_forward_equals_jax_bf16():
    """bfloat16: x, the normalised rows and w rounded, the bias rounded and
    added in float32, the output rounded."""
    d = _lm_data(2)
    x = jnp.asarray(d["x"], jnp.bfloat16)
    want = _jax_lm(x, *(jnp.asarray(d[n]) for n in ("g", "b", "w", "bias")))
    got = tlm.ln_matmul(torch.from_numpy(np.array(x.astype(jnp.float32)))
                        .to(torch.bfloat16),
                        *(torch.from_numpy(d[n])
                          for n in ("g", "b", "w", "bias")))
    assert got.dtype == torch.bfloat16
    # a last-bit float32 difference can move one rounding of y or of the
    # output: one bf16 ulp of |o| < 8 plus 1% relative
    np.testing.assert_allclose(_np(got), _np(want), atol=3.2e-2, rtol=1e-2)


def test_ln_matmul_gradients_equal_jax():
    """dx, dg, db, dw and dbias of the autograd Function (JAX's _bwd in
    plain torch) against jax.grad through the custom VJP."""
    names = ("x", "g", "b", "w", "bias")
    # float32 on both sides; gradients up to ~20, summed over 72 rows
    _compare_grads(_jax_lm, tlm.ln_matmul, _lm_data(3), names,
                   atol=2e-4, rtol=1e-4)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_block_forward_equals_jax(act):
    d = _mb_data(4)
    names = ("x", "g", "b", "w1", "b1", "w2", "b2")
    want = _jax_mb(act)(*(jnp.asarray(d[n]) for n in names))
    got = _torch_mb(act)(*(torch.from_numpy(d[n]) for n in names))
    assert got.shape == (3, 16, D)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_block_forward_equals_jax_bf16(act):
    d = _mb_data(5)
    x = jnp.asarray(d["x"], jnp.bfloat16)
    rest = ("g", "b", "w1", "b1", "w2", "b2")
    want = _jax_mb(act)(x, *(jnp.asarray(d[n]) for n in rest))
    got = _torch_mb(act)(
        torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16),
        *(torch.from_numpy(d[n]) for n in rest))
    assert got.dtype == torch.bfloat16
    # one-ulp moves of y, h and the output (see the K5 case)
    np.testing.assert_allclose(_np(got), _np(want), atol=3.2e-2, rtol=1e-2)


@pytest.mark.parametrize("act", ACTS)
def test_mlp_block_gradients_equal_jax(act):
    """Every gradient of the autograd Function (the hidden recomputed, the
    activation's derivative by autograd) against JAX's custom VJP."""
    names = ("x", "g", "b", "w1", "b1", "w2", "b2")
    _compare_grads(_jax_mb(act), _torch_mb(act), _mb_data(6), names,
                   atol=2e-4, rtol=1e-4)


def test_wrappers_raise_off_the_cpu():
    """No fallback: a tensor on a device with no kernel (``meta``) raises
    instead of taking the plain version."""
    x = torch.zeros(8, D, device="meta")
    v = torch.zeros(D, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tlm.ln_matmul_fwd(x, v, v, torch.zeros(O, D, device="meta"),
                          torch.zeros(O, device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tmb.mlp_block_fwd(x, v, v, torch.zeros(HD, D, device="meta"),
                          torch.zeros(HD, device="meta"),
                          torch.zeros(D, HD, device="meta"), v)
