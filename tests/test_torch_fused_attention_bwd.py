"""The port's packed-QKV attention backward (K2's plain version and the
autograd Function around K1/K2) against the JAX package's custom VJP, with
both of its Pallas backwards (the whole-slab ``_bwd_kernel`` and, with
``BWD_HEAD_GRID`` on, the head-grid ``_bwd_kernel_hg``) in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch versions; the CUDA
kernel K2 itself is held to its plain version on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmos_tpu.ops.fused_attention as jax_fa_mod
from cosmos_tpu.ops.fused_attention import fused_attention_qkv as jax_fa
from cosmos_tpu_torch.ops import build as kernel_build
from cosmos_tpu_torch.ops import fused_attention as fa

# float32: summation order only (measured <= 1.7e-6 on gradients of
# magnitude <= 5).  bfloat16: both sides round P, ds and the gradients to
# bf16; a logit that differs in its last float32 bit can move one of them
# across a bf16 boundary (measured <= 2e-3), so allow one bf16 ulp of
# gradients below 4 plus 1% relative, as for the forward
TOL = {"float32": dict(atol=2e-5, rtol=1e-5),
       "bfloat16": dict(atol=1.6e-2, rtol=1e-2)}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, l, heads, dh, seed):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((b, l, 3 * heads * dh)).astype(np.float32)
    dout = rng.standard_normal((b, l, heads * dh)).astype(np.float32)
    return qkv, dout


def _jax_vjp(qkv, dout, heads, causal, jdt):
    _, vjp = jax.vjp(lambda x: jax_fa(x, heads, causal, True),
                     jnp.asarray(qkv, jdt))
    return np.asarray(vjp(jnp.asarray(dout, jdt))[0].astype(jnp.float32))


@pytest.mark.parametrize("variant", ["slab", "head_grid"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [8, 37, 77, 197])
def test_backward_reference_matches_pallas(l, causal, dh, dtype, variant,
                                           monkeypatch):
    """K2's plain version against K2 (variant slab) and K2b (head_grid)."""
    monkeypatch.setattr(jax_fa_mod, "BWD_HEAD_GRID", variant == "head_grid")
    heads = 2
    jdt, tdt = DTYPES[dtype]
    qkv, dout = _inputs(2, l, heads, dh, seed=l + dh + int(causal))
    want = _jax_vjp(qkv, dout, heads, causal, jdt)
    got = fa.fused_attention_qkv_backward_reference(
        torch.from_numpy(qkv).to(tdt), torch.from_numpy(dout).to(tdt),
        heads, causal)
    assert got.dtype == tdt and got.shape == qkv.shape
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_backward_reference_is_the_gradient_in_float32(causal):
    """In float32 the custom VJP's formula is the exact gradient of the
    forward: it equals autograd through the plain forward."""
    qkv, dout = _inputs(3, 29, 2, 64, seed=5)
    x = torch.from_numpy(qkv).requires_grad_(True)
    fa.fused_attention_qkv_reference(x, 2, causal).backward(
        torch.from_numpy(dout))
    got = fa.fused_attention_qkv_backward_reference(
        torch.from_numpy(qkv), torch.from_numpy(dout), 2, causal)
    np.testing.assert_allclose(got.numpy(), x.grad.numpy(), atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_on_cpu(causal, dtype):
    """loss.backward() reaches qkv through the Function, its gradient is the
    plain backward exactly, and nothing is launched or built."""
    _, tdt = DTYPES[dtype]
    qkv, dout = _inputs(2, 21, 2, 64, seed=9)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_(True)
    g = torch.from_numpy(dout).to(tdt)
    before = (fa.launches, fa.launches_bwd)
    out = fa.fused_attention_qkv(x, 2, causal)
    assert out.grad_fn is not None
    assert torch.equal(out, fa.fused_attention_qkv_reference(x.detach(), 2,
                                                             causal))
    (out.float() * g.float()).sum().backward()
    want = fa.fused_attention_qkv_backward_reference(x.detach(), g, 2, causal)
    assert x.grad.dtype == tdt
    assert torch.equal(x.grad, want)
    assert (fa.launches, fa.launches_bwd) == before == (0, 0)
    assert kernel_build._loaded == {}


def test_autograd_function_takes_a_strided_gradient():
    qkv, dout = _inputs(3, 11, 2, 64, seed=10)
    x = torch.from_numpy(qkv).requires_grad_(True)
    g = torch.from_numpy(dout)
    # the transpose hands the backward a non-contiguous gradient
    out = fa.fused_attention_qkv(x, 2).transpose(0, 1)
    out.backward(g.transpose(0, 1))
    want = fa.fused_attention_qkv_backward_reference(x.detach(), g, 2)
    assert torch.equal(x.grad, want)


def test_nothing_saved_without_grad():
    qkv, _ = _inputs(2, 9, 2, 64, seed=11)
    x = torch.from_numpy(qkv).requires_grad_(True)
    with torch.no_grad():
        assert fa.fused_attention_qkv(x, 2).grad_fn is None
    with torch.inference_mode():
        assert fa.fused_attention_qkv(x.detach(), 2).grad_fn is None
    # a constant input needs no gradient, so no node either
    assert fa.fused_attention_qkv(x.detach(), 2).grad_fn is None
    out = fa.fused_attention_qkv(x, 2)
    (saved,) = out.grad_fn.saved_tensors
    assert saved.data_ptr() == x.data_ptr()


def test_backward_rejects_a_mismatched_gradient():
    qkv, _ = _inputs(2, 9, 2, 64, seed=12)
    with pytest.raises(ValueError, match="dout shape"):
        fa.fused_attention_qkv_backward(torch.from_numpy(qkv),
                                        torch.zeros(2, 9, 64), 2)


def test_backward_raises_on_a_device_without_kernel():
    # no silent fallback: only CPU tensors take the plain version
    x = torch.empty(2, 8, 3 * 128, device="meta")
    g = torch.empty(2, 8, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_attention_qkv_backward(x, g, 2)
