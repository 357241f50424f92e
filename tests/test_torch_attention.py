"""Port's attention modules (cosmos_tpu_torch.models.attention) against
cosmos_tpu's: self-attention through the packed-QKV kernel path (JAX side
use_flash=True, the Pallas kernel in interpret mode), and cross-attention
with add_zero_attn, the cross pooler, additive masks and head dims the
kernel does not take through the XLA-path semantics."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models import attention as ja
from cosmos_tpu_torch.models import attention as ta
from cosmos_tpu_torch.ops import fused_attention as fa

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32: summation order only.  bf16: the in-projection, logits (XLA path),
# P and the out-projection each round to bf16, so outputs of magnitude
# ~1 may differ by a few bf16 ulps (2^-8 relative each)
TOL = {"f32": dict(atol=2e-5, rtol=1e-5), "bf16": dict(atol=3e-2, rtol=2e-2)}


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _mha_params(d, seed):
    return {
        "in_proj_kernel": _rand((d, 3 * d), seed, d ** -0.5),
        "in_proj_bias": _rand((3 * d,), seed + 1, 0.1),
        "out_proj": {"kernel": _rand((d, d), seed + 2, d ** -0.5),
                     "bias": _rand((d,), seed + 3, 0.1)},
    }


def _load_mha(mod, p):
    with torch.no_grad():
        mod.in_proj_weight.copy_(torch.from_numpy(p["in_proj_kernel"].T))
        mod.in_proj_bias.copy_(torch.from_numpy(p["in_proj_bias"]))
        mod.out_proj.weight.copy_(torch.from_numpy(p["out_proj"]["kernel"].T))
        mod.out_proj.bias.copy_(torch.from_numpy(p["out_proj"]["bias"]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("l,causal", [(37, False), (77, True)])
def test_self_attention_kernel_path(l, causal, dt):
    jdt, tdt = DTYPES[dt]
    d, heads = 128, 2
    p = _mha_params(d, 0)
    x = _rand((2, l, d), 10)
    want = ja.MultiheadAttention(num_heads=heads, dtype=jdt,
                                 use_flash=True).apply(
        {"params": p}, jnp.asarray(x, jdt), causal=causal)
    mod = ta.MultiheadAttention(d, heads, dtype=tdt)
    _load_mha(mod, p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(tdt), causal=causal)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


def test_self_attention_routes_to_the_kernel_wrapper(monkeypatch):
    calls = []
    real = ta.fused_attention_qkv

    def spy(qkv, heads, causal):
        calls.append((tuple(qkv.shape), heads, causal))
        return real(qkv, heads, causal)

    monkeypatch.setattr(ta, "fused_attention_qkv", spy)
    mod = ta.MultiheadAttention(128, 2)
    _load_mha(mod, _mha_params(128, 1))
    with torch.no_grad():
        mod(torch.randn(3, 5, 128), causal=True)            # kernel path
        mod(torch.randn(3, 5, 128), kv=torch.randn(3, 4, 128))  # cross
        mod(torch.randn(3, 5, 128), mask=torch.zeros(5, 5))     # masked
        ta.MultiheadAttention(128, 8)(torch.randn(1, 4, 128))   # Dh = 16
    assert calls == [((3, 5, 384), 2, True)]
    assert fa.launches == 0


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True])
def test_self_attention_unsupported_head_dim_uses_xla_semantics(causal, dt):
    # Dh = 16: the JAX package falls back to the XLA path (bf16 logits)
    jdt, tdt = DTYPES[dt]
    d, heads = 64, 4
    p = _mha_params(d, 20)
    x = _rand((2, 9, d), 21)
    want = ja.MultiheadAttention(num_heads=heads, dtype=jdt,
                                 use_flash=True).apply(
        {"params": p}, jnp.asarray(x, jdt), causal=causal)
    mod = ta.MultiheadAttention(d, heads, dtype=tdt)
    _load_mha(mod, p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(tdt), causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("add_zero_attn", [False, True])
def test_cross_attention(add_zero_attn, dt):
    jdt, tdt = DTYPES[dt]
    d, heads = 64, 8
    p = _mha_params(d, 30)
    x, kv = _rand((3, 4, d), 31), _rand((3, 11, d), 32)
    want = ja.MultiheadAttention(num_heads=heads, add_zero_attn=add_zero_attn,
                                 dtype=jdt).apply(
        {"params": p}, jnp.asarray(x, jdt), kv=jnp.asarray(kv, jdt))
    mod = ta.MultiheadAttention(d, heads, add_zero_attn=add_zero_attn,
                                dtype=tdt)
    _load_mha(mod, p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x).to(tdt), kv=torch.from_numpy(kv).to(tdt))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])


@pytest.mark.parametrize("add_zero_attn", [False, True])
def test_additive_mask(add_zero_attn):
    d, heads, l = 64, 4, 6
    p = _mha_params(d, 40)
    x = _rand((2, l, d), 41)
    mask = np.where(_rand((l, l), 42) > 0.3, -1e9, 0.0).astype(np.float32)
    np.fill_diagonal(mask, 0.0)
    want = ja.MultiheadAttention(num_heads=heads,
                                 add_zero_attn=add_zero_attn).apply(
        {"params": p}, jnp.asarray(x), mask=jnp.asarray(mask))
    mod = ta.MultiheadAttention(d, heads, add_zero_attn=add_zero_attn)
    _load_mha(mod, p)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), mask=torch.from_numpy(mask))
    np.testing.assert_allclose(_np(got), _np(want), **TOL["f32"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_attentional_cross_pooler(dt):
    jdt, tdt = DTYPES[dt]
    d, heads = 64, 8
    p = _mha_params(d, 50)
    ln = {n: {"scale": 1.0 + _rand((d,), 51 + i, 0.1),
              "bias": _rand((d,), 53 + i, 0.1)}
          for i, n in enumerate(("ln_q", "ln_k"))}
    ctx, q = _rand((2, 17, d), 55), _rand((2, 3, d), 56)
    want = ja.AttentionalCrossPooler(num_heads=heads, add_zero_attn=True,
                                     dtype=jdt).apply(
        {"params": {"attn": p, **ln}}, jnp.asarray(ctx, jdt),
        jnp.asarray(q, jdt))
    pool = ta.AttentionalCrossPooler(d, heads, add_zero_attn=True, dtype=tdt)
    _load_mha(pool.attn, p)
    with torch.no_grad():
        for n in ("ln_q", "ln_k"):
            getattr(pool, n).weight.copy_(torch.from_numpy(ln[n]["scale"]))
            getattr(pool, n).bias.copy_(torch.from_numpy(ln[n]["bias"]))
        got = pool(torch.from_numpy(ctx).to(tdt), torch.from_numpy(q).to(tdt))
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dt])
