"""The port's int8 weight ops (cosmos_tpu_torch.ops.int8) against
cosmos_tpu.ops.int8 on the same numpy-seeded inputs.

A Linear weight is torch's [N, K] where JAX's kernel is [K, N]: the port's
int8 bits are JAX's transposed and its scales JAX's, bit for bit.  The
product on the CPU is the exact int32 product, so int8_matmul equals
JAX's exactly.  Over a COSMOS model's state dict, quantize/dequantize and
quantized_bytes equal JAX's over its parameter tree, key for key through
the bridge's name map.  JAX's functions run eagerly, as its export
utilities do: under jax.jit XLA fuses the scale's division into the
quantization and a few elements move by one step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.ops import int8 as jint8
from cosmos_tpu_torch.models.convert import (build_name_map,
                                             state_dict_from_jax_params,
                                             vision_entries)
from cosmos_tpu_torch.ops import int8 as pint8
from test_torch_checkpoint_load import COSMOS, jax_random


def _rand(shape, seed, zero_col=None):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    if zero_col is not None:
        w[:, zero_col] = 0.0
    return w


@pytest.mark.parametrize("k,n", [(64, 96), (768, 3072), (5, 3)])
def test_quantize_weight_bits_and_scales(k, n):
    w = _rand((k, n), k + n, zero_col=1)          # JAX's [K, N] kernel
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    pq, ps = pint8.quantize_weight(torch.from_numpy(w.T.copy()))
    assert pq.dtype == torch.int8
    np.testing.assert_array_equal(pq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_an_embedding_is_not_transposed():
    e = _rand((300, 32), 3)                        # [V, D], in both
    jq, js = jint8.quantize_weight(jnp.asarray(e))
    pq, ps = pint8.quantize_weight(torch.from_numpy(e), in_dim=0)
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


def test_quantize_activations():
    x = _rand((4, 7, 48), 5)
    jq, js = jint8.quantize_activations(jnp.asarray(x))
    pq, ps = pint8.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("m,k,n", [(20, 64, 48), (3, 40, 24), (197, 768, 96)])
def test_int8_matmul_equals_jax(m, k, n):
    x = _rand((2, m, k), m)
    w = _rand((k, n), n)
    jq, js = jint8.quantize_weight(jnp.asarray(w))
    want = jint8.int8_matmul(jnp.asarray(x), jq, js)
    pq, ps = pint8.quantize_weight(torch.from_numpy(w.T.copy()))
    got = pint8.int8_matmul(torch.from_numpy(x), pq, ps)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    xq, _ = pint8.quantize_activations(torch.from_numpy(x))
    exact = xq.reshape(-1, k).numpy().astype(np.int64) @ \
        pq.numpy().astype(np.int64).T
    np.testing.assert_array_equal(
        pint8._int_product(xq.reshape(-1, k), pq).numpy(), exact)


@pytest.fixture(scope="module")
def params():
    return jax_random("ViT-Tiny-Test", seed=8, **COSMOS)[1]


def _flax_path(params):
    """port key -> (flax path, transform) over the model's name map."""
    entries = build_name_map(2, 2) + vision_entries(params["visual"])
    return {k: (p, tf) for k, p, tf in entries}


def _at(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("min_size", [1024, 1 << 16])
def test_quantize_dense_params_over_the_state_dict(params, min_size):
    sd = state_dict_from_jax_params(params)
    jq = jint8.quantize_dense_params(params, min_size=min_size)
    pq = pint8.quantize_dense_params(sd, min_size=min_size)
    path_of = _flax_path(params)
    jax_quantized = {jax.tree_util.keystr(p) for p, _ in
                     jax.tree_util.tree_leaves_with_path(jq)
                     if jax.tree_util.keystr(p).endswith("_int8']")}
    port_quantized = [k[:-len("_int8")] for k in pq if k.endswith("_int8")]
    assert port_quantized
    assert len(port_quantized) == len(jax_quantized)
    for key in port_quantized:
        path, tf = path_of[key]
        parent = _at(jq, path[:-1])
        q = np.asarray(parent[path[-1] + "_int8"])
        s = np.asarray(parent[path[-1] + "_scale"])
        got = pq[key + "_int8"].numpy()
        np.testing.assert_array_equal(got.T if tf == "t" else got, q)
        np.testing.assert_array_equal(pq[key + "_scale"].numpy(), s)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(
        np.asarray, jint8.dequantize_dense_params(jq)))
    got = pint8.dequantize_dense_params(pq)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_quantized_bytes(params):
    sd = state_dict_from_jax_params(params)
    assert pint8.quantized_bytes(sd) == jint8.quantized_bytes(
        jax.tree_util.tree_map(jnp.asarray, params))
