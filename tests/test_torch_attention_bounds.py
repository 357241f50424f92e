"""The bounds that chip_smoke.py sets beside K1 and K2 (the least time the
card could take for the same work) against the JAX package's cost model of
the same kernels, cosmos_tpu/ops/fused_attention.py::_cost.

The bound is a property of the function, not of its implementation: these
tests pin it, so that a faster kernel is always measured against the same
work.
"""

import pytest
import torch

import chip_smoke
from cosmos_tpu.ops.fused_attention import _cost

# (B, L, D, heads): the serving and training geometries of chip_smoke.py
GEOMETRIES = sorted({(b, l, d3 // 3, heads)
                     for _, b, l, d3, heads, _ in (
                         chip_smoke.GEOMETRIES + chip_smoke.TRAIN_GEOMETRIES
                         + list(chip_smoke.SIGLIP_K1_GEOMETRIES)
                         + list(chip_smoke.SIGLIP_K2_GEOMETRIES))})
DTYPES = [torch.float32, torch.bfloat16]


def _itemsize(dtype):
    return torch.tensor([], dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,l,d,heads", GEOMETRIES)
def test_forward_bound_is_jax_cost(b, l, d, heads, dtype):
    _, _, nbytes, ops = chip_smoke.attention_bound(b, l, d, False, dtype)
    cost = _cost(b, l, d, heads, _itemsize(dtype), backward=False)
    assert ops == cost.flops == 4 * b * l * l * d
    assert nbytes == cost.bytes_accessed == 4 * b * l * d * _itemsize(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("b,l,d,heads", GEOMETRIES)
def test_backward_bound_is_jax_cost(b, l, d, heads, dtype):
    _, _, nbytes, ops = chip_smoke.attention_bwd_bound(b, l, d, False, dtype)
    cost = _cost(b, l, d, heads, _itemsize(dtype), backward=True)
    assert ops == cost.flops == 10 * b * l * l * d
    assert nbytes == cost.bytes_accessed == 7 * b * l * d * _itemsize(dtype)


@pytest.mark.parametrize("bound", [chip_smoke.attention_bound,
                                   chip_smoke.attention_bwd_bound])
@pytest.mark.parametrize("l", [1, 32, 77])
def test_causal_counts_the_lower_triangle(bound, l):
    # JAX's advisory cost ignores the mask; the bound counts only the key
    # positions a causal call needs (the diagonal included) and the same bytes
    b, d = 3, 512
    _, _, full_bytes, full_ops = bound(b, l, d, False, torch.bfloat16)
    _, _, nbytes, ops = bound(b, l, d, True, torch.bfloat16)
    assert nbytes == full_bytes
    assert ops * 2 * l == full_ops * (l + 1)


@pytest.mark.parametrize("bound,shape,want_ms", [
    # PERF.md's kernel table: K1 at the serving geometry, K2 at the
    # training globals, bf16
    (chip_smoke.attention_bound, (256, 197, 768), 0.0925),
    (chip_smoke.attention_bwd_bound, (128, 197, 768), 0.0809),
    # the SigLIP towers (no CLS token, no causal mask): 77.1 and 100.7 MB
    (chip_smoke.attention_bound, (64, 196, 768), 0.0230),
    (chip_smoke.attention_bound, (256, 64, 768), 0.0300),
])
def test_bounds_of_the_main_geometries(bound, shape, want_ms):
    ms, by, nbytes, ops = bound(*shape, False, torch.bfloat16)
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3)
    assert ops / chip_smoke.PEAK_OPS[torch.bfloat16] * 1e3 < ms
    assert round(ms, 4) == want_ms
