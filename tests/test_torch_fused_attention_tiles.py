"""K1's tile schedule in bf16, emulated in plain torch on the CPU.

The bf16 K1 (cosmos_tpu_torch/ops/csrc/fused_attention_fwd.cu) walks the
keys in tiles of 64 with an online softmax: float32 logits of bf16
operands, a running max of the unscaled logits that rescales the row sum
and the output accumulator at every tile, the unnormalised
P = exp2(s * scale * log2(e) - m * scale * log2(e)) rounded to bf16 before
P·V, and one division by the float32 row sum at the end.  This file
replays that arithmetic tile by tile (its tile sizes and log2(e) are read
from the kernel's source) and holds it to the JAX package's
Pallas kernel in interpret mode, and to the port's plain version, under the
bf16 tolerance that chip_smoke.py holds the card's kernel to (KERNEL_TOL).
So the schedule's rounding is shown to stay within that tolerance on the
CPU, at ragged lengths on both sides of the tile edges.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
from cosmos_tpu.ops.fused_attention import fused_attention_qkv as jax_fa
from cosmos_tpu_torch.ops import fused_attention as fa

TILE = 64
LOG2E = 1.4426950408889634  # as fused_attention_fwd.cu
HEADS, DH, BATCH = 2, 64, 2
ATOL, RTOL = chip_smoke.KERNEL_TOL[torch.bfloat16]
LENGTHS = [1, 63, 64, 65, 130, 197]


def k1_tiles(qkv: torch.Tensor, heads: int, causal: bool) -> torch.Tensor:
    """K1's bf16 arithmetic, tile by tile.

    Per tile of 64 queries: 64-key tiles, zero-filled past L and masked
    only where they hold masked keys (the ragged last tile, the causal
    diagonal), causal tiles past the query tile skipped; the row max taken
    on the unscaled logits and exp(scale * (s - m)) computed as
    exp2(s * c - m * c) with c = scale * log2(e) (the kernel's FMA rounds
    that once, this emulation twice); unnormalised P rounded to the input
    dtype before P·V; the output times the reciprocal of the row sum."""
    b, l, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    q, k, v = (t.reshape(b, l, heads, dh).transpose(1, 2).float()
               for t in qkv.split(d, dim=-1))
    k, v = (F.pad(t, (0, 0, 0, -l % TILE)) for t in (k, v))
    c = (1.0 / torch.tensor(float(dh)).sqrt()) * torch.tensor(LOG2E)
    out = torch.empty(b, heads, l, dh)
    for q0 in range(0, l, TILE):
        qt = q[..., q0:q0 + TILE, :]
        rows = torch.arange(q0, q0 + qt.shape[-2])[:, None]
        m = torch.full((b, heads, qt.shape[-2], 1), float("-inf"))
        row_sum = torch.zeros_like(m)
        acc = torch.zeros(b, heads, qt.shape[-2], dh)
        n_tiles = q0 // TILE + 1 if causal else k.shape[-2] // TILE
        for k0 in range(0, n_tiles * TILE, TILE):
            s = qt @ k[..., k0:k0 + TILE, :].transpose(-1, -2)
            if k0 + TILE > l or (causal and k0 == q0):
                cols = torch.arange(k0, k0 + TILE)[None, :]
                masked = (cols >= l) | ((cols > rows) & causal)
                s = s.masked_fill(masked, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            m_use = m_new.masked_fill(m_new == float("-inf"), 0.0)
            alpha = torch.exp2((m - m_use) * c)
            p = torch.exp2(s * c - m_use * c)
            row_sum = row_sum * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(qkv.dtype).float() @ v[..., k0:k0 + TILE, :]
            m = m_new
        out[..., q0:q0 + TILE, :] = acc * row_sum.reciprocal()
    return out.to(qkv.dtype).transpose(1, 2).reshape(b, l, d)


def _qkv(l, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, l, 3 * HEADS * DH)).astype(np.float32)
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
def test_tile_schedule_within_tolerance_of_pallas(l, causal):
    x = _qkv(l, seed=100 + l)
    got = k1_tiles(x, HEADS, causal)
    want = jax_fa(jnp.asarray(x.float().numpy(), jnp.bfloat16), HEADS, causal,
                  interpret=True)
    assert got.dtype == torch.bfloat16 and got.shape == (BATCH, l, HEADS * DH)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", LENGTHS)
def test_tile_schedule_within_tolerance_of_plain_version(l, causal):
    # chip_smoke.py holds the card's kernel to this plain version
    x = _qkv(l, seed=200 + l)
    got = k1_tiles(x, HEADS, causal)
    want = fa.fused_attention_qkv_reference(x, HEADS, causal)
    torch.testing.assert_close(got.float(), want.float(), atol=ATOL,
                               rtol=RTOL)


def test_emulation_constants_match_the_kernel_source():
    # the emulation drifts from the kernel if its tiles or log2(e) change
    src = (Path(fa.__file__).parent / "csrc" / "fused_attention_fwd.cu").read_text()
    consts = dict(re.findall(r"constexpr \w+ (\w+) = ([\d.]+)f?;", src))
    assert int(consts["BQ"]) == TILE and int(consts["BK"]) == TILE
    assert float(consts["LOG2E"]) == LOG2E


def test_tiles_change_the_rounding_only():
    # in float32 (P not rounded) the schedule is exact softmax attention up
    # to summation order
    x = _qkv(130, seed=7).float()
    b, l, d3 = x.shape
    q, k, v = (t.reshape(b, l, HEADS, DH).transpose(1, 2)
               for t in x.split(d3 // 3, dim=-1))
    want = torch.softmax(q @ k.transpose(-1, -2) * DH ** -0.5, -1) @ v
    got = k1_tiles(x, HEADS, False)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want.transpose(1, 2).reshape(b, l, -1),
                               atol=1e-6, rtol=1e-5)
