"""K5's and K6's bf16 schedules, emulated in plain torch on the CPU.

The bf16 K6 (cosmos_tpu_torch/ops/csrc/mlp_block.cu) walks the hidden axis
in chunks of HC columns for a tile of BM rows: per chunk the float32
pre-activation of bf16 operands, plus b1, the activation in float32, the
hidden rounded to bf16, and its product with W2's chunk added to a float32
output accumulator that lives across chunks; the output columns are split
between the two blocks of a cluster and their two warpgroups.  The bf16 K5
(csrc/ln_matmul.cu) takes tiles of BM rows x BN columns and k-slices of BK:
the row statistics from the whole row first, then each k-slice normalised
with them, rounded to bf16 and multiplied into a float32 accumulator.

This file replays that arithmetic tile by tile and chunk by chunk (the
tile sizes are read from the kernels' sources) and holds it to the JAX
package's Pallas kernels in interpret mode, and to the port's plain
versions, under the bf16 tolerance that chip_smoke.py holds the card's
kernels to (LN_TOL), at ragged row counts.  It checks the schedules'
rounding and accumulation order, not the kernels: phase 9 of chip_smoke.py
holds the kernels.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cosmos_tpu.ops.experimental.ln_matmul import _ln_matmul_fwd_impl
from cosmos_tpu.ops.experimental.mlp_block import _fwd_impl as _mlp_fwd_impl
from cosmos_tpu_torch.ops.experimental import ln_matmul as tlm
from cosmos_tpu_torch.ops.experimental import mlp_block as tmb

CSRC = Path(tlm.__file__).resolve().parents[1] / "csrc"
ATOL, RTOL = chip_smoke.LN_TOL[torch.bfloat16]
ACTS = ["gelu", "gelu_tanh", "quick_gelu"]
D, HD = 128, 512            # small widths: HD = 4 D, O = 3 D
ROWS = [1, 63, 65, 130]
EPS = 1e-5


def sm90_constants(source: str) -> dict:
    """The integer constants of the bf16 (``namespace sm90``) part of a
    kernel source."""
    text = (CSRC / source).read_text()
    body = text[text.index("namespace sm90 {"):
                text.index("}  // namespace sm90")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", body)}


K5 = sm90_constants("ln_matmul.cu")
K6 = sm90_constants("mlp_block.cu")


def ln_rows(x2: torch.Tensor):
    """(xhat, rstd) in float32 from whole rows: single pass, clamped."""
    return tlm.ln_stats(x2, EPS)


def k6_schedule(x2, g, b, w1, b1, w2, b2, act):
    """K6's bf16 arithmetic: tiles of BM rows (rows past R zero), chunks of
    HC hidden columns, the output columns split into 2 blocks x 2
    warpgroups, each accumulating in float32 over the chunks in order."""
    bm, hc = K6["BM"], K6["HC"]
    r, d = x2.shape
    hd = w1.shape[0]
    dt = x2.dtype
    xhat, _ = ln_rows(x2)
    y = (xhat * g + b).to(dt).float()
    act_fn = tmb._act_fn(act)
    out = torch.empty(r, d)
    n_out = d // 4                       # columns of one warpgroup
    for r0 in range(0, r, bm):
        yt = torch.zeros(bm, d)
        yt[:min(bm, r - r0)] = y[r0:r0 + bm]
        acc = [torch.zeros(bm, n_out) for _ in range(4)]
        for c0 in range(0, hd, hc):
            pre = yt @ w1[c0:c0 + hc].float().t() + b1[c0:c0 + hc]
            h = act_fn(pre).to(dt).float()
            for q in range(4):           # (block, warpgroup) = divmod(q, 2)
                cols = slice(q * n_out, (q + 1) * n_out)
                acc[q] = acc[q] + h @ w2[cols, c0:c0 + hc].float().t()
        o = torch.cat(acc, 1) + b2
        out[r0:r0 + bm] = o[:min(bm, r - r0)]
    return out.to(dt)


def k5_schedule(x2, g, b, w, bias):
    """K5's bf16 arithmetic: tiles of BM rows x BN columns, statistics from
    whole rows, each BK-wide slice normalised, rounded and accumulated in
    float32 in order, then + bias."""
    bm, bn, bk = K5["BM"], K5["BN"], K5["BK"]
    r, d = x2.shape
    o = w.shape[0]
    xf = x2.float()
    _, rstd = ln_rows(x2)
    mean = xf.mean(-1, keepdim=True)
    out = torch.empty(r, o)
    for r0 in range(0, r, bm):
        xt, mt, st = (t[r0:r0 + bm] for t in (xf, mean, rstd))
        for n0 in range(0, o, bn):
            acc = torch.zeros(xt.shape[0], min(bn, o - n0))
            for k0 in range(0, d, bk):
                ks = slice(k0, k0 + bk)
                a = (((xt[:, ks] - mt) * st) * g[ks] + b[ks]).to(x2.dtype)
                acc = acc + a.float() @ w[n0:n0 + bn, ks].float().t()
            out[r0:r0 + bm, n0:n0 + bn] = acc + bias[n0:n0 + bn]
    return out.to(x2.dtype)


def _data(r, seed, o=3 * D):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32))

    return dict(
        x=f(r, D, scale=2.0, shift=0.5).to(torch.bfloat16),
        g=f(D, shift=1.0), b=f(D),
        w=f(o, D, scale=D ** -0.5).to(torch.bfloat16),
        bias=f(o).to(torch.bfloat16).float(),
        w1=f(HD, D, scale=D ** -0.5).to(torch.bfloat16),
        b1=f(HD, scale=0.1),
        w2=f(D, HD, scale=HD ** -0.5).to(torch.bfloat16),
        b2=f(D, scale=0.1))


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(got, want):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32)) if not isinstance(
        want, torch.Tensor) else want.float().numpy()
    np.testing.assert_allclose(got.float().numpy(), want, atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("r", ROWS)
def test_k6_schedule_within_tolerance_of_pallas(r, act):
    d = _data(r, seed=300 + r)
    got = k6_schedule(d["x"], d["g"], d["b"], d["w1"], d["b1"], d["w2"],
                      d["b2"], act)
    want = _mlp_fwd_impl(_j(d["x"]), _j(d["g"]), _j(d["b"]), _j(d["w1"]).T,
                         _j(d["b1"]), _j(d["w2"]).T, _j(d["b2"]), EPS, act,
                         True)
    assert got.dtype == torch.bfloat16 and got.shape == (r, D)
    _close(got, want)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("r", ROWS)
def test_k6_schedule_within_tolerance_of_plain_version(r, act):
    d = _data(r, seed=400 + r)
    args = (d["x"], d["g"], d["b"], d["w1"], d["b1"], d["w2"], d["b2"])
    _close(k6_schedule(*args, act),
           tmb.mlp_block_reference(*args, EPS, act))


@pytest.mark.parametrize("r", ROWS)
def test_k5_schedule_within_tolerance_of_pallas(r):
    d = _data(r, seed=500 + r)
    got = k5_schedule(d["x"], d["g"], d["b"], d["w"], d["bias"])
    want = _ln_matmul_fwd_impl(_j(d["x"]), _j(d["g"]), _j(d["b"]),
                               _j(d["w"]).T, _j(d["bias"].to(torch.bfloat16)),
                               EPS, True)
    assert got.dtype == torch.bfloat16 and got.shape == (r, 3 * D)
    _close(got, want)


@pytest.mark.parametrize("r", ROWS)
def test_k5_schedule_within_tolerance_of_plain_version(r):
    d = _data(r, seed=600 + r)
    args = (d["x"], d["g"], d["b"], d["w"], d["bias"])
    _close(k5_schedule(*args), tlm.ln_matmul_reference(*args, EPS))


def test_schedules_change_the_rounding_only():
    # in float32 (nothing rounded) both schedules are the plain functions up
    # to summation order
    d = {k: v.float() for k, v in _data(130, seed=7).items()}
    xhat, _ = ln_rows(d["x"])
    y = xhat * d["g"] + d["b"]
    h = tmb._act_fn("gelu")(y @ d["w1"].t() + d["b1"])
    got6 = k6_schedule(d["x"], d["g"], d["b"], d["w1"], d["b1"], d["w2"],
                       d["b2"], "gelu")
    got5 = k5_schedule(d["x"], d["g"], d["b"], d["w"], d["bias"])
    assert got6.dtype == got5.dtype == torch.float32
    torch.testing.assert_close(got6, h @ d["w2"].t() + d["b2"], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got5, y @ d["w"].t() + d["bias"], atol=1e-5,
                               rtol=1e-5)


def test_emulation_constants_match_the_kernel_sources():
    # the emulation and the wrappers drift from the kernels if a tile changes
    assert (K5["BM"], K5["BN"], K5["BK"], K5["STAGES"]) == (
        tlm.BM, tlm.BN, tlm.BK, tlm.STAGES)
    assert (K6["BM"], K6["HC"], K6["HCW"], K6["BK1"], K6["BK2"], K6["S1"],
            K6["S2"]) == (tmb.BM, tmb.HC, tmb.HCW, tmb.BK1, tmb.BK2, tmb.S1,
                          tmb.S2)
    # a cluster of two blocks of two warpgroups covers one chunk
    assert 2 * 2 * K6["HCW"] == K6["HC"]
    # row tiles of at least 64 (K6) and 128 (K5) rows
    assert K6["BM"] >= 64 and K5["BM"] >= 128
    # the float32 kernels' tiles (ln_tile.cuh, mlp_block.cu)
    tile = (CSRC / "ln_tile.cuh").read_text()
    assert f"constexpr int BM = {tlm.F32_ROWS};" in tile
    assert f"constexpr int HC = {tmb.F32_HC};" in (
        CSRC / "mlp_block.cu").read_text()
