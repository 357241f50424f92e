"""K3's and K4's row schedules, replayed on the CPU, and their launch path.

K3 (cosmos_tpu_torch/ops/csrc/layer_norm_fwd.cu) and K4 (layer_norm_bwd.cu)
hand each block whole tiles of TILE_ROWS rows, one row of a tile for each of
its warps, and hold the rows in registers.  A lane owns the columns
lane * VEC + 32 * VEC * j + k (VEC = 16 bytes of the compute dtype) and
sums them in increasing order; the warp then adds its lanes with the xor
butterfly.  K4 adds g * xh and g into each lane's columns
over the rows its warp takes, adds the block's warps in order into one
partial row per block, and a second kernel adds the partial rows of each
column in RED_SPLIT strided sums, then those in order.

This file replays that arithmetic in float32 numpy, one rounded operation at
a time (the tile constants are read from the kernels' sources, the partition
of rows from ``launch_geometry``), and holds the replay to the JAX package's
Pallas kernels in interpret mode and to the port's plain versions, under the
tolerances that chip_smoke.py holds the card's kernels to.  It checks the
schedules, not the kernels: phase 9 of chip_smoke.py holds the kernels.  It
also pins ``launch_geometry`` and the order of the wrappers' checks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from cosmos_tpu.ops.experimental import layer_norm as jln
from cosmos_tpu_torch.ops.experimental import layer_norm as tln

CSRC = Path(tln.__file__).resolve().parents[1] / "csrc"
EPS = 1e-5
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# one row, a ragged few blocks, and a ragged count whose blocks own two
# tiles each (rows_per_block 16, the last block 4 rows)
ROWS = [1, 65, 2500]
LANES = np.arange(32)


def kernel_constants(source: str) -> dict:
    """The integer constants of a kernel source's anonymous namespace."""
    text = (CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", text)}


K3 = kernel_constants("layer_norm_fwd.cu")
K4 = kernel_constants("layer_norm_bwd.cu")


def lane_sums(v: np.ndarray, vec: int) -> np.ndarray:
    """[R, 32] float32: each lane's sum of its columns of ``v`` [R, D] in
    increasing order."""
    r, d = v.shape
    acc = np.zeros((r, 32), np.float32)
    for j in range(-(-d // (32 * vec))):
        for k in range(vec):
            cols = LANES * vec + 32 * vec * j + k
            live = cols < d
            acc[:, live] = acc[:, live] + v[:, cols[live]]
    return acc


def butterfly(acc: np.ndarray) -> np.ndarray:
    """The warp's xor-shuffle sum of [R, 32] lane values: every lane ends
    with the same bits."""
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, LANES ^ o]
    assert (acc == acc[:, :1]).all()
    return acc[:, 0]


def row_stats_k5(x: np.ndarray, vec: int):
    """ln_tile::row_stats as K5's statistics pass runs it: four 16-byte
    chunks at a time, chunks past the row read as zeros."""
    r, d = x.shape
    step, u = 32 * vec, 4
    s = np.zeros((r, 32), np.float32)
    ss = np.zeros((r, 32), np.float32)
    for c0 in range(0, -(-d // step) * step, u * step):
        for i in range(u):
            for k in range(vec):
                cols = LANES * vec + c0 + i * step + k
                v = np.where(cols < d, x[:, np.minimum(cols, d - 1)], 0)
                v = v.astype(np.float32)
                s = s + v
                ss = ss + v * v
    return butterfly(s), butterfly(ss)


def finish(s, ss, d):
    """ln_tile::finish_stats after the butterfly: (mean, rstd)."""
    d = np.float32(d)
    mean = s / d
    var = np.maximum(ss / d - mean * mean, np.float32(0))
    return mean, np.float32(1) / np.sqrt(var + np.float32(EPS))


def k3_replay(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor):
    """K3's arithmetic, row by row as a consumer warp runs it."""
    vec = 16 // x.element_size()
    xf = x.float().numpy()
    mean, rstd = finish(butterfly(lane_sums(xf, vec)),
                        butterfly(lane_sums(xf * xf, vec)), xf.shape[1])
    y = ((xf - mean[:, None]) * rstd[:, None]) * scale.numpy() + bias.numpy()
    return (torch.from_numpy(y).to(x.dtype), torch.from_numpy(mean)[:, None],
            torch.from_numpy(rstd)[:, None])


def k4_replay(x, scale, mean, rstd, g):
    """K4's arithmetic: dx row by row; the column sums per lane over its
    warp's rows of each block, the block's warps in order, then the reduce
    kernel's strided sums."""
    r, d = x.shape
    vec = 16 // x.element_size()
    xf, gf = x.float().numpy(), g.float().numpy()
    mu, rs = mean.numpy().reshape(r, 1), rstd.numpy().reshape(r, 1)
    xh = (xf - mu) * rs
    gs = gf * scale.numpy()
    d32 = np.float32(d)
    m1 = (butterfly(lane_sums(gs, vec)) / d32)[:, None]
    m2 = (butterfly(lane_sums(gs * xh, vec)) / d32)[:, None]
    dx = rs * ((gs - m1) - xh * m2)

    geo = tln.launch_geometry(r, d, x.dtype, True)
    warps = K4["WARPS"] if d <= K4["MAX_D"] else K4["GEN_WARPS"]
    stride = warps
    block_rows = np.arange(geo.blocks) * geo.rows_per_block
    partial = []
    for val in (gf * xh, gf):
        acc = np.zeros((warps, geo.blocks, d), np.float32)
        for w in range(warps):
            for t in range(0, geo.rows_per_block, stride):
                rows = block_rows + t + w
                live = ((rows < r) & (t + w < geo.rows_per_block))[:, None]
                acc[w] = np.where(live, acc[w] + val[np.minimum(rows, r - 1)],
                                  acc[w])
        block = np.zeros((geo.blocks, d), np.float32)
        for w in range(warps):
            block = block + acc[w]
        partial.append(block)
    split = K4["RED_SPLIT"]
    sums = []
    for p in partial:
        strided = [np.zeros(d, np.float32) for _ in range(split)]
        for i in range(geo.blocks):
            strided[i % split] = strided[i % split] + p[i]
        total = np.zeros(d, np.float32)
        for part in strided:
            total = total + part
        sums.append(torch.from_numpy(total))
    return (torch.from_numpy(dx).to(x.dtype), *sums)


def _data(r, d, dtype, seed):
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.standard_normal(shape) * scale + shift).astype(np.float32))

    td = DTYPES[dtype]
    return (f(r, d, scale=2.0, shift=0.5).to(td), f(d, shift=1.0), f(d),
            f(r, d).to(td))


def _j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _close(what, got, want, tol):
    atol, rtol = tol
    want = (want.float().numpy() if isinstance(want, torch.Tensor)
            else np.asarray(jnp.asarray(want).astype(jnp.float32)))
    np.testing.assert_allclose(got.float().numpy().reshape(want.shape), want,
                               atol=atol, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [512, 768])
@pytest.mark.parametrize("r", ROWS)
def test_k3_replay_within_tolerance_of_pallas_and_plain(r, d, dtype):
    x, s, b, _ = _data(r, d, dtype, seed=700 + r + d)
    y, mean, rstd = k3_replay(x, s, b)
    tol = chip_smoke.LN_TOL[DTYPES[dtype]]
    # the Pallas kernel takes [B, L, D]: one batch row of R positions
    jy, (_, _, jmean, jrstd) = jln._ln_fwd(_j(x)[None], _j(s), _j(b), EPS,
                                           True)
    py, pmean, prstd = tln.layer_norm_fwd_reference(x, s, b, EPS)
    assert y.dtype == x.dtype and y.shape == (r, d)
    for name, want_y, want_m, want_r in (("pallas", jy, jmean, jrstd),
                                         ("plain", py, pmean, prstd)):
        _close(f"y vs {name}", y, want_y, tol)
        _close(f"mean vs {name}", mean, want_m, chip_smoke.STATS_TOL)
        _close(f"rstd vs {name}", rstd, want_r, chip_smoke.STATS_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("d", [512, 768])
@pytest.mark.parametrize("r", ROWS)
def test_k4_replay_within_tolerance_of_pallas_and_plain(r, d, dtype):
    x, s, b, g = _data(r, d, dtype, seed=800 + r + d)
    _, mean, rstd = tln.layer_norm_fwd_reference(x, s, b, EPS)
    dx, ds, db = k4_replay(x, s, mean, rstd, g)
    tol = chip_smoke.LN_TOL[DTYPES[dtype]]
    res = (_j(x)[None], _j(s), jnp.asarray(mean.numpy())[None],
           jnp.asarray(rstd.numpy())[None])
    jdx, jds, jdb = jln._ln_bwd(EPS, True, res, _j(g)[None])
    pdx, pds, pdb = tln.layer_norm_bwd_reference(x, s, mean, rstd, g)
    assert dx.dtype == x.dtype and ds.dtype == db.dtype == torch.float32
    for name, want in (("pallas", (jdx, jds, jdb)), ("plain", (pdx, pds, pdb))):
        _close(f"dx vs {name}", dx, want[0], tol)
        _close(f"dscale vs {name}", ds, want[1], chip_smoke.PARAM_GRAD_TOL)
        _close(f"dbias vs {name}", db, want[2], chip_smoke.PARAM_GRAD_TOL)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_k4_general_path_replay_within_tolerance_of_plain(dtype):
    # above MAX_D_RING_BWD: the 4-warp general path and its row order
    r, d = 65, 1536
    x, s, b, g = _data(r, d, dtype, seed=9)
    assert d > K4["MAX_D"]
    _, mean, rstd = tln.layer_norm_fwd_reference(x, s, b, EPS)
    got = k4_replay(x, s, mean, rstd, g)
    want = tln.layer_norm_bwd_reference(x, s, mean, rstd, g)
    _close("dx", got[0], want[0], chip_smoke.LN_TOL[DTYPES[dtype]])
    for name, i in (("dscale", 1), ("dbias", 2)):
        _close(name, got[i], want[i], chip_smoke.PARAM_GRAD_TOL)


@pytest.mark.parametrize("d", [512, 768])
def test_k3_statistics_are_k5s_bits(d):
    # K5's first pass sums 4 chunks at a time with zero padding; K3 one
    # chunk at a time: the same additions in the same order
    x = _data(130, d, "bf16", seed=d)[0]
    _, mean, rstd = k3_replay(x, torch.ones(d), torch.zeros(d))
    s, ss = row_stats_k5(x.float().numpy(), 8)
    m5, r5 = finish(s, ss, d)
    assert np.array_equal(mean.numpy()[:, 0], m5)
    assert np.array_equal(rstd.numpy()[:, 0], r5)


def test_kernel_constants_are_the_wrappers():
    for consts in (K3, K4):
        assert consts["TILE_ROWS"] == consts["WARPS"] == tln.TILE_ROWS
        assert consts["MAX_D"] == tln.MAX_D_REGS
    assert K3["WARPS"] == tln.GEN_ROWS_FWD
    assert K4["GEN_WARPS"] == tln.GEN_WARPS_BWD


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_launch_geometry_takes_every_width(dtype, backward):
    td = DTYPES[dtype]
    top = tln.MAX_D_BWD if backward else 16384
    for d in range(8, top + 1, 8):
        for r in (1, 65, 7392):
            geo = tln.launch_geometry(r, d, td, backward)
            assert 0 <= geo.smem <= tln.SMEM_LIMIT
            assert (geo.blocks - 1) * geo.rows_per_block < r
            assert geo.blocks * geo.rows_per_block >= r
            if d <= tln.MAX_D_REGS:
                assert geo.rows_per_block % tln.TILE_ROWS == 0
                assert geo.blocks <= tln.MAX_BLOCKS
            if backward and d <= tln.MAX_D_REGS:
                # the warps' column sums [WARPS][2][D] float32
                assert geo.smem == K4["WARPS"] * 2 * d * 4
            elif backward:
                assert geo.smem == K4["GEN_WARPS"] * 2 * d * 4
            else:
                assert geo.smem == 0


@pytest.mark.parametrize("r,d,dtype,backward,want", [
    # the vision globals: 263 blocks of 96 rows (12 tiles)
    (25216, 768, torch.bfloat16, False, (96, 263, 0)),
    (25216, 768, torch.bfloat16, True, (96, 263, 49152)),
    (25216, 768, torch.float32, True, (96, 263, 49152)),
    (2500, 512, torch.bfloat16, True, (16, 157, 32768)),
    (1, 512, torch.bfloat16, False, (8, 1, 0)),
    (65, 1024, torch.float32, True, (8, 9, 65536)),
    # the general paths
    (7392, 1536, torch.bfloat16, True, (8, 924, 49152)),
    (7392, 7168, torch.float32, False, (8, 924, 0)),
])
def test_launch_geometry_pinned(r, d, dtype, backward, want):
    assert tuple(tln.launch_geometry(r, d, dtype, backward)) == want


def test_launch_geometry_reads_no_card(monkeypatch):
    # a function of (R, D, dtype) alone: the same partition, and so the
    # same order of K4's sums, on any card
    def refuse(*args, **kwargs):
        raise AssertionError("launch_geometry asked the card")

    for name in ("get_device_properties", "current_device", "device_count",
                 "is_available"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    tln.launch_geometry.cache_clear()
    first = tln.launch_geometry(9856, 512, torch.bfloat16, True)
    tln.launch_geometry.cache_clear()
    assert tln.launch_geometry(9856, 512, torch.bfloat16, True) == first


@pytest.mark.parametrize("shape", [(2, 4, 768), (65, 512)])
@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_wrappers_refuse_meta_before_allocating(monkeypatch, which, shape):
    def refuse(*args, **kwargs):
        raise AssertionError("allocated or launched")

    x = torch.ones(shape, device="meta", dtype=torch.bfloat16)
    p = torch.ones(shape[-1], device="meta")
    st = torch.ones(shape[:-1] + (1,), device="meta")
    for name in ("empty", "empty_like", "zeros"):
        monkeypatch.setattr(torch, name, refuse)
    monkeypatch.setattr(torch.Tensor, "new_empty", refuse)
    monkeypatch.setattr(tln, "_function", refuse)
    monkeypatch.setattr(tln, "_function_bwd", refuse)
    with pytest.raises(ValueError, match="no kernel"):
        if which == "fwd":
            tln.layer_norm_fwd(x, p, p)
        else:
            tln.layer_norm_bwd(x, p, st, st, x)


@pytest.mark.parametrize("source,name,packer", [
    ("layer_norm_fwd.cu", "LnFwdArgs", tln._FWD_ARGS),
    ("layer_norm_bwd.cu", "LnBwdArgs", tln._BWD_ARGS),
])
def test_packed_arguments_match_the_kernels_struct(source, name, packer):
    # the wrappers hand each kernel library one buffer: its fields, in
    # order, and its size must be the C struct's
    text = (CSRC / source).read_text()
    body = text[text.index(f"struct {name} {{"):]
    body = body[:body.index("};")]
    kinds = {"const void*": "Q", "void*": "Q", "int64_t": "q", "int": "i",
             "float": "f"}
    fields = re.findall(r"^\s+(const void\*|void\*|int64_t|int|float) \w+;",
                        body, re.M)
    size = int(re.search(rf"sizeof\({name}\) == (\d+)", text).group(1))
    want = "".join(kinds[f] for f in fields)
    got = "".join(c * int(n or 1) for n, c in
                  re.findall(r"(\d*)([Qqif])", packer.format))
    assert got == want and packer.size == size
