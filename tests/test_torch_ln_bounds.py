"""The shapes K5 and K6 take, their shared-memory budgets, and the bounds
that chip_smoke.py sets beside them.

The wrappers (ops.experimental.ln_matmul / mlp_block) check shapes before
they launch; these tests run those checks on ``meta`` tensors, so no card
is needed.  The shared-memory formulas of the wrappers are held to the
constants of the kernels' sources, and the bounds (the least time the card
could take for the same work) to PERF.md's kernel table.
"""

import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from cosmos_tpu_torch.ops.experimental import ln_matmul as tlm
from cosmos_tpu_torch.ops.experimental import mlp_block as tmb

CSRC = Path(tlm.__file__).resolve().parents[1] / "csrc"
DTYPES = [torch.bfloat16, torch.float32]
ROWS = [1, 63, 65, 130, 7392, 25216]


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, device="meta", dtype=dtype)


def _sm90(source):
    text = (CSRC / source).read_text()
    body = text[text.index("namespace sm90 {"):
                text.index("}  // namespace sm90")]
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (\w+) = (\d+);", body)}


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("d", [512, 768])
def test_shapes_of_the_ported_widths_are_taken(d, r, dtype):
    tlm.check_shapes(_meta(r, d, dtype=dtype), _meta(3 * d, d, dtype=dtype))
    tmb.check_shapes(_meta(r, d, dtype=dtype), _meta(4 * d, d, dtype=dtype),
                     _meta(d, 4 * d, dtype=dtype))


# the column shards of tensor parallelism: ViT-B's packed QKV (2304) at tp
# 2 and 4, the 512-wide text tower's (1536) at tp 4
TP_SHARDS = [(768, 1152), (768, 576), (512, 384)]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("r", ROWS)
@pytest.mark.parametrize("d,o", TP_SHARDS)
def test_ln_matmul_takes_tensor_parallel_column_shards(d, o, r, dtype):
    tlm.check_shapes(_meta(r, d, dtype=dtype), _meta(o, d, dtype=dtype))


@pytest.mark.parametrize("d,w_shape,match", [
    (500, (1500, 500), "got D=500 O=1500"),      # not a multiple of the k-slice
    (1088, (3264, 1088), "got D=1088 O=3264"),   # wider than 1024
    (768, (2300, 768), "got D=768 O=2300"),      # not a multiple of 64 columns
    (768, (2304, 384), "not \\[R, D\\]"),        # w of another width
    (768, (1160, 768), "got D=768 O=1160"),      # nor is this shard's width
    (512, (32, 512), "got D=512 O=32"),          # less than one 64-column box
])
def test_ln_matmul_refuses_other_shapes(d, w_shape, match):
    with pytest.raises(ValueError, match=match):
        tlm.check_shapes(_meta(8, d), _meta(*w_shape))


@pytest.mark.parametrize("d,hd,w2_shape,match", [
    (640, 2560, None, "got D=640 HD=2560"),    # no kernel at this width
    (1024, 4096, None, "got D=1024 HD=4096"),
    (768, 3000, None, "got D=768 HD=3000"),    # not a whole number of chunks
    (768, 3072, (768, 2048), "w2 shape"),
])
def test_mlp_block_refuses_other_shapes(d, hd, w2_shape, match):
    w2 = _meta(*(w2_shape or (d, hd)))
    with pytest.raises(ValueError, match=match):
        tmb.check_shapes(_meta(8, d), _meta(hd, d), w2)


def test_wrappers_check_before_they_launch():
    # a CUDA-less device is refused first ("no kernel"), then the shapes
    x, v = _meta(8, 640, dtype=torch.float32), _meta(640, dtype=torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        tmb.mlp_block_fwd(x, v, v, _meta(2560, 640), _meta(2560),
                          _meta(640, 2560), v)
    with pytest.raises(ValueError, match="no kernel"):
        tlm.ln_matmul_fwd(x, v, v, _meta(1920, 640), _meta(1920))


@pytest.mark.parametrize("source,module,names", [
    ("ln_matmul.cu", tlm, ("BM", "BN", "BK", "STAGES")),
    ("mlp_block.cu", tmb, ("BM", "HC", "HCW", "BK1", "BK2", "S1", "S2")),
])
def test_wrapper_constants_are_the_kernels(source, module, names):
    consts = _sm90(source)
    assert {n: consts[n] for n in names} == {n: getattr(module, n)
                                            for n in names}


@pytest.mark.parametrize("d", [512, 768])
def test_shared_memory_formulas_follow_the_kernels(d):
    # K5: STAGES stages of x [BM][BK] and W [BN][BK] bf16, BM float2 row
    # statistics, D float2 of g and b, two barriers a stage, 1024 bytes of
    # alignment slack (ln_matmul.cu: STATS, GB, bars_offset, smem_bytes)
    k5 = _sm90("ln_matmul.cu")
    want5 = (k5["STAGES"] * (k5["BM"] + k5["BN"]) * k5["BK"] * 2
             + k5["BM"] * 8 + d * 8 + 2 * k5["STAGES"] * 8 + 1024)
    assert tlm.smem_bytes(d, torch.bfloat16) == want5 <= tlm.SMEM_LIMIT
    # K6: sY [BM][D], two h buffers of the pair's chunk [BM][HC], S1 W1
    # stages [2 HCW][BK1], S2 W2 stages [D/2][BK2], 2 S1 + 2 S2 + 4 barriers
    # (mlp_block.cu: Layout)
    k6 = _sm90("mlp_block.cu")
    want6 = (k6["BM"] * d * 2 + 2 * k6["BM"] * k6["HC"] * 2
             + k6["S1"] * 2 * k6["HCW"] * k6["BK1"] * 2
             + k6["S2"] * (d // 2) * k6["BK2"] * 2
             + (2 * k6["S1"] + 2 * k6["S2"] + 4) * 8 + 1024)
    assert tmb.smem_bytes(d, torch.bfloat16) == want6 <= tmb.SMEM_LIMIT
    # the float32 kernels stage 32 rows (ln_tile.cuh BM) with 8 of padding
    assert tlm.smem_bytes(d, torch.float32) == 32 * (d + 8) * 4
    assert tmb.smem_bytes(d, torch.float32) == 32 * (d + 8 + 64 + 8) * 4


@pytest.mark.parametrize("bound,shape,want_ms", [
    # PERF.md's kernel table: K5 and K6 at the vision globals, bf16
    (chip_smoke.ln_matmul_bound, (25216, 768, 2304), 0.0902),
    (chip_smoke.mlp_block_bound, (25216, 768, 3072), 0.2406),
    # its K5 TP and K6 TP rows: a rank's shard at tp 2
    (chip_smoke.ln_matmul_bound, (25216, 768, 1152), 0.0451),
    (chip_smoke.mlp_block_bound, (25216, 768, 1536), 0.1203),
])
def test_bounds_of_the_main_geometries(bound, shape, want_ms):
    ms, by, nbytes, ops = bound(*shape, torch.bfloat16)
    assert by == "operations"
    assert ms == pytest.approx(ops / chip_smoke.PEAK_OPS[torch.bfloat16] * 1e3)
    assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 < ms
    assert round(ms, 4) == want_ms


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("label,b,l,d", chip_smoke.LN_GEOMETRIES)
def test_bounds_count_each_operand_once(label, b, l, d, dtype):
    r, isz = b * l, torch.tensor([], dtype=dtype).element_size()
    _, _, nbytes, ops = chip_smoke.ln_matmul_bound(r, d, 3 * d, dtype)
    assert ops == 2 * r * d * 3 * d
    assert nbytes == (r * d + 3 * d * d + r * 3 * d) * isz + 5 * d * 4
    _, _, nbytes, ops = chip_smoke.mlp_block_bound(r, d, 4 * d, dtype)
    assert ops == 4 * r * d * 4 * d
    assert nbytes == (2 * r * d + 8 * d * d) * isz + 7 * d * 4
