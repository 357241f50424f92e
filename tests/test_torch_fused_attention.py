"""Port's packed-QKV attention (cosmos_tpu_torch.ops.fused_attention)
against the JAX package's Pallas kernel in interpret mode.

On the CPU the port's wrapper runs its plain PyTorch version; the CUDA
kernel itself is held to that plain version on the card by chip_smoke.py.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.ops.fused_attention import fused_attention_qkv as jax_fa
from cosmos_tpu_torch.ops import build as kernel_build
from cosmos_tpu_torch.ops import fused_attention as fa


def _qkv(b, l, heads, dh, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, l, 3 * heads * dh)).astype(np.float32)


# f32: the tolerance of the JAX package's own kernel test
# (tests/test_fused_attention.py); both sides compute float32 logits and
# differ only in summation order and the TPU kernel's max-free softmax
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [8, 37, 77, 197])
def test_reference_matches_pallas_f32(l, causal, dh):
    heads = 2
    x = _qkv(2, l, heads, dh, seed=l + dh)
    want = np.asarray(jax_fa(jnp.asarray(x), heads, causal, True))
    got = fa.fused_attention_qkv_reference(torch.from_numpy(x), heads, causal)
    assert got.dtype == torch.float32 and got.shape == (2, l, heads * dh)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


# bf16: both sides round the normalised P to bf16 before P.V and the output
# to bf16; a logit that differs in its last f32 bit can move P or the
# output across a bf16 rounding boundary, so allow one bf16 ulp (2^-8
# relative) of the largest outputs (|o| < 4) on top of 1% relative
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("l", [37, 77])
def test_reference_matches_pallas_bf16(l, causal):
    heads, dh = 2, 64
    x = _qkv(2, l, heads, dh, seed=7 * l)
    want = jax_fa(jnp.asarray(x, jnp.bfloat16), heads, causal, True)
    got = fa.fused_attention_qkv_reference(
        torch.from_numpy(x).to(torch.bfloat16), heads, causal)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1.6e-2, rtol=1e-2)


def test_wrapper_on_cpu_takes_plain_path_without_launching():
    x = torch.from_numpy(_qkv(3, 19, 2, 64, seed=3))
    before = fa.launches
    for causal in (False, True):
        got = fa.fused_attention_qkv(x, 2, causal)
        want = fa.fused_attention_qkv_reference(x, 2, causal)
        assert torch.equal(got, want)
    assert fa.launches == before == 0
    assert kernel_build._loaded == {}


@pytest.mark.parametrize("shape,heads", [
    ((2, 8, 3 * 96), 6),       # head dim 16
    ((2, 8, 3 * 128 + 1), 2),  # last axis not a multiple of 3
    ((8, 3 * 128), 2),         # not [B, L, 3D]
])
def test_wrapper_rejects_unsupported_geometry(shape, heads):
    with pytest.raises(ValueError):
        fa.fused_attention_qkv(torch.zeros(shape), heads)


def test_wrapper_raises_on_a_device_without_kernel():
    # no silent fallback: only a CPU tensor takes the plain version
    x = torch.empty(2, 8, 3 * 128, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        fa.fused_attention_qkv(x, 2)


def test_import_needs_no_toolchain():
    # a fresh process without nvcc on PATH imports the module and runs the
    # CPU path; nothing is compiled or loaded
    code = (
        "import torch\n"
        "from cosmos_tpu_torch.ops import build, fused_attention as fa\n"
        "x = torch.randn(1, 5, 384)\n"
        "fa.fused_attention_qkv(x, 2, True)\n"
        "assert build._loaded == {} and fa.launches == 0\n"
        "try:\n"
        "    build.find_nvcc()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc')\n"
    )
    env = {"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent",
           "PYTHONPATH": str(kernel_build.CSRC.parents[2])}
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "no-nvcc"
