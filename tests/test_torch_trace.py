"""The port's encoder export (cosmos_tpu_torch.models.trace) against
cosmos_tpu's (tests/test_trace.py): both round-trip their encoders on the
same weights, and the port's loaded programs give JAX's live features.  At
head dim 64 every self-attention of the exported graphs is K1's operator,
not its plain ops; at TINY's head dim 16 none is, as in the live model."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.trace import load_traced as jax_load_traced
from cosmos_tpu.models.trace import save_traced as jax_save_traced
from cosmos_tpu.models.trace import trace_model as jax_trace_model
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.models.trace import load_traced, save_traced, trace_model

# tests/test_trace.py's configuration, and the same at head dim 64
TINY = dict(
    embed_dim=32, vision_image_size=16, vision_patch_size=8,
    vision_width=32, vision_layers=2, vision_head_width=16,
    text_context_length=12, text_vocab_size=128, text_width=32,
    text_heads=2, text_layers=2,
)
KERNEL = dict(TINY, embed_dim=64, vision_width=128, vision_head_width=64,
              text_width=128)
B = 4
K1 = "cosmos_tpu_torch.fused_attention_fwd.default"
# normalised features in float32: both sides' CPU kernels sum in other
# orders, a few 1e-7 apart
ATOL = 1e-5


def _inputs():
    rng = np.random.default_rng(0)
    images = rng.normal(size=(B, 16, 16, 3)).astype(np.float32)
    tokens = rng.integers(1, 127, size=(B, 12)).astype(np.int64)
    return images, tokens


@pytest.mark.parametrize("cfg,k1_nodes", [(TINY, 0), (KERNEL, 2)],
                         ids=["tiny", "head-dim-64"])
def test_export_round_trip_equals_jax(cfg, k1_nodes, tmp_path):
    jm, jp = jax_create_model("ViT-B-16", **cfg)
    images, tokens = _inputs()
    ji, jt = jnp.asarray(images), jnp.asarray(tokens, jnp.int32)
    want_img = np.asarray(jm.apply({"params": jp}, ji, True,
                                   method=jm.encode_image)["image_features"])
    want_txt = np.asarray(jm.apply({"params": jp}, jt, True,
                                   method=jm.encode_text)["text_features"])

    # JAX's own round trip
    jax_save_traced(jax_trace_model(jm, jp, batch_size=B),
                    str(tmp_path / "jax"))
    jl = jax_load_traced(str(tmp_path / "jax"))
    np.testing.assert_allclose(np.asarray(jl["encode_image"](jp, ji)),
                               want_img, atol=ATOL)
    np.testing.assert_allclose(np.asarray(jl["encode_text"](jp, jt)),
                               want_txt, atol=ATOL)

    # the port's, on the converted weights
    model = create_model("ViT-B-16", device="cpu", **cfg)
    model.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
        strict=True)
    programs = trace_model(model, batch_size=B)
    assert sorted(programs) == ["encode_image", "encode_text"]
    for name, program in programs.items():
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        assert targets.count(K1) == k1_nodes, name
    save_traced(programs, str(tmp_path / "port"))
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == [
        "encode_image.pt2", "encode_text.pt2"]
    loaded = load_traced(str(tmp_path / "port"))
    got_img = loaded["encode_image"](torch.from_numpy(images))
    got_txt = loaded["encode_text"](torch.from_numpy(tokens))
    np.testing.assert_allclose(got_img.numpy(), want_img, atol=ATOL)
    np.testing.assert_allclose(got_txt.numpy(), want_txt, atol=ATOL)
    with torch.no_grad():
        live = model.encode_image(torch.from_numpy(images), True)
    assert torch.equal(got_img, live["image_features"])


def test_loading_in_a_fresh_process_registers_the_operators(tmp_path):
    """``load_traced`` registers the port's operators before it loads, so a
    process that imported nothing else runs the programs."""
    model = create_model("ViT-B-16", device="cpu", **KERNEL)
    save_traced(trace_model(model, batch_size=B), str(tmp_path))
    images, tokens = _inputs()
    np.save(tmp_path / "images.npy", images)
    code = (
        "import sys, numpy as np, torch\n"
        "from cosmos_tpu_torch.models.trace import load_traced\n"
        f"f = load_traced({str(tmp_path)!r})\n"
        f"x = torch.from_numpy(np.load({str(tmp_path / 'images.npy')!r}))\n"
        "np.save(sys.argv[1], f['encode_image'](x).numpy())\n")
    out = tmp_path / "out.npy"
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        want = model.encode_image(torch.from_numpy(images), True)
    np.testing.assert_array_equal(np.load(out),
                                  want["image_features"].numpy())
