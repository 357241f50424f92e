"""The port's FLOPs and parameters report (cosmos_tpu_torch.training.profiler)
against cosmos_tpu's: the same keys and parameter counts on ViT-Tiny-Test,
the CSV report, and plain ViT-B-16's FLOPs at batch 1 worked out from its
shapes, with K1 counted by its formula.  XLA's CPU backend reports no FLOPs,
so JAX's side is held on the parameters and keys only."""

import csv

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from cosmos_tpu.training import profiler as jprof
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.ops import fused_attention as fa
from cosmos_tpu_torch.training import profiler as pprof

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True)
COUNTS = ("model", "image_size", "image_width", "text_width", "embed_dim",
          "mparams", "image_mparams", "text_mparams")


@pytest.mark.parametrize("kw", [{}, COSMOS], ids=["plain", "cosmos"])
def test_params_and_keys_equal_jax(kw):
    got = pprof.profile_model("ViT-Tiny-Test", device="cpu", **kw)
    want = jprof.profile_model("ViT-Tiny-Test", **kw)
    assert list(got) == list(want)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["image_mparams"] + got["text_mparams"] == pytest.approx(
        got["mparams"], abs=0.01)


def test_cli_writes_the_csv(tmp_path):
    out = tmp_path / "profile.csv"
    rows = pprof.main(["--model", "ViT-Tiny-Test, ViT-Tiny-Test",
                       "--results-file", str(out), "--device", "cpu",
                       "--batch-size", "2"])
    assert [r["model"] for r in rows] == ["ViT-Tiny-Test"] * 2
    with open(out, newline="") as f:
        read = list(csv.DictReader(f))
    assert [r["model"] for r in read] == ["ViT-Tiny-Test"] * 2
    assert list(read[0]) == list(rows[0])
    assert float(read[0]["mparams"]) == rows[0]["mparams"]


def test_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pprof.main(["--model", "ViT-Tiny-Test"])


def _vit_b_16_macs():
    """Plain ViT-B-16's multiply-adds at batch 1, from its shapes."""
    patch = 768 * 3 * 16 * 16 * 196
    image = (patch + 12 * 197 * 12 * 768 ** 2 + 12 * 2 * 197 ** 2 * 768
             + 768 * 512)
    text = 12 * 77 * 12 * 512 ** 2 + 12 * 2 * 77 ** 2 * 512 + 512 * 512
    return image, text


def test_vit_b_16_figures(monkeypatch):
    """149.62 / 86.19 / 63.43 M parameters and 41.09 / 35.13 / 5.96 GFLOPs
    at batch 1, every self-attention on K1's operator (its plain version
    on the CPU), counted by its formula."""
    calls = []
    real = fa.fused_attention_qkv_reference
    monkeypatch.setattr(fa, "fused_attention_qkv_reference",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    row = pprof.profile_model("ViT-B-16", device="cpu")
    image, text = _vit_b_16_macs()
    assert row["image_gflops"] == round(2 * image / 1e9, 2) == 35.13
    assert row["text_gflops"] == round(2 * text / 1e9, 2) == 5.96
    assert row["gflops"] == 41.09
    assert (row["mparams"], row["image_mparams"],
            row["text_mparams"]) == (149.62, 86.19, 63.43)
    assert calls == [(1, 197, 3 * 768)] * 12 + [(1, 77, 3 * 512)] * 12


def test_k1_formula_equals_the_plain_attentions_matmuls():
    """The kernel path and the plain path (``use_flash=False``) of one
    model count the same FLOPs: K1's formula is the two attention
    products the plain path runs."""
    kw = dict(embed_dim=64, vision_width=128, vision_head_width=64,
              vision_image_size=64, text_width=128, text_heads=2)
    counts = []
    for use_flash in (None, False):
        model = create_model("ViT-B-16", device="cpu", use_flash=use_flash,
                             vision_layers=2, text_layers=2, **kw)
        with torch.no_grad(), FlopCounterMode(display=False) as c:
            model.encode_image(torch.zeros(3, 64, 64, 3))
            model.encode_text(torch.zeros(3, 77, dtype=torch.long))
        counts.append(c.get_flop_counts()["Global"])
    kernel, plain = counts
    k1 = kernel.pop(torch.ops.cosmos_tpu_torch.fused_attention_fwd)
    assert k1 == 2 * 3 * (4 * 17 ** 2 * 128 + 4 * 77 ** 2 * 128)
    assert sum(kernel.values()) + k1 == sum(plain.values())
