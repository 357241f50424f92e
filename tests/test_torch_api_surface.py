"""The port's public surface against the JAX package's: every name of
cosmos_tpu's lazy table is exported or refused naming its ROADMAP item;
apply_pretrained_preprocess_flags, pretrained_preprocess_defaults, the
preprocess-cfg helpers, get_model_tokenize_cfg, create_loss (CoCa's too),
the precision
helpers, count_params and convert_weights_to_lp against JAX's;
create_model_and_transforms and create_model_from_pretrained; and the
trainer's and seg_eval's --pretrained with a cached tag and with
--force-image-size (the position table resized as the JAX package resizes
it, within 1e-6).
"""

import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cosmos_tpu
import cosmos_tpu_torch
from cosmos_tpu.models import factory as jfactory
from cosmos_tpu.models import pretrained as jpretrained
from cosmos_tpu.training import main as jmain
from cosmos_tpu.training import precision as jprecision
from cosmos_tpu import utils as jutils
from cosmos_tpu_torch import utils as putils
from cosmos_tpu_torch.data.synthetic import write_coco
from cosmos_tpu_torch.data.transforms import EvalTransform
from cosmos_tpu_torch.models import checkpoint as pckpt
from cosmos_tpu_torch.models import factory as pfactory
from cosmos_tpu_torch.models import pretrained as ppretrained
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.training import main as pmain
from cosmos_tpu_torch.training import precision as pprecision
from test_torch_checkpoint_load import COSMOS, jax_random

UNPORTED = {"download_pretrained",
            "download_pretrained_from_url", "push_to_hf_hub",
            "push_pretrained_to_hf_hub"}
COSMOS_FLAGS = ["--cosmos", "--output-all", "--attentional-pool",
                "--add-zero-attn"]
MC_PRE = {"mean": (0.0, 0.0, 0.0), "std": (1.0, 1.0, 1.0),
          "interpolation": "bilinear", "resize_mode": "shortest"}


@pytest.mark.parametrize("name", sorted(cosmos_tpu._LAZY))
def test_every_jax_name_is_exported_or_refused(name):
    if name in UNPORTED:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            getattr(cosmos_tpu_torch, name)
        return
    value = getattr(cosmos_tpu_torch, name)
    assert name in dir(cosmos_tpu_torch)
    if isinstance(value, (tuple, list)):      # the constants
        assert tuple(value) == tuple(getattr(cosmos_tpu, name)), name
    else:
        assert callable(value), name


@pytest.fixture
def tiny_tag(monkeypatch, tmp_path):
    """A registry tag of ViT-Tiny-Test in both packages, its file in a
    cache of its own: a COSMOS training checkpoint of seeded weights."""
    cache = tmp_path / "cache"
    cache.mkdir()
    monkeypatch.setenv("COSMOS_TPU_CACHE", str(cache))
    cfg = {"url": "https://example.invalid/tiny_cosmos.pt",
           "mean": (0.48145466, 0.4578275, 0.40821073),
           "std": (0.26862954, 0.26130258, 0.27577711)}
    for reg in (ppretrained._PRETRAINED, jpretrained._PRETRAINED):
        monkeypatch.setitem(reg, "ViT-Tiny-Test",
                            {"tiny": cfg, "mc": dict(cfg, **MC_PRE)})
    student = pfactory.create_model("ViT-Tiny-Test", device="cpu", seed=21,
                                    add_zero_attn=True, **COSMOS)
    sd = student.state_dict()
    torch.save({"epoch": 1, "student": sd,
                "teacher": {k: v * 0.5 for k, v in sd.items()}},
               cache / "tiny_cosmos.pt")
    return cache / "tiny_cosmos.pt"


CASES = {
    "tag": ["--pretrained", "mc"],
    "explicit_mean_wins": ["--pretrained", "mc", "--image-mean", "0.1",
                           "0.2", "0.3"],
    "path": ["--pretrained", "PATH"],
    "none": [],
}


@pytest.mark.parametrize("case", list(CASES))
def test_apply_pretrained_preprocess_flags(tiny_tag, case):
    from cosmos_tpu.training.params import parse_args as jparse
    from cosmos_tpu_torch.training.params import parse_args as pparse

    argv = ["--model", "ViT-Tiny-Test"] + [
        str(tiny_tag) if a == "PATH" else a for a in CASES[case]]
    j, p = jparse(argv), pparse(argv)
    jmain.apply_pretrained_preprocess_flags(j)
    pmain.apply_pretrained_preprocess_flags(p)
    for flag in ("image_mean", "image_std", "image_interpolation",
                 "image_resize_mode"):
        assert getattr(p, flag, None) == getattr(j, flag, None), flag


@pytest.mark.parametrize("tag,mean", [(None, None), ("mc", None),
                                      ("mc", (0.5, 0.5, 0.5)),
                                      ("tiny", None)])
def test_pretrained_preprocess_defaults(tiny_tag, tag, mean):
    assert (pfactory.pretrained_preprocess_defaults("ViT-Tiny-Test", tag,
                                                    mean)
            == jfactory.pretrained_preprocess_defaults("ViT-Tiny-Test", tag,
                                                       mean))


def test_preprocess_and_tokenize_cfg():
    jm, _ = jfactory.create_model("ViT-Tiny-Test", init_params=False)
    tm = pfactory.create_model("ViT-Tiny-Test", device="cpu")
    assert (pfactory.get_model_preprocess_cfg(tm)
            == jfactory.get_model_preprocess_cfg(jm))
    assert (pfactory.get_model_tokenize_cfg(tm)
            == jfactory.get_model_tokenize_cfg(jm))
    assert pfactory.set_model_preprocess_cfg(tm, MC_PRE) is tm
    jfactory.set_model_preprocess_cfg(jm, MC_PRE)
    assert (pfactory.get_model_preprocess_cfg(tm)
            == jfactory.get_model_preprocess_cfg(jm))
    # the entry goes with its model
    n = len(pfactory._PREPROCESS_OVERRIDES)
    del tm
    gc.collect()
    assert len(pfactory._PREPROCESS_OVERRIDES) == n - 1


@pytest.mark.parametrize("fn", ["and_transforms", "from_pretrained"])
def test_create_model_with_transforms(tiny_tag, fn):
    if fn == "and_transforms":
        tm, train_tf, val_tf = pfactory.create_model_and_transforms(
            "ViT-Tiny-Test", "mc", device="cpu", add_zero_attn=True,
            **COSMOS)
        assert train_tf.image_size == 32
    else:
        tm, val_tf = pfactory.create_model_from_pretrained(
            "ViT-Tiny-Test", "mc", device="cpu", add_zero_attn=True,
            **COSMOS)
    assert val_tf == EvalTransform(32, MC_PRE["mean"], MC_PRE["std"],
                                   "shortest", "bilinear")
    assert pfactory.get_model_preprocess_cfg(tm)["interpolation"] == \
        "bilinear"
    want = torch.load(tiny_tag, weights_only=True)["student"]
    for k, v in tm.state_dict().items():
        assert torch.equal(v, want[k]), k


LOSS_ARGS = {
    "cosmos": dict(cosmos=True),
    "siglip": dict(siglip=True),
    "distill": dict(distill=True),
    "clip": {},
}


@pytest.mark.parametrize("case", list(LOSS_ARGS))
def test_create_loss(case):
    args = types.SimpleNamespace(local_loss=False, gather_with_grad=True,
                                 model="ViT-B-16", **LOSS_ARGS[case])
    assert (type(pfactory.create_loss(args)).__name__
            == type(jfactory.create_loss(args)).__name__)


def test_create_loss_coca_equals_jax():
    args = types.SimpleNamespace(local_loss=False, gather_with_grad=True,
                                 model="coca_ViT-B-32",
                                 coca_caption_loss_weight=1.5,
                                 coca_contrastive_loss_weight=0.5)
    got, want = pfactory.create_loss(args), jfactory.create_loss(args)
    assert type(got).__name__ == type(want).__name__ == "CoCaLoss"
    for field in ("caption_loss_weight", "clip_loss_weight", "pad_id",
                  "local_loss", "gather_with_grad"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("precision", ["fp32", "amp", "amp_bf16", "bf16",
                                       "pure_bf16", "fp16", "pure_fp16",
                                       "amp_bf16_grad_fp32"])
def test_precision_helpers(precision):
    name = lambda d: None if d is None else jnp.dtype(d).name  # noqa: E731
    tname = lambda d: None if d is None else str(d).split(".")[1]  # noqa
    assert tname(pprecision.get_cast_dtype(precision)) == name(
        jprecision.get_cast_dtype(precision))
    assert tname(pprecision.get_input_dtype(precision)) == name(
        jprecision.get_input_dtype(precision))
    assert (pprecision.is_mixed_precision(precision)
            == jprecision.is_mixed_precision(precision))


def test_count_params_and_low_precision():
    _, jp = jax_random("ViT-Tiny-Test", **COSMOS)
    sd = state_dict_from_jax_params(jp)
    assert putils.count_params(sd) == jutils.count_params(jp)
    tm = pfactory.create_model("ViT-Tiny-Test", device="cpu", **COSMOS)
    assert putils.count_params(tm) == jutils.count_params(jp)
    lp = putils.convert_weights_to_fp16(sd)
    jlp = jutils.convert_weights_to_fp16(jax.tree_util.tree_map(jnp.asarray,
                                                                jp))
    want = state_dict_from_jax_params(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), jlp))
    for k in sd:
        assert lp[k].dtype == torch.float16
        assert torch.equal(lp[k].float(), want[k]), k
    assert putils.convert_weights_to_lp(tm, torch.bfloat16) is tm
    assert {p.dtype for p in tm.parameters()} == {torch.bfloat16}


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    write_coco(str(root / "coco"), 4, seed=2, fmt="png", size_range=(36, 72))
    return root


def test_trainer_pretrained_tag_with_force_image_size(tiny_tag, coco,
                                                      tmp_path):
    """Eval-only retrieval from a cached tag at 64 px: the student and the
    teacher of the file, their 32 px position tables resized."""
    from cosmos_tpu_torch.data.datasets import RetrievalData
    from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
    from cosmos_tpu_torch.training.evaluate import evaluate_model

    got = pmain.main(["--model", "ViT-Tiny-Test", *COSMOS_FLAGS,
                      "--eval-mode", "retrieval", "--pretrained", "tiny",
                      "--force-image-size", "64",
                      "--data-root-dir", str(coco),
                      "--logs-dir", str(tmp_path), "--name", "eval"],
                     device="cpu")
    data = {"coco-retrieval": RetrievalData.load(
        "coco", str(coco / "coco"), SimpleTokenizer())}
    for prefix, which in (("", "student"), ("ema_", "teacher")):
        model = pfactory.create_model(
            "ViT-Tiny-Test", "amp", device="cpu", add_zero_attn=True,
            force_image_size=64, **COSMOS)
        pckpt.load_checkpoint(model, str(tiny_tag), which=which)
        assert model.visual.positional_embedding.shape == (17, 32)
        want = evaluate_model(model, data, prefix=prefix, batch_size=64,
                              image_size=64)
        assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("student", [False, True],
                         ids=["teacher", "student"])
def test_seg_eval_pretrained_tag_with_force_image_size(tiny_tag, student):
    """seg_eval's model from a cached tag; the JAX package's load of the
    same file into the same 64 px model gives the same weights."""
    from cosmos_tpu.models.checkpoint import load_checkpoint as jload
    from cosmos_tpu_torch.training import seg_eval

    args = seg_eval.parse_args(
        ["--model", "ViT-Tiny-Test", "--pretrained", "tiny",
         "--precision", "fp32"] + (["--student"] if student else []))
    model, _ = seg_eval.load_model_for_seg(args, "cpu")
    which = "student" if student else "teacher"
    want = torch.load(tiny_tag, weights_only=True)[which]
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    jm, jp = jax_random("ViT-Tiny-Test", vision_image_size=64,
                        add_zero_attn=True, **COSMOS)
    tm = pfactory.create_model("ViT-Tiny-Test", device="cpu",
                               force_image_size=64, add_zero_attn=True,
                               **COSMOS)
    tm.load_state_dict(state_dict_from_jax_params(jp))
    pckpt.load_checkpoint(tm, ppretrained.resolve_pretrained(
        "ViT-Tiny-Test", "tiny"), which=which)
    loaded = state_dict_from_jax_params(jax.tree_util.tree_map(
        np.asarray, jload(jm, jp, str(tiny_tag), which=which)))
    for k, v in tm.state_dict().items():
        np.testing.assert_allclose(v.numpy(), loaded[k].numpy(), atol=1e-6,
                                   rtol=0, err_msg=k)
