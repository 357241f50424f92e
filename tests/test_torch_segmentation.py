"""The port's segmentation eval (cosmos_tpu_torch.segmentation and
training.seg_eval) against cosmos_tpu's, on the CPU: CSA in the attention
module and the vision tower, K1's routing gate at the lengths where it
turns, the dataset's keep-ratio resize, IoUMetric, PAMR, the bilinear
resizes both ways, and CLIPSegmentor's logits and labels on an image the
dataset enlarges and one it shrinks; then the seg_eval CLI on a 2-image
voc20 layout.

The JAX segmentor is built once, at a tiny head-dim-64 geometry, with CSA
and PAMR; the port's gets the same weights.  Float32 throughout: the two
sides differ in summation order only.
"""

import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.models import attention as ja
from cosmos_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from cosmos_tpu.ops import fused_attention as jfa
from cosmos_tpu.segmentation import dataset as jdataset
from cosmos_tpu.segmentation import metrics as jmetrics
from cosmos_tpu.segmentation import segmentor as jseg
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.data.synthetic import write_segmentation
from cosmos_tpu_torch.models import attention as pattn
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import get_tokenizer
from cosmos_tpu_torch.ops import fused_attention as pfa
from cosmos_tpu_torch.segmentation import dataset as pdataset
from cosmos_tpu_torch.segmentation import metrics as pmetrics
from cosmos_tpu_torch.segmentation import segmentor as pseg
from cosmos_tpu_torch.training import seg_eval

# both packages export the function pamr under the module's name
jpamr = importlib.import_module("cosmos_tpu.segmentation.pamr")
ppamr = importlib.import_module("cosmos_tpu_torch.segmentation.pamr")

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
# head dim 64 in both towers, so the port's self-attentions take K1's
# route (its plain version on the CPU) wherever the gate lets them
TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)
NAME_LINES = ["sky", "cat, kitten", "dog", "tree, bush, plant"]
SEG_KW = dict(slide_crop=32, slide_stride=16, pamr_steps=2,
              pamr_stride=(1, 2), use_csa=True)
# (scale, (h, w)): SegDataset enlarges the first image (the final logits
# shrink to its label) and shrinks the second (they grow)
SEG_IMAGES = {"enlarged": ((64, 48), (40, 56)),
              "shrunk": ((64, 48), (100, 140))}


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _mha_params(d, seed):
    return {
        "in_proj_kernel": _rand((d, 3 * d), seed, d ** -0.5),
        "in_proj_bias": _rand((3 * d,), seed + 1, 0.1),
        "out_proj": {"kernel": _rand((d, d), seed + 2, d ** -0.5),
                     "bias": _rand((d,), seed + 3, 0.1)},
    }


def _port_mha(d, heads, p, dtype):
    mod = pattn.MultiheadAttention(d, heads, dtype=dtype)
    mod.load_state_dict({
        "in_proj_weight": torch.from_numpy(p["in_proj_kernel"].T.copy()),
        "in_proj_bias": torch.from_numpy(p["in_proj_bias"].copy()),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"].copy())})
    return mod


class _Spy:
    """Counts the calls the attention module makes to K1's wrapper."""

    def __init__(self, monkeypatch):
        self.calls = []
        orig = pattn.fused_attention_qkv
        monkeypatch.setattr(pattn, "fused_attention_qkv",
                            lambda *a: self.calls.append(a[0].shape)
                            or orig(*a))


# --- CSA ----------------------------------------------------------------


@pytest.mark.parametrize("d,heads,l", [(32, 4, 5), (128, 2, 17)])
def test_csa_attention_matches_jax(d, heads, l, monkeypatch):
    p = _mha_params(d, l)
    x = _rand((2, l, d), 7)
    want = ja.MultiheadAttention(num_heads=heads, use_flash=True).apply(
        {"params": p}, jnp.asarray(x), csa=True)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got = _port_mha(d, heads, p, torch.float32)(torch.from_numpy(x),
                                                     csa=True)
    assert spy.calls == []           # CSA never reaches K1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.fixture(scope="module")
def tiny_pair():
    jm, jp = H.jax_create_fast("ViT-Tiny-Test", precision="fp32", **COSMOS,
                               **TINY)
    tm = create_model("ViT-Tiny-Test", "fp32", device="cpu", **COSMOS, **TINY)
    tm.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
        strict=True)
    return jm, jp, tm


@pytest.mark.parametrize("csa", [False, True])
def test_vision_tower_csa_last_block_matches_jax(tiny_pair, csa, monkeypatch):
    jm, jp, tm = tiny_pair
    images = _rand((2, 32, 32, 3), 3)
    pooled_j, tokens_j = jm.apply(
        {"params": jp}, jnp.asarray(images), csa,
        method=lambda m, im, c: m.visual(im, csa=c))
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        pooled, tokens = tm.visual(torch.from_numpy(images), csa=csa)
    # 2 blocks: the last one on the plain CSA path under csa
    assert len(spy.calls) == (1 if csa else 2)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(tokens_j),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(pooled_j),
                               atol=1e-5, rtol=1e-5)


# --- K1's routing gate --------------------------------------------------

# (dtype, L): ViT-B width (D 768, 12 heads); the one-row backward working
# set passes JAX's 12 MiB budget at 426 (float32) and 680 (bfloat16) and
# fails one token later
GATE = [("f32", 426, True), ("f32", 427, False), ("bf16", 680, True),
        ("bf16", 681, False)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dt,l,kernel", GATE,
                         ids=[f"{d}-{l}" for d, l, _ in GATE])
def test_k1_gate_routing_equals_jax(dt, l, kernel, monkeypatch):
    jdt, tdt = DTYPES[dt]
    d, heads = 768, 12
    itemsize = torch.tensor([], dtype=tdt).element_size()
    assert jfa.supported(heads, d, l, itemsize=itemsize) is kernel
    assert pfa.supported(heads, d, l, itemsize) is kernel
    p = _mha_params(d, 0)
    x = _rand((1, l, d), 1)
    spy = _Spy(monkeypatch)
    with torch.no_grad():
        got = _port_mha(d, heads, p, tdt)(torch.from_numpy(x).to(tdt))
    assert spy.calls == ([(1, l, 3 * d)] if kernel else [])
    if not kernel:
        # JAX's gate refuses the length too: its use_flash=True module
        # takes the XLA path, the function the port's plain path computes
        want = ja.MultiheadAttention(num_heads=heads, dtype=jdt,
                                     use_flash=True).apply(
            {"params": p}, jnp.asarray(x))
        tol = (dict(atol=2e-5, rtol=1e-5) if dt == "f32"
               else dict(atol=3e-2, rtol=2e-2))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **tol)


# --- dataset, metric ------------------------------------------------------


@pytest.mark.parametrize("hw,scale", [((480, 640), (2048, 336)),
                                      ((300, 4000), (2048, 336)),
                                      ((375, 500), (2048, 448)),
                                      ((200, 150), (2048, 336)),
                                      ((1024, 2048), (2048, 560))])
def test_keep_ratio_resize_dims_matches_jax(hw, scale):
    assert pdataset.keep_ratio_resize_dims(*hw, scale) == \
        jdataset.keep_ratio_resize_dims(*hw, scale)


@pytest.mark.parametrize("seed,num_classes", [(0, 3), (1, 21), (2, 150)])
def test_iou_metric_matches_jax(seed, num_classes):
    rng = np.random.default_rng(seed)
    pm, jm = pmetrics.IoUMetric(num_classes), jmetrics.IoUMetric(num_classes)
    for _ in range(3):
        label = rng.integers(0, num_classes + 1, (23, 31))
        label[label == num_classes] = 255
        # a prediction that agrees with the label on about half the pixels
        pred = np.where(rng.random(label.shape) < 0.5, label % num_classes,
                        rng.integers(0, num_classes, label.shape))
        raw = rng.integers(0, 3, label.shape)
        raw[0, 0] = 255
        np.testing.assert_array_equal(pmetrics.reduce_zero_label(raw),
                                      jmetrics.reduce_zero_label(raw))
        pm.update(pred, label)
        jm.update(pred, label)
    assert pm.compute() == jm.compute()


# --- PAMR and the resizes ---------------------------------------------------


@pytest.mark.parametrize("mask_hw,dilations,num_iter",
                         [((24, 30), (1,), 1), ((24, 30), (1, 2), 3),
                          ((7, 9), (2, 4), 2)])
def test_pamr_matches_jax(mask_hw, dilations, num_iter):
    image = _rand((1, 24, 30, 3), 0)
    mask = _rand((1, *mask_hw, 5), 1)
    want = jpamr.pamr(jnp.asarray(image), jnp.asarray(mask),
                      num_iter=num_iter, dilations=dilations)
    got = ppamr.pamr(torch.from_numpy(image), torch.from_numpy(mask),
                     num_iter=num_iter, dilations=dilations)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((14, 14), (224, 224)),
                                     ((46, 64), (40, 56)),
                                     ((448, 336), (375, 500)),
                                     ((46, 64), (100, 140))],
                         ids=["windows-grow", "shrink", "mixed", "grow"])
def test_resize_bilinear_matches_jax(src, dst):
    x = _rand((1, *src, 4), 5)
    want = jseg.resize_bilinear(jnp.asarray(x), dst)
    got = pseg.resize_bilinear(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)


@pytest.mark.parametrize("src,dst", [((7, 9), (24, 30)), ((24, 30), (7, 9))])
def test_resize_align_corners_matches_jax(src, dst):
    x = _rand((2, *src, 3), 6)
    want = jpamr.resize_bilinear_align_corners(jnp.asarray(x), dst)
    got = ppamr.resize_bilinear_align_corners(torch.from_numpy(x), dst)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# --- the segmentor ----------------------------------------------------------


@pytest.fixture(scope="module")
def segmentors(tiny_pair):
    jm, jp, tm = tiny_pair
    jax_seg = jseg.CLIPSegmentor(jm, jp, jax_get_tokenizer("ViT-Tiny-Test"),
                                 NAME_LINES, **SEG_KW)
    port_seg = pseg.CLIPSegmentor(tm, get_tokenizer("ViT-Tiny-Test"),
                                  NAME_LINES, **SEG_KW)
    return jax_seg, port_seg


def _dataset_image(name, tmp_path):
    """(image as SegDataset resizes it, label) for one of SEG_IMAGES."""
    from cosmos_tpu_torch.segmentation.configs import SegBenchmark

    scale, (h, w) = SEG_IMAGES[name]
    root = write_segmentation(str(tmp_path), "ade20k", [(w, h)],
                              n_labels=len(NAME_LINES), seed=len(name))
    bench = SegBenchmark(name=name, classnames_key="voc20", data_root=root,
                         img_dir="images/validation",
                         ann_dir="annotations/validation", scale=scale)
    image, label = pdataset.SegDataset(bench)[0]
    assert label.shape == (h, w)
    assert (image.shape[0] > h) == (name == "enlarged")
    return image, label


def test_query_features_match_jax(segmentors):
    jax_seg, port_seg = segmentors
    assert port_seg.num_queries == jax_seg.num_queries == 7
    assert port_seg.num_classes == jax_seg.num_classes == 4
    np.testing.assert_allclose(port_seg.query_features.numpy(),
                               jax_seg.query_features, atol=1e-5)


@pytest.mark.parametrize("name", sorted(SEG_IMAGES))
def test_segmentor_logits_and_labels_match_jax(segmentors, name, tmp_path,
                                               monkeypatch):
    jax_seg, port_seg = segmentors
    image, label = _dataset_image(name, tmp_path)
    ori = label.shape[:2]
    # JAX's predict up to its postprocess
    want = jseg.resize_bilinear(jnp.asarray(jax_seg.forward_slide(image))[None],
                                ori)
    img_r = jseg.resize_bilinear(jnp.asarray(jax_seg._normalize(image))[None],
                                 ori)
    want = np.asarray(jpamr.pamr(img_r, want, num_iter=2,
                                 dilations=(1, 2)))[0]
    spy = _Spy(monkeypatch)
    got = port_seg.seg_logits(image, ori).numpy()
    # one vision call per chunk of at most 8 windows; CSA takes the last of
    # the 2 blocks off K1
    windows = ((image.shape[0] - 32 + 15) // 16 + 1) * (
        (image.shape[1] - 32 + 15) // 16 + 1)
    assert len(spy.calls) == -(-windows // 8)
    np.testing.assert_allclose(got, want, atol=1e-4)
    labels = port_seg.predict(image, ori)
    want_labels = jax_seg.predict(image, ori_shape=ori)
    assert labels.shape == want_labels.shape == ori
    top2 = np.sort(got, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > 1e-3
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(labels[clear], want_labels[clear])


@pytest.mark.parametrize("prob_thd,area_thd", [(0.0, None), (0.3, None),
                                               (0.1, 0.1), (0.0, 0.3)])
def test_postprocess_matches_jax(segmentors, prob_thd, area_thd):
    jax_seg, port_seg = segmentors
    logits = _rand((19, 23, 7), 9, 0.05)
    for seg in segmentors:
        seg.prob_thd, seg.area_thd = prob_thd, area_thd
    try:
        np.testing.assert_array_equal(port_seg.postprocess(logits),
                                      jax_seg.postprocess(logits))
    finally:
        for seg in segmentors:
            seg.prob_thd, seg.area_thd = 0.0, None


def test_window_chunks_give_the_same_logits(segmentors, tmp_path):
    _, port_seg = segmentors
    image, _ = _dataset_image("enlarged", tmp_path)
    whole = port_seg.forward_slide(image)
    port_seg.window_chunk = 2
    try:
        chunked = port_seg.forward_slide(image)
    finally:
        port_seg.window_chunk = 8
    np.testing.assert_allclose(chunked.numpy(), whole.numpy(), atol=1e-6)


# --- the CLI ----------------------------------------------------------------


@pytest.fixture(scope="module")
def voc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seg")
    write_segmentation(str(root), "voc", [(120, 90), (90, 130)], seed=3)
    return str(root)


def test_seg_eval_main_loads_the_teacher(voc_root, tmp_path, capsys):
    student = create_model("ViT-Tiny-Test", device="cpu", seed=1, **COSMOS)
    teacher = create_model("ViT-Tiny-Test", device="cpu", seed=2, **COSMOS)
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"student": student.state_dict(),
                "teacher": teacher.state_dict(), "epoch": 1}, ckpt)
    argv = ["--model", "ViT-Tiny-Test", "--pretrained", ckpt,
            "--benchmarks", "voc20", "--seg-data-root", voc_root]
    results = seg_eval.main(argv + ["--use-csa"], device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == results
    out = results["voc20"]
    assert set(out) == {"mIoU", "aAcc", "mAcc"}
    assert all(0.0 <= v <= 100.0 for v in out.values())
    # the same numbers from the teacher's weights directly
    args = seg_eval.parse_args(argv + ["--use-csa"])
    from cosmos_tpu_torch.segmentation import SEG_BENCHMARKS

    want = seg_eval.evaluate_benchmark(
        args, SEG_BENCHMARKS["voc20"], voc_root,
        (teacher, get_tokenizer("ViT-Tiny-Test")))
    assert out == want
    with_pamr = seg_eval.main(argv + ["--student", "--pamr-steps", "1",
                                      "--pamr-stride", "1,2", "--limit", "1"],
                              device="cpu")
    assert all(0.0 <= v <= 100.0 for v in with_pamr["voc20"].values())


def test_seg_eval_refuses_downloads_and_a_missing_card(monkeypatch):
    with pytest.raises(NotImplementedError, match='"Not queued"'):
        seg_eval.main(["--huggingface-model-name", "cosmos_vitb16_cc3m.pt",
                       "--model", "ViT-Tiny-Test"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        seg_eval.main(["--model", "ViT-Tiny-Test"])
