"""The port's zero-shot classification (cosmos_tpu_torch.training.zero_shot
and the trainer's classification evals) against cosmos_tpu's, on the CPU:
the prompt-ensembled classifier's columns on the same float32 weights,
top-k accuracy, ragged last batches, the ImageNet and classification-set
evals' metric names and values, and --eval-mode classification and the
per-epoch zero-shot at --zeroshot-frequency through training.main.main.

JAX's classifier runs on a real (tiny, head-dim-64) model once; the other
comparisons use the same fixed "encoders" on both sides (a projection of
the pixels, a mean of token embeddings), so they test the eval code alone.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.training import zero_shot as jz
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.data.synthetic import (write_cifar10, write_coco,
                                             write_image_folder, write_shards)
from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.training import main as pmain
from cosmos_tpu_torch.training import params as pparams
from cosmos_tpu_torch.training import zero_shot as tz
from cosmos_tpu_torch.training.evaluate import make_encoders

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)
COSMOS_FLAGS = ["--cosmos", "--output-all", "--attentional-pool",
                "--add-zero-attn"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# --- the classifier on a real model -----------------------------------------


@pytest.fixture(scope="module")
def classifier_pair():
    """JAX's classifier over 12 ImageNet classes × the 80 templates, 5
    classes a call (a ragged last call), EOT-truncated; and the port's
    model with the same weights."""
    jm, jp = jax_create_model("ViT-Tiny-Test", precision="fp32", **COSMOS,
                              **TINY)
    tm = create_model("ViT-Tiny-Test", "fp32", device="cpu", **COSMOS, **TINY)
    tm.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
        strict=True)
    meta = jz.load_imagenet_metadata()
    want = jz.build_zero_shot_classifier(
        lambda t: jm.apply({"params": jp}, jnp.asarray(t),
                           method=jm.encode_text)["text_features"],
        JaxTokenizer(context_length=16), meta["classnames"][:12],
        meta["templates"], num_classes_per_batch=5, eot_truncate=True)
    return np.asarray(want), tm


@pytest.mark.parametrize("per_call,eot", [(5, True), (12, False), (1, True)])
def test_classifier_columns_match_jax(classifier_pair, per_call, eot):
    want, tm = classifier_pair
    meta = tz.load_imagenet_metadata()
    enc_text_raw = make_encoders(tm)[2]
    got = tz.build_zero_shot_classifier(
        enc_text_raw, SimpleTokenizer(context_length=16),
        meta["classnames"][:12], meta["templates"],
        num_classes_per_batch=per_call, eot_truncate=eot)
    assert got.shape == want.shape == (64, 12) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_legacy_classifier_is_one_class_a_call(classifier_pair):
    _, tm = classifier_pair
    meta = tz.load_imagenet_metadata()
    seen = []
    enc = make_encoders(tm)[2]
    got = tz.build_zero_shot_classifier_legacy(
        lambda t: seen.append(len(t)) or enc(t),
        SimpleTokenizer(context_length=16), meta["classnames"][:3],
        meta["simple_templates"])
    assert seen == [7, 7, 7] and got.shape == (64, 3)


# --- metadata, accuracy, ragged batches -------------------------------------


def test_banks_and_names_equal_jax():
    assert tz.load_imagenet_metadata() == jz.load_imagenet_metadata()
    assert tz.load_classification_banks() == jz.load_classification_banks()
    assert tz.CLASSIFICATION_DATASETS == jz.CLASSIFICATION_DATASETS
    for name in ("fgvc_aircraft", "oxford_pets", "flowers102", "cifar10"):
        assert tz.bank_key(name) == jz.bank_key(name)


@pytest.mark.parametrize("seed,n,c,topk", [(0, 9, 10, (1, 5)),
                                           (1, 33, 1000, (1, 5, 10)),
                                           (2, 1, 7, (1,))])
def test_accuracy_matches_jax(seed, n, c, topk):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((n, c)).astype(np.float32)
    target = rng.integers(0, c, n)
    assert tz.accuracy(logits, target, topk) == jz.accuracy(logits, target,
                                                            topk)


D_FEAT = 16


def _text_encoders(seed=0):
    """(JAX, port) raw text encoders: a mean of fixed token embeddings."""
    w = np.random.default_rng(seed).standard_normal(
        (49408, D_FEAT)).astype(np.float32)
    feats = lambda t: w[np.asarray(t)].mean(axis=1)   # noqa: E731
    return (lambda t: jnp.asarray(feats(t)),
            lambda t: torch.from_numpy(feats(t)))


def _image_encoders():
    """(JAX, port) image encoders: the first D_FEAT 'pixels'."""
    feats = lambda x: np.asarray(x, np.float32).reshape(   # noqa: E731
        len(x), -1)[:, :D_FEAT]
    return (lambda x: jnp.asarray(feats(x)),
            lambda x: torch.from_numpy(feats(x)))


def _batches(classifier, n, sizes, seed, noise=0.05):
    """Image batches whose features lie near the classifier's columns of
    random targets, split into batches of ``sizes`` (a ragged last one)."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, classifier.shape[1], n)
    feats = classifier[:, target].T + noise * rng.standard_normal(
        (n, classifier.shape[0]))
    images = feats.astype(np.float32).reshape(n, 4, 4, 1)
    out, start = [], 0
    for s in sizes:
        out.append((images[start:start + s], target[start:start + s]))
        start += s
    assert start == n
    return out


@pytest.mark.parametrize("sizes", [(8, 8, 3), (5,), (4, 4, 4, 1)])
def test_ragged_last_batch_matches_jax(sizes):
    rng = np.random.default_rng(len(sizes))
    classifier = rng.standard_normal((D_FEAT, 20)).astype(np.float32)
    classifier /= np.linalg.norm(classifier, axis=0, keepdims=True)
    batches = _batches(classifier, sum(sizes), sizes, seed=len(sizes),
                       noise=0.6)
    j_img, p_img = _image_encoders()
    want = jz.run_classification_eval(j_img, jnp.asarray(classifier), batches)
    got = tz.run_classification_eval(p_img, torch.from_numpy(classifier),
                                     batches)
    assert got == want
    # divided by the real count: a multiple of 1 / n
    n = sum(sizes)
    assert all(abs(v * n - round(v * n)) < 1e-9 for v in got)
    assert 0.0 <= got[0] <= got[1] <= 1.0


def test_zero_shot_eval_matches_jax():
    j_txt, p_txt = _text_encoders()
    j_img, p_img = _image_encoders()
    meta = tz.load_imagenet_metadata()
    classifier = tz.build_zero_shot_classifier(
        p_txt, SimpleTokenizer(), meta["classnames"],
        meta["simple_templates"], eot_truncate=True).numpy()
    data = {"imagenet-val": _batches(classifier, 21, (8, 8, 5), seed=1),
            "imagenet-v2": _batches(classifier, 9, (8, 1), seed=2, noise=0.2)}
    want = jz.zero_shot_eval(j_img, j_txt, JaxTokenizer(), data,
                             use_simple_templates=True, eot_truncate=True)
    got = tz.zero_shot_eval(p_img, p_txt, SimpleTokenizer(), data,
                            use_simple_templates=True, eot_truncate=True)
    assert list(got) == list(want) == [
        "imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5",
        "imagenetv2-zeroshot-val-top1", "imagenetv2-zeroshot-val-top5"]
    assert got == want
    # far above chance (1 in 1000): the features lie near their columns
    assert got["imagenet-zeroshot-val-top1"] > 0.1


@pytest.mark.parametrize("name", ["cifar10", "fgvc_aircraft", "dtd"])
def test_classification_eval_matches_jax(name):
    j_txt, p_txt = _text_encoders(1)
    j_img, p_img = _image_encoders()
    banks = tz.load_classification_banks()
    key = tz.bank_key(name)
    classifier = tz.build_zero_shot_classifier(
        p_txt, SimpleTokenizer(), banks["labels"][key],
        banks["templates"][key]).numpy()
    batches = _batches(classifier, 13, (6, 6, 1), seed=3, noise=0.1)
    want = jz.zero_shot_classification_eval(j_img, j_txt, JaxTokenizer(),
                                            name, batches)
    got = tz.zero_shot_classification_eval(p_img, p_txt, SimpleTokenizer(),
                                           name, batches)
    assert list(got) == [f"{name}-zeroshot-val-top1",
                         f"{name}-zeroshot-val-top5"]
    assert got == want
    with pytest.raises(KeyError, match="no prompt bank"):
        tz.zero_shot_classification_eval(p_img, p_txt, SimpleTokenizer(),
                                         "imagenet_sketch", batches)


# --- through the trainer ------------------------------------------------

# the eval flags the trainer refused before the classification evals were
# ported
PORTED_ARGV = {
    "imagenet-val": ["--imagenet-val", "/data/val"],
    "imagenet-v2": ["--imagenet-v2", "/data/v2"],
    "zeroshot": ["--zeroshot-eval-datasets", "cifar10"],
    "eval-classification": ["--eval-mode", "classification"],
    "eval-segmentation": ["--eval-mode", "segmentation"],
    "csa": ["--use-csa", "--seg-w-background"],
}


@pytest.mark.parametrize("name", sorted(PORTED_ARGV))
def test_eval_flags_are_no_longer_refused(name):
    pmain.check_ported(pparams.parse_args(PORTED_ARGV[name]),
                       torch.device("cpu"))



@pytest.fixture(scope="module")
def eval_data(tmp_path_factory):
    d = tmp_path_factory.mktemp("evaldata")
    write_image_folder(str(d / "imagenet" / "val"), 3, 2, seed=0,
                       size_range=(40, 80))
    write_cifar10(str(d / "classification" / "cifar10"), 10, seed=1)
    write_coco(str(d / "root" / "coco"), 4, seed=2, fmt="png",
               size_range=(36, 72))
    write_shards(str(d / "train-{i:04d}.tar"), 1, 8, seed=3, fmt="png",
                 size_range=(36, 72))
    torch.save({which: create_model("ViT-Tiny-Test", device="cpu", seed=seed,
                                    **COSMOS).state_dict()
                for which, seed in (("student", 1), ("teacher", 2))},
               str(d / "ckpt.pt"))
    return d


def _eval_argv(d, logs, name, *extra):
    return ["--model", "ViT-Tiny-Test", "--precision", "fp32",
            *COSMOS_FLAGS, "--batch-size", "4", "--logs-dir", str(logs),
            "--name", name, "--imagenet-val", str(d / "imagenet" / "val"),
            "--classification-data-dir", str(d / "classification"),
            "--zeroshot-eval-datasets", "cifar10,dtd",
            "--data-root-dir", str(d / "root"), *extra]


def test_eval_mode_classification(eval_data, tmp_path):
    metrics = pmain.main(_eval_argv(eval_data, tmp_path, "cls", "--eval-mode",
                                    "classification", "--pretrained",
                                    str(eval_data / "ckpt.pt")), device="cpu")
    keys = {k for k in metrics if k != "epoch"}
    want = {f"{p}{name}-zeroshot-val-top{k}" for p in ("", "ema_")
            for name in ("imagenet", "cifar10") for k in (1, 5)}
    # retrieval is left out under --eval-mode classification, and dtd has
    # no directory under --classification-data-dir
    assert keys == want
    assert all(0.0 <= metrics[k] <= 1.0 for k in keys)
    for prefix in ("", "ema_"):
        for name in ("imagenet", "cifar10"):
            assert metrics[f"{prefix}{name}-zeroshot-val-top1"] <= \
                metrics[f"{prefix}{name}-zeroshot-val-top5"]
    with pytest.raises(SystemExit, match="seg_eval"):
        pmain.main(_eval_argv(eval_data, tmp_path, "seg", "--eval-mode",
                              "segmentation"), device="cpu")


def test_zeroshot_frequency_in_training(eval_data, tmp_path):
    argv = ["--model", "ViT-Tiny-Test", "--precision", "fp32",
            *COSMOS_FLAGS, "--dataset-type", "webdataset",
            "--train-data", str(eval_data / "train-0000.tar"),
            "--train-num-samples", "8", "--batch-size", "4",
            "--use-imagecrop-aug", "--local-crops-number", "2",
            "--caption-sampling-mode", "textcrop",
            "--num-sampled-captions", "2", "--workers", "1",
            "--logs-dir", str(tmp_path), "--name", "train",
            "--classification-data-dir",
            str(eval_data / "classification"),
            "--zeroshot-eval-datasets", "cifar10", "--zeroshot-frequency",
            "2", "--epochs", "3", "--save-frequency", "0",
            "--no-eval-teacher"]
    pmain.main(argv, device="cpu")
    with open(os.path.join(tmp_path, "train", "results.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    # zero-shot at epochs divisible by --zeroshot-frequency and the last
    assert [line["epoch"] for line in lines] == [1, 2, 3]
    assert ["cifar10-zeroshot-val-top1" in line for line in lines] == [
        False, True, True]
