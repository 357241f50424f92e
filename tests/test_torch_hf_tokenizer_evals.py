"""End to end on the CPU: a config whose text tower is a tiny RoBERTa and
whose ``hf_tokenizer_name`` is a local RoBERTa tokenizer directory, through
``get_tokenizer``, the trainer's ``get_data`` (COCO retrieval and a
CIFAR-10 classification set) and ``evaluate_model`` (retrieval and the
zero-shot classifier), against the JAX package's on the same weights.
The ids are equal; features and the classifier agree within the HF tests'
tolerance (``torch_hf_cases.TOL``: rtol 1e-5, atol 1e-5 of the largest
magnitude), the metrics within 1e-5.  One JAX eval run serves the file."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as HC
import torch_tokenizer_dirs as D
from cosmos_tpu.models import config as jax_config
from cosmos_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from cosmos_tpu.training import data_pipeline as jdp
from cosmos_tpu.training import evaluate as jev
from cosmos_tpu.training import zero_shot as jz
from cosmos_tpu.training.params import parse_args as jax_parse_args
from cosmos_tpu_torch.data.synthetic import write_cifar10, write_coco
from cosmos_tpu_torch.models import config as port_config
from cosmos_tpu_torch.models.factory import get_tokenizer
from cosmos_tpu_torch.training import data_pipeline as pdp
from cosmos_tpu_torch.training import evaluate as pev
from cosmos_tpu_torch.training import zero_shot as tz
from cosmos_tpu_torch.training.params import parse_args

NAME = "roberta-tokenizer-Tiny-Test"
CONTEXT = 16
IMAGE = HC.VISION["vision_image_size"]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("hf_tokenizer_evals")
    tok_dir = root / "roberta"
    tok_dir.mkdir()
    D.write_roberta(tok_dir, "tokenizer.json")
    vocab = len(json.loads((tok_dir / "vocab.json").read_text()))
    cfg = json.loads((Path(port_config.__file__).parent / "configs"
                      / "ViT-B-16.json").read_text())
    cfg["text_cfg"].update(hf_tokenizer_name=str(tok_dir),
                           context_length=CONTEXT)
    (root / f"{NAME}.json").write_text(json.dumps(cfg))
    jax_config.add_model_config(root / f"{NAME}.json")
    port_config.add_model_config(root / f"{NAME}.json")
    write_coco(str(root / "data" / "coco"), 6, seed=3, fmt="png",
               size_range=(20, 40))
    write_cifar10(str(root / "cls" / "cifar10"), 12, seed=4)
    argv = ["--model", NAME, "--batch-size", "8", "--data-root-dir",
            str(root / "data"), "--classification-data-dir",
            str(root / "cls"), "--zeroshot-eval-datasets", "cifar10"]

    kw = HC.model_kw("roberta", text_context_length=CONTEXT)
    kw["text_hf_model_config"] = dict(HC.HF["roberta"], vocab_size=vocab)
    jm, jp = HC.jax_model(kw, seed=5)
    pm = HC.port_model(kw, HC.to_port(jp))
    jtok, ptok = jax_get_tokenizer(NAME), get_tokenizer(NAME)
    jdata = jdp.get_data(jax_parse_args(argv), jtok, image_size=IMAGE,
                         context_length=CONTEXT)
    pdata = pdp.get_data(parse_args(argv), ptok, image_size=IMAGE,
                         context_length=CONTEXT)
    want = jev.evaluate_model(jm, jp, jtok, jdata, batch_size=8,
                              image_size=IMAGE)
    with torch.no_grad():
        got = pev.evaluate_model(pm, pdata, tokenizer=ptok, batch_size=8,
                                 image_size=IMAGE)
    return dict(jm=jm, jp=jp, pm=pm, jtok=jtok, ptok=ptok, jdata=jdata,
                pdata=pdata, want=want, got=got)


def test_retrieval_captions_are_jax_s_ids(run):
    j, p = run["jdata"]["coco-retrieval"], run["pdata"]["coco-retrieval"]
    assert p.captions.dtype == j.captions.dtype == np.int32
    np.testing.assert_array_equal(p.captions, j.captions)
    # RoBERTa's ids, padded with its pad id 1, not the byte-BPE tokenizer's
    assert p.captions[:, 0].tolist() == [0] * len(p.captions)
    assert (p.captions == 1).any() and p.captions.max() > 49407 // 4


def _raw_text(run):
    """(JAX's, the port's) raw text encoders of the eval run (JAX's
    compiled at the run's shapes)."""
    return (jev.make_encoders(run["jm"], run["jp"])[2],
            pev.make_encoders(run["pm"])[2])


def test_text_features_equal_jax(run):
    ids = run["pdata"]["coco-retrieval"].captions
    want, got = (f(ids[:8]) for f in _raw_text(run))
    HC.close(got.numpy(), np.asarray(want), "text features")


def test_eval_metrics_equal_jax(run):
    want, got = run["want"], run["got"]
    assert sorted(got) == sorted(want)
    assert {"coco_image_to_text_R@1", "cifar10-zeroshot-val-top1"} <= set(
        got)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-5, k


def test_zero_shot_classifier_equals_jax(run):
    banks = tz.load_classification_banks()
    key = tz.bank_key("cifar10")
    names, templates = banks["labels"][key], banks["templates"][key]
    jraw, praw = _raw_text(run)
    want = jz.build_zero_shot_classifier(
        lambda t: jraw(jnp.asarray(np.asarray(t, np.int32))), run["jtok"],
        names, templates)
    got = tz.build_zero_shot_classifier(praw, run["ptok"], names, templates)
    HC.close(np.asarray(got), np.asarray(want), "classifier")
