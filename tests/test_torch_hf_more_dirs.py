"""Local ``hf_model_name`` directories of the HF towers after the first
five, against cosmos_tpu's ``create_model(..., hf_model_name=dir)`` on the
CPU: each directory is written by transformers' own class
(``save_pretrained``: a head model's ``flax_model.msgpack``, whose encoder
sits under the type's base-model prefix beside the head, a sharded
index, a plain model's file, or torch's ``model.safetensors``), and the
port's loaded encoder leaves are exactly JAX's (its random init replaced
by numpy parameters; the HF load is its own).  The leaves a head model's
file lacks (ALBERT's and RoBERTa-PreLayerNorm's pooler) keep the port's
init and are named.  The directory's ``config.json`` resolves to
transformers' ``AutoConfig.from_pretrained`` on the fields each encoder
reads.
"""

import logging

import jax
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.models import factory as jax_factory
from cosmos_tpu_torch import create_model

# case -> (tower case of torch_hf_cases, the transformers class that writes
# it, options of H.write_hf_dir)
LOCAL = {
    "albert-mlm": ("albert-groups", "FlaxAlbertForMaskedLM", {}),
    "distilbert-mlm-sharded": ("distilbert", "FlaxDistilBertForMaskedLM",
                               {"max_shard_size": "16KB"}),
    "distilbert-safetensors": ("distilbert", "torch", {}),
    "electra": ("electra-project", "FlaxElectraModel", {}),
    "electra-mlm": ("electra", "FlaxElectraForMaskedLM", {}),
    "roberta-prelayernorm-mlm": ("roberta-prelayernorm",
                                 "FlaxRobertaPreLayerNormForMaskedLM", {}),
}
# the encoder's parameters a case's file lacks
MISSING = {"albert-mlm": ["pooler.bias", "pooler.weight"],
           "roberta-prelayernorm-mlm": ["pooler.dense.bias",
                                        "pooler.dense.weight"]}
_FIELDS = {"distilbert": ("dim", "n_layers", "n_heads", "hidden_dim",
                          "activation", "sinusoidal_pos_embds"),
           "albert": ("embedding_size", "num_hidden_groups",
                      "inner_group_num", "hidden_act"),
           "electra": ("embedding_size", "hidden_act"),
           "roberta-prelayernorm": ("layer_norm_eps", "pad_token_id")}


def _dir_kw(tower: str, directory: str) -> dict:
    kw = dict(H.model_kw(tower), text_hf_model_name=directory,
              text_hf_model_pretrained=True)
    del kw["text_hf_model_config"]
    return kw


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """case -> (directory, JAX's loaded parameters, the port's model)."""
    from flax.core import unfreeze

    out = {}
    params = {}
    for i, (case, (tower, cls, opts)) in enumerate(LOCAL.items()):
        d = str(tmp_path_factory.mktemp(case))
        H.write_hf_dir(d, tower, cls, seed=20 + i, **opts)
        if tower not in params:
            params[tower] = H.jax_model(H.model_kw(tower))[1]
        kw = _dir_kw(tower, d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_factory, "init_model_params",
                       lambda model, seed=0, p=params[tower]:
                       jax.tree_util.tree_map(np.array, p))
            _, jp = jax_factory.create_model("ViT-B-16", use_flash=False,
                                             **kw)
        jp = jax.tree_util.tree_map(np.asarray, unfreeze(jp))
        out[case] = (d, jp, create_model("ViT-B-16", device="cpu", **kw))
    return out


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_directory_leaves_are_jax_s(local, case):
    d, jp, model = local[case]
    opts = LOCAL[case][2]
    files = {p.name for p in __import__("pathlib").Path(d).iterdir()}
    if "max_shard_size" in opts:
        assert "flax_model.msgpack.index.json" in files
    want = {k[len("text.transformer."):]: v
            for k, v in H.to_port(jp).items()
            if k.startswith("text.transformer.")}
    got = model.text.transformer.state_dict()
    assert set(got) == set(want)
    missing = set(MISSING.get(case, []))
    for k, w in want.items():
        if k not in missing:
            assert torch.equal(got[k], w.float()), k


@pytest.mark.parametrize("case", sorted(MISSING))
def test_missing_leaves_keep_their_init_and_are_named(local, case, caplog):
    d = local[case][0]
    kw = _dir_kw(LOCAL[case][0], d)
    init = create_model("ViT-B-16", device="cpu", seed=4, **dict(
        kw, text_hf_model_pretrained=False)).state_dict()
    with caplog.at_level(logging.WARNING):
        got = create_model("ViT-B-16", device="cpu", seed=4,
                           **kw).state_dict()
    for n in MISSING[case]:
        assert n in caplog.text
        assert torch.equal(got[f"text.transformer.{n}"],
                           init[f"text.transformer.{n}"])


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_config_is_transformers_from_pretrained(local, case):
    from transformers import AutoConfig

    d, _, model = local[case]
    want = AutoConfig.from_pretrained(d).to_dict()
    got = vars(model.text.config)
    fields = _FIELDS[want["model_type"]] + ("vocab_size", "model_type",
                                            "initializer_range")
    assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
