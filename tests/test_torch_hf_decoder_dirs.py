"""Local ``hf_model_name`` directories of the decoder-LM towers, against
cosmos_tpu's ``create_model(..., hf_model_name=dir)`` on the CPU: each
directory is written by transformers' own class (``save_pretrained``: a
causal-LM head model's ``flax_model.msgpack``, whose decoder sits under
the type's base-model prefix beside an ``lm_head`` where the embeddings
are not tied, a plain model's file, a sharded index), or is a torch-layout
``model.safetensors`` of GPT-2, whose ``Conv1D`` weights are ``[in,
out]``, which JAX's loader converts by transformers' torch names.  The
port's loaded encoder leaves are exactly JAX's (its random init replaced
by numpy parameters; the HF load is its own), the head's leaves are left
out and named, and the features of the loaded models are JAX's, from one
compiled program.  The directory's ``config.json`` resolves to
transformers' ``AutoConfig.from_pretrained`` on the fields each encoder
reads.
"""

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
    "gpt2-lm": ("gpt2", "FlaxGPT2LMHeadModel", {}),
    "gpt2-safetensors": ("gpt2", "torch", {}),
    "opt-350m-sharded": ("opt-350m", "FlaxOPTModel",
                         {"max_shard_size": "32KB"}),
    "llama-lm": ("llama", "FlaxLlamaForCausalLM", {}),
    "mistral": ("mistral", "FlaxMistralModel", {}),
    "gemma-lm": ("gemma", "FlaxGemmaForCausalLM", {}),
}
# the head leaves a case's file holds beside the encoder
HEAD = {"llama-lm": "lm_head"}
_FIELDS = {"gpt2": ("n_embd", "n_layer", "n_head", "n_inner",
                    "activation_function", "n_positions"),
           "opt": ("hidden_size", "word_embed_proj_dim",
                   "do_layer_norm_before", "ffn_dim", "pad_token_id"),
           "llama": ("hidden_size", "num_key_value_heads", "rms_norm_eps",
                     "attention_bias"),
           "mistral": ("hidden_size", "num_key_value_heads",
                       "sliding_window"),
           "gemma": ("head_dim", "num_key_value_heads", "hidden_activation")}


def _dir_kw(tower: str, directory: str) -> dict:
    kw = dict(H.model_kw(tower), text_hf_model_name=directory,
              text_hf_model_pretrained=True)
    del kw["text_hf_model_config"]
    return kw


@pytest.fixture(scope="module")
def local(tmp_path_factory):
    """case -> (directory, JAX's loaded parameters, the port's model), and
    JAX's features of each loaded model."""
    from flax.core import unfreeze

    out, params, modules = {}, {}, {}
    for i, (case, (tower, cls, opts)) in enumerate(LOCAL.items()):
        d = str(tmp_path_factory.mktemp(case))
        H.write_hf_dir(d, tower, cls, seed=30 + i, **opts)
        if tower not in params:
            params[tower] = H.jax_model(H.model_kw(tower))[1]
        kw = _dir_kw(tower, d)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_factory, "init_model_params",
                       lambda model, seed=0, p=params[tower]:
                       jax.tree_util.tree_map(np.array, p))
            modules[case], jp = jax_factory.create_model(
                "ViT-B-16", use_flash=False, **kw)
        jp = jax.tree_util.tree_map(np.asarray, unfreeze(jp))
        out[case] = (d, jp, create_model("ViT-B-16", device="cpu", **kw))

    def program(trees):
        return {case: modules[case].apply(
            {"params": trees[case]}, H.tokens(LOCAL[case][0]), False,
            method=modules[case].encode_text)["text_features"]
            for case in LOCAL}

    feats = H.run_jax(jax.jit(program), {c: v[1] for c, v in out.items()})
    return out, jax.tree_util.tree_map(np.asarray, feats)


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_directory_leaves_are_jax_s(local, case):
    d, jp, model = local[0][case]
    files = {p.name for p in __import__("pathlib").Path(d).iterdir()}
    if "max_shard_size" in LOCAL[case][2]:
        assert "flax_model.msgpack.index.json" in files
    if LOCAL[case][1] == "torch":
        assert files == {"config.json", "model.safetensors"}
    want = {k[len("text.transformer."):]: v
            for k, v in H.to_port(jp).items()
            if k.startswith("text.transformer.")}
    got = model.text.transformer.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w.float()), k


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_loaded_features_are_jax_s(local, case):
    """The loaded encoder beside JAX's other parameters (the projection
    head, which no directory holds)."""
    _, jp, model = local[0][case]
    rest = {k: v for k, v in H.to_port(jp).items()
            if not k.startswith("text.transformer.")}
    model = H.port_model(_dir_kw(LOCAL[case][0], local[0][case][0]))
    model.load_state_dict(rest, strict=False)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(H.tokens(LOCAL[case][0])))
    H.close(got["text_features"], local[1][case], case)


@pytest.mark.parametrize("case", sorted(HEAD))
def test_head_leaves_are_left_out_and_named(local, case, caplog):
    import logging

    from cosmos_tpu_torch.models.hf_model import read_hf_weights

    d = local[0][case][0]
    kind, tree = read_hf_weights(d)
    assert kind == "flax" and HEAD[case] in tree
    with caplog.at_level(logging.INFO):
        create_model("ViT-B-16", device="cpu",
                     **_dir_kw(LOCAL[case][0], d))
    assert HEAD[case] in caplog.text


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_config_is_transformers_from_pretrained(local, case):
    from transformers import AutoConfig

    d, _, model = local[0][case]
    want = AutoConfig.from_pretrained(d).to_dict()
    got = vars(model.text.config)
    fields = _FIELDS[want["model_type"]] + ("vocab_size", "model_type")
    assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
