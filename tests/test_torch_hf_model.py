"""The HF text towers of the port (cosmos_tpu_torch/models/hf_*.py) against
cosmos_tpu's, on the CPU, for BERT, RoBERTa, XLM-RoBERTa, T5 and mT5 at
width 32 and 2 layers, in float32 within 1e-5:

  - the config defaults against ``AutoConfig.for_model`` on every field
    the encoders read;
  - ``create_model(text_hf_model_config=...)`` builds the HF tower, whose
    parameters are JAX's tree leaf for leaf through the weight bridge;
  - ``encode_text`` and the full forward against JAX's on the same numpy
    parameters, with right-end pads of each architecture's pad id;
  - the refusals (COSMOS heads on an HF tower, ``m2m_100``, an unknown
    type, a hub ``hf_model_name``), and the EOT gate as JAX's;
  - a local ``hf_model_name`` directory, written by transformers' own
    classes (``FlaxBertModel``; ``FlaxRobertaForMaskedLM``, whose file nests
    the encoder under ``roberta`` beside ``lm_head`` and has no pooler;
    ``FlaxXLMRobertaModel``; ``FlaxT5Model`` and ``FlaxMT5Model`` with their
    decoders, mT5's arrays in flax's chunks; a sharded index; torch's
    ``model.safetensors``): its ``config.json`` resolves to transformers'
    config, the port's loaded leaves are those of JAX's ``create_model(...,
    hf_model_name=dir)`` exactly (JAX's random init replaced by numpy
    parameters; the HF load is its own) and its text features within
    1e-5 of JAX's; a ``pretrained`` checkpoint supersedes the directory and
    an ``hf_model_config`` its ``config.json`` in both; a directory with
    torch's ``pytorch_model.bin`` alone, or no weights, is refused with
    JAX's error.
"""

import json
import logging

import jax
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.models import factory as jax_factory
from cosmos_tpu.models import hf_model as jax_hf
from cosmos_tpu.models.config import build_clip_cfg as jax_build_cfg
from cosmos_tpu.training.zero_shot import \
    supports_eot_truncation as jax_supports_eot
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.models.config import build_clip_cfg
from cosmos_tpu_torch.models.hf_arch import resolve_hf_config
from cosmos_tpu_torch.models.hf_t5 import relative_position_bucket
from cosmos_tpu_torch.training.zero_shot import supports_eot_truncation

ARCHS = tuple(H.HF)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_defaults_equal_transformers(arch):
    from transformers import AutoConfig

    fields = H.T5_FIELDS if arch in ("t5", "mt5") else H.BERT_FIELDS
    for d in ({}, H.HF[arch], {"feed_forward_proj": "gated-silu"}
              if arch in ("t5", "mt5") else {"layer_norm_eps": 1e-7}):
        d = {k: v for k, v in d.items() if k != "model_type"}
        want = AutoConfig.for_model(arch, **d).to_dict()
        got = vars(resolve_hf_config({"model_type": arch, **d}))
        assert {k: got[k] for k in fields} == {k: want[k] for k in fields}


@pytest.mark.parametrize("arch", ARCHS)
def test_default_pooler_is_jax_s(arch):
    """Without ``hf_pooler_type`` the tower pools as JAX's ``arch_dict``
    says (``mean_pooler`` for a type it lacks)."""
    from cosmos_tpu.models.hf_configs import arch_dict

    model = create_model("ViT-B-16", device="meta", **H.model_kw(arch))
    want = arch_dict.get(arch, {}).get("pooler", "mean_pooler")
    assert model.text.pooler_type == want


def test_t5_relative_buckets_equal_jax():
    from transformers.models.t5.modeling_flax_t5 import FlaxT5Attention

    pos = np.arange(300)
    rel = pos[None, :] - pos[:, None]
    want = FlaxT5Attention._relative_position_bucket(
        jax.numpy.asarray(rel, jax.numpy.int32), bidirectional=True,
        num_buckets=32, max_distance=128)
    got = relative_position_bucket(torch.from_numpy(rel), 32, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


IMAGES = np.random.default_rng(5).standard_normal(
    (4, 16, 16, 3)).astype(np.float32)


def _pair_kw(arch: str) -> dict:
    return H.model_kw(arch, text_hf_proj_type="linear" if arch == "bert"
                      else "mlp")


@pytest.fixture(scope="module")
def pairs():
    """arch -> (JAX model, JAX params, port model on those params, JAX's
    ``encode_text`` and forward on IMAGES and ``H.tokens(arch)``, compiled
    once for any parameters of those shapes), built on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            kw = _pair_kw(arch)
            jm, jp = H.jax_model(kw)

            def run(p, x, t):
                enc = jm.apply({"params": p}, t, False,
                               method=jm.encode_text)
                return enc["text_features"], jm.apply({"params": p}, x, t)

            compiled = jax.jit(run).lower(jp, IMAGES, H.tokens(arch)).compile(
                H.FAST_XLA)
            cache[arch] = (jm, jp, H.port_model(kw, H.to_port(jp)), compiled)
        return cache[arch]
    return get


@pytest.fixture(params=ARCHS)
def pair(request, pairs):
    """(arch, JAX model, JAX params, port model on those params)."""
    return (request.param, *pairs(request.param)[:3])


def test_hf_tower_params_are_jax_s_leaf_for_leaf(pair):
    """The port builds the HF tower from ``text_hf_model_config`` (it built
    the native 512-wide tower, silently, before): its text parameters are
    the bridge's names of JAX's ``text`` leaves, shape for shape."""
    arch, _, jp, model = pair
    want = {k: tuple(v.shape) for k, v in H.to_port(jp).items()
            if k.startswith("text.")}
    got = {k: tuple(p.shape) for k, p in model.named_parameters()
           if k.startswith("text.")}
    assert want and got == want
    assert len(want) == len(jax.tree_util.tree_leaves(jp["text"]))
    assert not any(k.startswith(("transformer.", "token_embedding"))
                   for k, _ in model.named_parameters())
    assert set(model.state_dict()) == set(H.to_port(jp))


def test_encode_text_and_forward_equal_jax(pair, pairs):
    arch, jm, jp, model = pair
    text = H.tokens(arch)
    want_enc, want_fwd = pairs(arch)[3](jp, IMAGES, text)
    with torch.no_grad():
        got_enc = model.encode_text(torch.from_numpy(text))
        got_fwd = model(torch.from_numpy(IMAGES), torch.from_numpy(text))
    H.close(got_enc["text_features"], want_enc, f"{arch} encode_text")
    assert set(got_fwd) == set(want_fwd)
    for k, w in want_fwd.items():
        H.close(got_fwd[k], w, f"{arch} forward {k}")


@pytest.mark.parametrize("arch,pooler", [
    ("roberta", "cls_pooler"), ("t5", "cls_pooler"),
    ("roberta", "max_pooler"), ("t5", "cls_last_hidden_state_pooler")])
def test_poolers_and_tokens_equal_jax(arch, pooler):
    """The other poolers, with ``output_all``'s token mapping, on RoBERTa
    (pad id 1: the pad-offset positions; the pooler output) and T5 (no
    pooler output)."""
    kw = H.model_kw(arch, text_hf_pooler_type=pooler, output_all=True)
    jm, jp = H.jax_model(kw, seed=2)
    model = H.port_model(kw, H.to_port(jp))
    text = H.tokens(arch, seed=3)
    want = H.run_jax(jax.jit(lambda p, t: jm.apply(
        {"params": p}, t, True, method=jm.encode_text)), jp, text)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(text), normalize=True)
    assert set(got) == set(want)
    for k, w in want.items():
        H.close(got[k], w, f"{arch} {pooler} {k}")


def test_cosmos_heads_on_an_hf_tower_are_refused():
    """JAX's init fails there (``attn_cross_pool`` is None on the HF
    tower); the port refuses when it builds."""
    kw = H.model_kw("bert", cosmos=True, output_all=True,
                    attentional_pool=True)
    with pytest.raises(TypeError):
        H.jax_model(kw)
    with pytest.raises(ValueError, match="cross-attention pooler"):
        create_model("ViT-B-16", device="cpu", **kw)
    # cosmos without the heads builds in both
    create_model("ViT-B-16", device="cpu", **H.model_kw("bert", cosmos=True))


@pytest.mark.parametrize("cfg,error,match", [
    ({"model_type": "m2m_100"}, NotImplementedError, "no Flax encoder"),
    ({"model_type": "bloom"}, NotImplementedError, "ROADMAP.md"),
    ({"model_type": "not-a-model"}, ValueError,
     "Unrecognized model identifier"),
    ({**H.HF["t5"], "feed_forward_proj": "gated-gelu-x"}, ValueError,
     "feed_forward_proj"),
])
def test_unported_configs_are_refused(cfg, error, match):
    with pytest.raises(error, match=match):
        create_model("ViT-B-16", device="cpu", **dict(
            H.model_kw("bert"), text_hf_model_config=cfg))


def test_jax_refuses_m2m_100_too():
    with pytest.raises(NotImplementedError, match="no Flax encoder"):
        H.jax_model(dict(H.model_kw("bert"),
                         text_hf_model_config={"model_type": "m2m_100"}))


@pytest.mark.parametrize("kw", [
    dict(text_hf_model_name="bert-base-uncased"),
    dict(text_hf_model_name="bert-base-uncased",
         text_hf_model_config=H.HF["bert"]),
])
def test_hub_names_are_refused(kw):
    with pytest.raises(NotImplementedError, match="Not queued"):
        create_model("ViT-B-16", device="cpu", **dict(H.VISION, **kw))


def test_hub_name_with_an_offline_config_builds():
    model = create_model("ViT-B-16", device="cpu", **H.model_kw(
        "bert", text_hf_model_name="bert-base-uncased"))
    assert model.text.config.model_type == "bert"


@pytest.mark.parametrize("text", [
    {},
    {"text_hf_model_config": H.HF["bert"]},
    {"text_hf_model_name": "bert-base-uncased"},
    {"text_hf_model_name": "bert-base-uncased",
     "text_hf_model_config": H.HF["roberta"]},
    {"text_embed_cls": True},
    {"text_no_causal_mask": True},
    {"text_unknown_key": 3},
])
def test_eot_gate_equals_jax(text):
    """JAX's gate reads ``hf_model_name`` only: a tower given by
    ``hf_model_config`` alone passes it in both packages."""
    kw = dict(H.VISION, **text)
    cfg, jcfg = build_clip_cfg("ViT-B-16", kw), jax_build_cfg("ViT-B-16", kw)
    assert cfg.text_cfg.eot_truncation_exact == \
        jcfg.text_cfg.eot_truncation_exact

    class M:
        pass

    m, jm_ = M(), M()
    m.cfg, jm_.cfg = cfg, jcfg
    assert supports_eot_truncation(m) == jax_supports_eot(jm_)
    if "text_hf_model_config" in text and "text_hf_model_name" not in text:
        assert cfg.text_cfg.eot_truncation_exact


def test_text_cfg_fields_are_jax_s():
    import dataclasses

    from cosmos_tpu.models.config import TextCfg as JaxTextCfg
    from cosmos_tpu_torch.models.config import TextCfg

    hf = {f.name: f.default for f in dataclasses.fields(JaxTextCfg)
          if f.name.startswith("hf_")}
    assert {f.name: f.default for f in dataclasses.fields(TextCfg)
            if f.name.startswith("hf_")} == hf
    assert len(hf) == 6


def test_fused_ln_toggles_leave_the_hf_tower_plain(monkeypatch):
    from cosmos_tpu_torch.models import layers
    from cosmos_tpu_torch.ops.experimental import layer_norm as fln

    # width 128 and an even batch: K3's gate admits the tower's LayerNorms
    model = create_model("ViT-B-16", device="cpu", **dict(
        H.model_kw("bert"), text_hf_model_config=dict(
            H.HF["bert"], hidden_size=128, intermediate_size=256)))
    text = torch.from_numpy(H.tokens("bert"))
    assert fln.supported(torch.zeros(4, H.CONTEXT, 128))
    with torch.no_grad():
        want = model.encode_text(text)["text_features"]
    calls = []
    monkeypatch.setattr(fln, "fused_layer_norm",
                        lambda *a: calls.append(a) or a[0])
    monkeypatch.setattr(layers, "FUSED_LN", True)
    with torch.no_grad():
        got = model.encode_text(text)["text_features"]
    assert not calls
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ["roberta", "mt5"])
def test_traced_text_encoder_equals_live(arch):
    """``--trace`` exports an HF tower's text encoder: the program gives
    the live model's features."""
    from cosmos_tpu_torch.models.trace import trace_model

    model = create_model("ViT-B-16", device="cpu", **H.model_kw(arch))
    text = torch.from_numpy(H.tokens(arch)).long()
    program = trace_model(model, batch_size=4)["encode_text"]
    with torch.no_grad():
        want = model.encode_text(text, normalize=True)["text_features"]
    torch.testing.assert_close(program.module()(text), want, rtol=1e-6,
                               atol=1e-6)


def test_init_last_layer_refuses_an_hf_tower():
    from cosmos_tpu_torch.models.init_utils import \
        reinit_last_transformer_layer

    model = create_model("ViT-B-16", device="cpu", **H.model_kw("bert"))
    with pytest.raises(ValueError, match="native text tower"):
        reinit_last_transformer_layer(model, torch.Generator())


# --- a local hf_model_name directory --------------------------------------

# case -> (architecture, the transformers class that writes it, options of
# H.write_hf_dir)
LOCAL = {
    "bert": ("bert", "FlaxBertModel", {}),
    # a head model's file: the encoder under "roberta", an "lm_head", no
    # pooler
    "roberta-mlm": ("roberta", "FlaxRobertaForMaskedLM", {}),
    "xlm-roberta": ("xlm-roberta", "FlaxXLMRobertaModel", {}),
    # FlaxT5Model: shared, encoder and decoder
    "t5": ("t5", "FlaxT5Model", {}),
    # arrays above 4 KiB in flax's chunks (mT5-large's shared, at full size)
    "mt5-chunked": ("mt5", "FlaxMT5Model", {"chunk": 4096}),
    "bert-sharded": ("bert", "FlaxBertModel", {"max_shard_size": "16KB"}),
    # torch's model.safetensors, which JAX's Flax load converts
    "bert-safetensors": ("bert", "torch", {}),
}
# the encoder's parameters a case's file lacks
LOCAL_MISSING = {"roberta-mlm": ["pooler.dense.bias", "pooler.dense.weight"]}


def _dir_kw(arch: str, directory: str, **extra) -> dict:
    kw = dict(_pair_kw(arch), text_hf_model_name=directory,
              text_hf_model_pretrained=True, **extra)
    del kw["text_hf_model_config"]
    return kw


def _jax_create(kw, params, **extra):
    """JAX's ``create_model`` with its random init replaced by ``params``
    (numpy): what it loads after the init is its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_factory, "init_model_params",
                   lambda model, seed=0: jax.tree_util.tree_map(np.array,
                                                                params))
        return jax_factory.create_model("ViT-B-16", use_flash=False,
                                        **kw, **extra)


@pytest.fixture(scope="module")
def local(tmp_path_factory, pairs):
    """case -> (directory, JAX's parameters from it, the port's model from
    it), built on first use."""
    from flax.core import unfreeze

    cache = {}

    def get(case):
        if case not in cache:
            arch, cls, opts = LOCAL[case]
            d = str(tmp_path_factory.mktemp(case))
            H.write_hf_dir(d, arch, cls, seed=len(cache) + 10, **opts)
            kw = _dir_kw(arch, d)
            _, jp = _jax_create(kw, pairs(arch)[1])
            jp = jax.tree_util.tree_map(np.asarray, unfreeze(jp))
            cache[case] = (d, jp, create_model("ViT-B-16", device="cpu",
                                               **kw))
        return cache[case]
    return get


def _encoder_leaves(jp) -> dict:
    """JAX's ``text/hf`` leaves under the port's names, T5's decoder left
    out (the tower reads none of it)."""
    hf = {k: v for k, v in jp["text"]["hf"].items() if k != "decoder"}
    return {k: v for k, v in H.to_port(dict(
        jp, text=dict(jp["text"], hf=hf))).items()
        if k.startswith("text.transformer.")}


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_directory_leaves_are_jax_s(local, case):
    d, jp, model = local(case)
    arch, cls, opts = LOCAL[case]
    files = sorted(p.name for p in __import__("pathlib").Path(d).iterdir())
    if "max_shard_size" in opts:
        assert "flax_model.msgpack.index.json" in files and len(files) > 3
    if "chunk" in opts:
        with open(f"{d}/flax_model.msgpack", "rb") as f:
            assert b"__msgpack_chunked_array__" in f.read()
    want = _encoder_leaves(jp)
    got = {f"text.transformer.{k}": v for k, v in
           model.text.transformer.state_dict().items()}
    missing = {f"text.transformer.{k}" for k in LOCAL_MISSING.get(case, [])}
    assert set(got) == set(want)
    for k, w in want.items():
        if k not in missing:
            assert torch.equal(got[k], w.float()), k
    # JAX's tree keeps T5's decoder; the port loads the encoder alone
    assert ("decoder" in jp["text"]["hf"]) == (arch in ("t5", "mt5"))


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_directory_features_are_jax_s(local, pairs, case):
    d, jp, model = local(case)
    arch = LOCAL[case][0]
    _, pair_params, pair_model, run = pairs(arch)
    # the rest of the model as the pair's, in both
    rest = {k: v for k, v in pair_model.state_dict().items()
            if not k.startswith("text.transformer.")}
    model.load_state_dict(rest, strict=False)
    hf = {k: v for k, v in jp["text"]["hf"].items() if k != "decoder"}
    params = dict(pair_params, text=dict(pair_params["text"], hf=hf))
    text = H.tokens(arch)
    want, _ = run(params, IMAGES, text)
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(text))["text_features"]
    H.close(got, want, f"{case} encode_text")


@pytest.mark.parametrize("case", sorted(LOCAL))
def test_local_config_is_transformers_from_pretrained(local, case):
    from transformers import AutoConfig

    d, _, model = local(case)
    arch = LOCAL[case][0]
    fields = H.T5_FIELDS if arch in ("t5", "mt5") else H.BERT_FIELDS
    want = AutoConfig.from_pretrained(d).to_dict()
    got = vars(model.text.config)
    assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
    # transformers' bookkeeping is left out
    assert not {"architectures", "transformers_version"} & set(got)
    with open(f"{d}/config.json") as f:
        assert "architectures" in json.load(f)


def test_missing_leaves_keep_their_init_and_are_named(local, caplog):
    """A head model's file without BERT's pooler: the port keeps its own
    init there and warns, naming the leaves (transformers draws fresh
    ones)."""
    d = local("roberta-mlm")[0]
    kw = _dir_kw("roberta", d)
    init = create_model("ViT-B-16", device="cpu", seed=4, **dict(
        kw, text_hf_model_pretrained=False)).state_dict()
    with caplog.at_level(logging.WARNING):
        got = create_model("ViT-B-16", device="cpu", seed=4,
                           **kw).state_dict()
    names = LOCAL_MISSING["roberta-mlm"]
    assert all(n in caplog.text for n in names)
    for n in names:
        assert torch.equal(got[f"text.transformer.{n}"],
                           init[f"text.transformer.{n}"])
    assert not torch.equal(
        got["text.transformer.embeddings.word_embeddings.weight"],
        init["text.transformer.embeddings.word_embeddings.weight"])


def test_a_dict_config_wins_over_the_directory(local):
    """``hf_model_config`` beside a directory builds from the dict in both
    packages (JAX's ``resolve_hf_config``), and the weights still load."""
    d, jp, _ = local("bert")
    kw = dict(_dir_kw("bert", d), text_hf_model_config=dict(
        H.HF["bert"], hidden_act="relu", layer_norm_eps=1e-7))
    model = create_model("ViT-B-16", device="cpu", **kw)
    jcfg = jax_hf.resolve_hf_config(
        jax_build_cfg("ViT-B-16", kw).text_cfg)
    for key, value in (("hidden_act", "relu"), ("layer_norm_eps", 1e-7)):
        assert getattr(model.text.config, key) == getattr(jcfg, key) == value
    want = _encoder_leaves(jp)
    for k, v in model.text.transformer.state_dict().items():
        assert torch.equal(v, want[f"text.transformer.{k}"])


def test_pretrained_supersedes_the_directory(local, pairs, tmp_path):
    """A ``pretrained`` checkpoint wins over the directory in both
    packages: the HF weights are the checkpoint's."""
    from flax import serialization

    d = local("bert")[0]
    jp = pairs("bert")[1]
    path = str(tmp_path / "ckpt.msgpack")
    with open(path, "wb") as f:
        f.write(serialization.to_bytes(jp))
    kw = _dir_kw("bert", d)
    _, got_jax = _jax_create(kw, jax.tree_util.tree_map(np.zeros_like, jp),
                             pretrained=path)
    model = create_model("ViT-B-16", device="cpu", pretrained=path, **kw)
    want = H.to_port(jp)
    got = model.state_dict()
    for k, v in H.to_port(got_jax).items():
        assert torch.equal(v, want[k]) and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("files", ["pytorch_model.bin", "none"])
def test_a_directory_without_flax_weights_is_refused_as_jax_refuses(
        tmp_path, pairs, files):
    """JAX's load passes no ``from_pt``: torch's ``pytorch_model.bin``
    alone, or no weights, raise its ``OSError``, with its message."""
    H.hf_config("bert").save_pretrained(tmp_path)
    if files != "none":
        torch.save({}, tmp_path / files)
    kw = _dir_kw("bert", str(tmp_path))
    with pytest.raises(OSError) as want:
        _jax_create(kw, pairs("bert")[1])
    with pytest.raises(OSError) as got:
        create_model("ViT-B-16", device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_sharded_safetensors_are_refused_as_jax_refuses(tmp_path, pairs):
    """transformers' Flax load refuses a ``model.safetensors.index.json``
    (torch's sharded safetensors) without reading it."""
    H.hf_config("bert").save_pretrained(tmp_path)
    (tmp_path / "model.safetensors.index.json").write_text("{}")
    kw = _dir_kw("bert", str(tmp_path))
    with pytest.raises(NotImplementedError) as want:
        _jax_create(kw, pairs("bert")[1])
    with pytest.raises(NotImplementedError, match="sharded safetensors"
                       ) as got:
        create_model("ViT-B-16", device="cpu", **kw)
    assert str(want.value) in str(got.value)


def test_trainer_trains_a_tower_from_a_local_directory(tmp_path,
                                                        monkeypatch):
    """``--model`` naming a registered config whose ``text_cfg`` carries a
    local ``hf_model_name``: the trainer starts from the directory's
    weights (under ``--lock-text`` the frozen ones end on the file's
    bits)."""
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.models.msgpack import read_msgpack
    from cosmos_tpu_torch.training import main as pmain
    from cosmos_tpu_torch.training.train import frozen_mask

    d = tmp_path / "bert"
    # the tokenizer's vocabulary
    H.write_hf_dir(str(d), "bert", "FlaxBertModel", seed=5,
                   vocab_size=49408)
    name = "hf-dir-tiny-test"
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({
        "embed_dim": 32,
        "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 32,
                       "layers": 1, "head_width": 16},
        "text_cfg": {"context_length": 16, "hf_model_name": str(d)}}))
    monkeypatch.setattr(pconfig, "_EXTRA_CONFIGS",
                        dict(pconfig._EXTRA_CONFIGS))
    pconfig.add_model_config(str(path))
    pmain.main(["--model", name, "--dataset-type", "synthetic",
                "--train-num-samples", "4", "--batch-size", "4",
                "--precision", "fp32", "--workers", "1", "--lr", "1e-3",
                "--warmup", "1", "--seed", "3", "--epochs", "1",
                "--lock-text", "--save-most-recent",
                "--logs-dir", str(tmp_path), "--name", "hf"], device="cpu")
    saved = torch.load(tmp_path / "hf" / "checkpoints" / "epoch_1.pt",
                       weights_only=True)["student"]
    tree = read_msgpack(str(d / "flax_model.msgpack"))
    assert torch.equal(
        saved["text.transformer.embeddings.word_embeddings.weight"],
        tree["embeddings"]["word_embeddings"]["embedding"])
    assert torch.equal(
        saved["text.transformer.encoder.layer.1.attention.self.query.weight"],
        tree["encoder"]["layer"]["1"]["attention"]["self"]["query"][
            "kernel"].t())
    frozen = frozen_mask(create_model(name, device="meta"), lock_text=True)
    assert frozen["text.transformer.encoder.layer.1.attention.self.query."
                  "weight"]
