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
    type, a hub ``hf_model_name``), and the EOT gate as JAX's.
"""

import jax
import numpy as np
import pytest
import torch

import torch_hf_cases as H
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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, JAX model, JAX params, port model on those params)."""
    arch = request.param
    kw = H.model_kw(arch, text_hf_proj_type="mlp" if arch != "bert"
                    else "linear")
    jm, jp = H.jax_model(kw)
    return arch, jm, jp, H.port_model(kw, H.to_port(jp))


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


def test_encode_text_and_forward_equal_jax(pair):
    arch, jm, jp, model = pair
    text = H.tokens(arch)
    images = np.random.default_rng(5).standard_normal(
        (4, 16, 16, 3)).astype(np.float32)

    @jax.jit
    def run(p, x, t):
        enc = jm.apply({"params": p}, t, False, method=jm.encode_text)
        return enc["text_features"], jm.apply({"params": p}, x, t)

    want_enc, want_fwd = H.run_jax(run, jp, images, text)
    with torch.no_grad():
        got_enc = model.encode_text(torch.from_numpy(text))
        got_fwd = model(torch.from_numpy(images), torch.from_numpy(text))
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
    ({"model_type": "gpt2"}, NotImplementedError, "ROADMAP.md"),
    ({"model_type": "not-a-model"}, NotImplementedError, "ROADMAP.md"),
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
