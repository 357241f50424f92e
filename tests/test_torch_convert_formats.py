"""The port's third-party checkpoint converters
(cosmos_tpu_torch.models.convert and the towers' converters) against
cosmos_tpu.models.convert on the same state dicts: detect_format on every
fingerprint, bare timm ViT, EVA02 (both MLP namings) and ConvNeXt
checkpoints with and without a CLIP head, Apple's MobileCLIP in its train
form (the FastViT/MCi fusing converter and MobileCLIP-B's hybrid ViT, from
tests/test_fastvit.py's and tests/test_mobileclip_b.py's oracles), and the
refusals with JAX's messages.

The converted state dict, and the model's after load_checkpoint, must equal
state_dict_from_jax_params(JAX's converted tree) exactly: the fusion runs
in numpy in float32 with JAX's expressions, so the bits agree.  Features
are held to JAX's within 1e-5, once a timm trunk.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models import convert as jconvert
from cosmos_tpu_torch.models import checkpoint as pckpt
from cosmos_tpu_torch.models import convert as pconvert
from cosmos_tpu_torch.models import fastvit as pfastvit
from cosmos_tpu_torch.models import timm_model as ptimm
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model
from test_fastvit import (DIMS, IMG as MC_IMG, LAYERS, _mobileclip_checkpoint,
                          _randomize, apple_state_dict, TorchMCi)
from test_mobileclip_b import (IMG as B_IMG, STEM, TorchHybridViT,
                               _TorchText, apple_sd)
from test_mobileclip_b import HEADS as B_HEADS, LAYERS as B_LAYERS, \
    WIDTH as B_WIDTH
from test_torch_checkpoint_load import jax_random, pair as _pair
from test_torch_towers import _image_size, _overrides

FEAT_TOL = dict(atol=1e-5, rtol=1e-5)

pfastvit.register_fastvit("fastvit_test", layers=LAYERS, dims=DIMS)
ptimm.register_timm_vit("vit_mci_test", patch_size=16, width=B_WIDTH,
                        layers=B_LAYERS, heads=B_HEADS, image_size=B_IMG,
                        stem_channels=STEM, no_embed_class=True)

MC_MODELS = {
    "fastvit": dict(vision_timm_model_name="fastvit_test",
                    vision_timm_pool="avg", vision_timm_proj="linear",
                    vision_image_size=MC_IMG),
    "hybrid_vit": dict(vision_timm_model_name="vit_mci_test",
                       vision_timm_pool="token", vision_timm_proj="linear",
                       vision_image_size=B_IMG),
}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_state_equal(got, want_tree):
    want = state_dict_from_jax_params(_np_tree(want_tree))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].float(), want[k].float()), k


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _tokens(vocab):
    """Two captions with the highest id as their end token."""
    toks = np.zeros((2, 16), np.int64)
    toks[:, 0] = vocab - 2
    toks[0, 1:5] = [3, 125, 39, vocab - 1]
    toks[1, 1:3] = [77, vocab - 1]
    return toks


def _assert_features_equal(jm, jparams, tm, size, text=True):
    x = _images(2, size, 4)
    want = jax.jit(lambda p, im: jm.apply({"params": p}, im, False,
                                          method=jm.encode_image))(
        jparams, jnp.asarray(x))
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(got["image_features"].numpy(),
                               np.asarray(want["image_features"]), **FEAT_TOL)
    if text:
        toks = _tokens(tm.cfg.text_cfg.vocab_size)
        want = jax.jit(lambda p, t: jm.apply({"params": p}, t,
                                             method=jm.encode_text))(
            jparams, jnp.asarray(toks, jnp.int32))
        with torch.no_grad():
            got = tm.encode_text(torch.from_numpy(toks))
        np.testing.assert_allclose(got["text_features"].numpy(),
                                   np.asarray(want["text_features"]),
                                   **FEAT_TOL)


FINGERPRINTS = {
    "big_vision": ["params/img/embedding/kernel", "params/txt/Embed_0/x"],
    "big_vision_bare": ["img/embedding/kernel"],
    "mobileclip": ["image_encoder.model.patch_embed.0.x", "logit_scale"],
    "open_clip": ["visual.conv1.weight", "logit_scale"],
    "open_clip_ddp": ["module.visual.conv1.weight"],
    "timm_eva": ["cls_token", "blocks.0.attn.q_proj.weight"],
    "timm_vit": ["cls_token", "blocks.0.attn.qkv.weight"],
    "timm_convnext": ["stem.0.weight", "stages.0.blocks.0.conv_dw.weight"],
    "timm_trunk_in_open_clip": ["visual.trunk.cls_token", "logit_scale"],
    "unknown": ["foo.weight"],
}


@pytest.mark.parametrize("case", list(FINGERPRINTS))
def test_detect_format_equals_jax(case):
    sd = {k: np.zeros(1, np.float32) for k in FINGERPRINTS[case]}
    assert pconvert.detect_format(sd) == jconvert.detect_format(sd)


# (tower of test_torch_towers, head in the checkpoint); the features are
# compared once a tower
FEATURE_CASES = [("vit", "none"), ("eva", "clip"), ("convnext", "clip")]
TIMM_CASES = [("vit", "none"), ("vit", "clip"), ("eva", "clip"),
              ("eva", "in1k"), ("eva", "orig_names"), ("convnext", "clip"),
              ("convnext", "in1k")]


@functools.lru_cache(maxsize=None)
def _trunk(kind):
    """Another model's trunk under timm's names (read, never written)."""
    name, ov = _overrides(kind)
    src = create_model(name, device="cpu", seed=9, **ov).state_dict()
    prefix = "visual.trunk."
    return {k[len(prefix):]: v for k, v in src.items()
            if k.startswith(prefix)}


def _timm_state_dict(kind, head):
    """A bare timm checkpoint: ``_trunk(kind)`` with a CLIP projection
    head, a 1000-class head or none."""
    sd = dict(_trunk(kind))
    key = "head.fc" if kind == "convnext" else "head"
    width = sd["norm.weight" if kind != "convnext" else "head.norm.weight"
               ].shape[0]
    g = torch.Generator().manual_seed(5)
    if head in ("clip", "orig_names"):
        sd[f"{key}.weight"] = torch.randn(32, width, generator=g)
        sd[f"{key}.bias"] = torch.randn(32, generator=g)
    elif head == "in1k":
        sd[f"{key}.weight"] = torch.randn(1000, width, generator=g)
        sd[f"{key}.bias"] = torch.randn(1000, generator=g)
    if head == "orig_names":
        ren = {"fc1_g": "w1", "fc1_x": "w2", "norm": "ffn_ln", "fc2": "w3"}
        sd = {(k.replace(f"mlp.{a}.", f"mlp.{b}.") if ".mlp." in k else k): v
              for k, v in sd.items() for a, b in [next(
                  ((a, b) for a, b in ren.items() if f"mlp.{a}." in k),
                  ("", ""))]}
    return sd


@pytest.mark.parametrize("kind,head", TIMM_CASES,
                         ids=[f"{k}-{h}" for k, h in TIMM_CASES])
def test_bare_timm_checkpoint(tmp_path, kind, head):
    name, ov = _overrides(kind)
    jm, jp, tm = _pair(name, **ov)
    sd = _timm_state_dict(kind, head)
    want = jconvert.convert_state_dict(jm, jp, {k: v.numpy()
                                                for k, v in sd.items()})
    got = pconvert.convert_state_dict(tm, sd)
    _assert_state_equal(got, want)
    if head == "clip" and kind != "vit":   # the vit tower's head is an MLP
        assert torch.equal(got["visual.head.proj.weight"],
                           sd["head.fc.weight" if kind == "convnext"
                              else "head.weight"])
    path = tmp_path / "timm.pt"
    torch.save(sd, path)
    pckpt.load_checkpoint(tm, str(path))
    _assert_state_equal(tm.state_dict(), want)
    if (kind, head) in FEATURE_CASES:
        # the text tower is the model's own: the image side alone
        _assert_features_equal(jm, want, tm, _image_size(kind), text=False)


@pytest.mark.parametrize("fmt", ["timm_vit", "timm_eva", "timm_convnext"])
def test_bare_timm_checkpoint_needs_a_timm_tower(fmt):
    sd = {k: np.zeros(1, np.float32) for k in {
        "timm_vit": FINGERPRINTS["timm_vit"],
        "timm_eva": FINGERPRINTS["timm_eva"],
        "timm_convnext": FINGERPRINTS["timm_convnext"]}[fmt]}
    jm, jp = jax_random("ViT-Tiny-Test")
    tm = create_model("ViT-Tiny-Test", device="cpu")
    with pytest.raises(ValueError) as want:
        jconvert.convert_state_dict(jm, jp, sd)
    with pytest.raises(ValueError) as got:
        pconvert.convert_state_dict(tm, sd)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("variant", ["fused_qkv", "plain_mlp"])
def test_eva_variants_refused_as_jax(variant):
    from cosmos_tpu.models import eva as jeva
    from cosmos_tpu_torch.models import eva as peva

    sd = _timm_state_dict("eva", "none")
    if variant == "fused_qkv":
        sd["blocks.0.attn.qkv.weight"] = torch.zeros(1)
        err = NotImplementedError
    else:
        sd = {k.replace("mlp.fc1_g.", "mlp.fc1.").replace("mlp.fc1_x.",
                                                         "mlp.fcx."): v
              for k, v in sd.items()}
        err = KeyError
    with pytest.raises(err) as want:
        jeva.convert_timm_eva({k: v.numpy() for k, v in sd.items()},
                              "eva02_porttest")
    with pytest.raises(err) as got:
        peva.convert_timm_eva(sd, "eva02_porttest")
    assert str(got.value) == str(want.value)


def test_big_vision_is_refused_by_name(tmp_path):
    # a big_vision file loads into a SigLIP-shaped model, and a model
    # without SigLIP's towers refuses it, naming the SigLIP config
    from test_siglip_convert import make_bv_npz
    from test_torch_siglip import _bv_model_kw

    path = tmp_path / "siglip.npz"
    sd = make_bv_npz(np.random.default_rng(0))
    np.savez(path, **{f"params/{k}": v for k, v in sd.items()})
    tm = create_model("ViT-Tiny-Test", device="cpu")
    with pytest.raises(ValueError, match="SigLIP vision/text config"):
        pckpt.load_checkpoint(tm, str(path))
    model = create_model("ViT-B-16", device="cpu", **_bv_model_kw())
    pckpt.load_checkpoint(model, str(path))
    want = pconvert.convert_big_vision_siglip(model, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert torch.equal(model.visual.attn_pool.probe,
                       torch.from_numpy(sd["img/MAPHead_0/probe"]))


def _mobileclip_b_checkpoint():
    torch.manual_seed(5)
    img = TorchHybridViT()
    _randomize(img, 2)
    txt = _TorchText()
    for p in txt.parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape) * 0.05)
    sd = apple_sd(img)
    for k, v in txt.state_dict().items():
        k = k.replace("pre_norm_mha.1.in_proj_", "pre_norm_mha.1.qkv_proj.")
        sd["text_encoder." + k] = v.detach().numpy()
    sd["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    return sd


def _mobileclip_s_checkpoint():
    torch.manual_seed(3)
    return _mobileclip_checkpoint()[2]


@pytest.mark.parametrize("tower", list(MC_MODELS))
def test_mobileclip_train_form(tmp_path, tower):
    sd = (_mobileclip_s_checkpoint() if tower == "fastvit"
          else _mobileclip_b_checkpoint())
    assert pconvert.detect_format(sd) == "mobileclip"
    jm, jp, tm = _pair("ViT-Tiny-Test", **MC_MODELS[tower])
    want = jconvert.convert_state_dict(jm, jp, sd)
    got = pconvert.convert_state_dict(tm, {k: torch.from_numpy(np.asarray(v))
                                           for k, v in sd.items()})
    _assert_state_equal(got, want)
    path = tmp_path / "mobileclip.pt"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
               path)
    pckpt.load_checkpoint(tm, str(path))
    # exact weights; the towers' forwards against JAX's:
    # tests/test_torch_towers.py
    _assert_state_equal(tm.state_dict(), want)


def _message(fn, *args):
    with pytest.raises((ValueError, NotImplementedError, KeyError)) as e:
        fn(*args)
    return type(e.value), str(e.value)


@pytest.mark.parametrize("case", ["s0_text", "b_into_fastvit",
                                  "native_vit", "no_projection"])
def test_mobileclip_refusals_give_jax_messages(case):
    img = TorchMCi()
    _randomize(img, 4)
    sd = apple_state_dict(img)
    model_kw = MC_MODELS["fastvit"]
    if case == "s0_text":
        sd["text_encoder.some_conv_thing.weight"] = np.zeros(1)
    elif case == "b_into_fastvit":
        sd = {"image_encoder.model.patch_emb.0.block.conv.weight":
              np.zeros(1)}
    elif case == "native_vit":
        model_kw = {}
    else:
        sd = {k: v for k, v in sd.items() if ".head." not in k}
    jm, jp = jax_random("ViT-Tiny-Test", **model_kw)
    tm = create_model("ViT-Tiny-Test", device="cpu", **model_kw)
    want = _message(jconvert.convert_mobileclip, jp, sd)
    got = _message(pconvert.convert_mobileclip, tm, sd)
    assert got == want


def test_chip_smoke_writes_apple_keys_and_shapes():
    """chip_smoke.py's phase 20(c) writes MobileCLIP's train form itself:
    at fastvit_test's geometry its keys and shapes are the oracle's, and
    the port converts it."""
    import chip_smoke

    torch.manual_seed(3)
    img, txt, oracle = _mobileclip_checkpoint()
    text = dict(width=32, layers=2, context_length=16, vocab_size=49408)
    sd = chip_smoke.apple_mobileclip_state_dict(LAYERS, DIMS, text, 32,
                                                seed=1)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(np.shape(v)) for k, v in oracle.items()}
    bn_vars = [v for k, v in sd.items() if k.endswith("running_var")]
    assert bn_vars and all(bool((v > 0).all()) for v in bn_vars)
    _, _, tm = _pair("ViT-Tiny-Test", **MC_MODELS["fastvit"])
    pconvert.convert_state_dict(tm, sd)


@pytest.mark.parametrize("src,dst", [(14, 21), (7, 16)])
def test_chip_smoke_numpy_resize_equals_jax(src, dst):
    """phase 20(b) holds the loaded 336 px table to chip_smoke's float64
    numpy resize, JAX's matrices in float64."""
    import chip_smoke
    from cosmos_tpu.models.vit import _torch_bicubic_matrix

    pe = np.random.default_rng(src).standard_normal(
        (1 + src * src, 8)).astype(np.float32)
    m = _torch_bicubic_matrix(src, dst)
    grid = pe[1:].astype(np.float64).reshape(src, src, -1)
    want = np.einsum("ah,hwd,bw->abd", m, grid, m).reshape(dst * dst, -1)
    got = chip_smoke.bicubic_resize_np(pe, src, dst)
    np.testing.assert_allclose(got[1:], want, rtol=0, atol=1e-12)
    assert np.array_equal(got[:1], pe[:1].astype(np.float64))
