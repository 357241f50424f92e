"""The port's timm-family towers (the timm ViT with and without the MCi
stem, EVA02, ConvNeXt, FastViT/MCi) and ModifiedResNet against
cosmos_tpu's, on the same weights through the weight bridge
(cosmos_tpu_torch.models.convert.state_dict_from_jax_params): the strict
load, the encoders, EVA02 at a non-native grid, the timm-layout keys
through JAX's convert_timm_{vit,eva,convnext}, ModifiedResNet's keys
against JAX's build_resnet_vision_map, the refusals, the LiT and
weight-decay masks, the shipped configs' parameter counts on the meta
device, the encoder export and the FLOPs report.

Each tower is a tiny geometry registered under the same name in both
packages (as JAX's own tower tests register theirs), with a text tower of
head dim 64, so the port's text self-attention takes the kernel route (on
the CPU, K1's plain version); the timm ViTs have head dim 64 too.  The JAX
side runs its XLA attention (use_flash=False).  Float32 throughout, at
tests/test_torch_model.py's F32_TOL.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.models import checkpoint as jckpt
from cosmos_tpu.models import config as jconfig
from cosmos_tpu.models import convnext as jconvnext
from cosmos_tpu.models import eva as jeva
from cosmos_tpu.models import fastvit as jfastvit
from cosmos_tpu.models import timm_model as jtimm
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.training import train as jtrain
from cosmos_tpu_torch.models import config as pconfig
from cosmos_tpu_torch.models import convnext as pconvnext
from cosmos_tpu_torch.models import eva as peva
from cosmos_tpu_torch.models import fastvit as pfastvit
from cosmos_tpu_torch.models import timm_model as ptimm
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.ops import fused_attention as pfa
from cosmos_tpu_torch.training.train import frozen_mask, wd_mask

F32_TOL = dict(atol=1e-4, rtol=1e-4)
TEXT = dict(embed_dim=32, text_width=128, text_heads=2, text_layers=1,
            text_context_length=16, text_vocab_size=256)
RN_CONFIG = "RN-Tiny-PortTest"

for _m in (jeva, peva):
    _m.register_eva("eva02_porttest", patch_size=8, width=32, layers=2,
                    heads=2, scale_mlp=True, scale_attn=True, image_size=32)
for _m in (jconvnext, pconvnext):
    _m.register_convnext("convnext_porttest", depths=(1, 1, 2, 1),
                         dims=(8, 16, 32, 64))
for _m in (jfastvit, pfastvit):
    _m.register_fastvit("fastvit_porttest", layers=(1, 1, 2, 1),
                        dims=(8, 16, 32, 64))
for _m in (jtimm, ptimm):
    _m.register_timm_vit("vit_porttest", patch_size=8, width=128, layers=1,
                         heads=2, image_size=32)
    _m.register_timm_vit("vit_mci_porttest", patch_size=16, width=128,
                         layers=1, heads=2, image_size=32,
                         stem_channels=(32, 64, 128), no_embed_class=True)

# tower -> (shipped config it is cut from, overrides); each shipped head
# kind and pool appears once
TOWERS = {
    "vit": ("MobileCLIP-B", dict(vision_timm_model_name="vit_porttest",
                                 vision_image_size=32, vision_timm_pool="avg",
                                 vision_timm_proj="mlp",
                                 vision_timm_proj_bias=True)),
    "vit_mci": ("MobileCLIP-B", dict(vision_timm_model_name="vit_mci_porttest",
                                     vision_image_size=32)),
    "eva": ("EVA02-B-16", dict(vision_timm_model_name="eva02_porttest",
                               vision_image_size=32)),
    "convnext": ("convnext_base_w", dict(
        vision_timm_model_name="convnext_porttest", vision_image_size=64)),
    "fastvit": ("MobileCLIP-S1", dict(vision_timm_model_name="fastvit_porttest",
                                      vision_image_size=64)),
    "resnet": (RN_CONFIG, {}),
}
SHIPPED = ["EVA02-B-16", "EVA02-L-14", "convnext_base_w", "convnext_large_d",
           "MobileCLIP-S1", "MobileCLIP-S2", "MobileCLIP-B"]


def register_config(directory, name, vision_cfg, vocab_size=256):
    """A CLIP config of this vision tower and the tiny text tower,
    registered in both packages."""
    path = directory / f"{name}.json"
    path.write_text(json.dumps({
        "embed_dim": 32, "vision_cfg": vision_cfg,
        "text_cfg": {"context_length": 16, "vocab_size": vocab_size,
                     "width": 128, "heads": 2, "layers": 1}}))
    jconfig.add_model_config(path)
    pconfig.add_model_config(path)


@pytest.fixture(scope="module", autouse=True)
def _rn_config(tmp_path_factory):
    """A tiny ModifiedResNet CLIP config."""
    register_config(tmp_path_factory.mktemp("configs"), RN_CONFIG,
                    {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8})


def _overrides(kind):
    name, ov = TOWERS[kind]
    return name, ({} if kind == "resnet" else dict(TEXT, **ov))


def _image_size(kind):
    return 64 if kind in ("convnext", "fastvit", "resnet") else 32


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def towers():
    """kind -> (jax model, jax params, port model with the same weights)."""
    out = {}
    for kind in TOWERS:
        name, ov = _overrides(kind)
        jm, jp = H.jax_create_fast(name, use_flash=False, seed=1, **ov)
        tm = create_model(name, device="cpu", **ov)
        tm.load_state_dict(state_dict_from_jax_params(_np_tree(jp)),
                           strict=True)
        out[kind] = (jm, jp, tm)
    return out


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


def _jax_encode_image(jm, jp, x):
    fn = jax.jit(lambda p, im: jm.apply({"params": p}, im, False,
                                        method=jm.encode_image))
    return {k: np.asarray(v) for k, v in fn(jp, jnp.asarray(x)).items()}


@pytest.mark.parametrize("kind", list(TOWERS))
def test_bridge_gives_every_parameter(towers, kind):
    _, jp, tm = towers[kind]
    sd = state_dict_from_jax_params(_np_tree(jp))
    want = tm.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        assert sd[k].shape == v.shape, k
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    assert n_jax == sum(p.numel() for p in tm.parameters())


@pytest.mark.parametrize("kind", list(TOWERS))
def test_encode_image(towers, kind):
    jm, jp, tm = towers[kind]
    x = _images(2, _image_size(kind), 0)
    want = _jax_encode_image(jm, jp, x)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert set(got) == set(want) == {"image_features", "image_tokens_raw"}
    for k in want:
        g, w = got[k].numpy(), want[k]
        assert g.shape == w.shape
        # the random deploy-form FastViT gives features of magnitude 1e-3:
        # its tolerance is taken relative to the largest value
        scale = max(1.0, 1.0 / np.abs(w).max()) if kind == "fastvit" else 1.0
        np.testing.assert_allclose(g * scale, w * scale, **F32_TOL)


def test_encode_text_through_the_kernel_route(towers, monkeypatch):
    """The text tower beside a timm tower: every self-attention through K1's
    wrapper (its plain version on the CPU)."""
    jm, jp, tm = towers["eva"]
    rng = np.random.default_rng(3)
    toks = rng.integers(1, 255, (3, 16)).astype(np.int64)
    toks[np.arange(3), [5, 9, 15]] = 255            # EOT, the highest id
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t, True,
                                         method=jm.encode_text))(
        jp, jnp.asarray(toks, jnp.int32))["text_features"]
    calls = []
    orig = pfa.fused_attention_qkv

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    monkeypatch.setattr("cosmos_tpu_torch.models.attention."
                        "fused_attention_qkv", counted)
    with torch.no_grad():
        got = tm.encode_text(torch.from_numpy(toks), True)["text_features"]
    assert len(calls) == 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


def test_timm_vit_runs_k1(towers, monkeypatch):
    """The timm ViT trunk's blocks take K1's route, as JAX's
    VisionTransformer trunk takes its fused kernel."""
    _, _, tm = towers["vit_mci"]
    calls = []
    orig = pfa.fused_attention_qkv

    def counted(*a, **kw):
        calls.append(tuple(a[0].shape))
        return orig(*a, **kw)

    monkeypatch.setattr("cosmos_tpu_torch.models.attention."
                        "fused_attention_qkv", counted)
    with torch.no_grad():
        tm.encode_image(torch.from_numpy(_images(2, 32, 4)))
    assert calls == [(2, 5, 384)]


def test_eva_at_a_non_native_grid(towers):
    """48 px against the native 32: the position table resampled with
    antialiasing and the rope tables built for grid 6 on both sides."""
    jm, jp, tm = towers["eva"]
    x = _images(2, 48, 5)
    want = _jax_encode_image(jm, jp, x)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    assert got["image_tokens_raw"].shape == (2, 37, 32)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32_TOL)


@pytest.mark.parametrize("grid,native", [(4, 4), (6, 4), (14, 16)])
def test_rope_tables_equal_jax(grid, native):
    for got, want in zip(peva.rope_2d_tables(grid, native, 64),
                         jeva.rope_2d_tables(grid, native, 64)):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("kind,convert,name", [
    ("vit", jtimm.convert_timm_vit, "vit_porttest"),
    ("eva", jeva.convert_timm_eva, "eva02_porttest"),
    ("convnext", jconvnext.convert_timm_convnext, "convnext_porttest")])
def test_timm_keys_round_trip_through_jax_converters(towers, kind, convert,
                                                     name):
    _, jp, tm = towers[kind]
    prefix = "visual.trunk."
    sd = {k[len(prefix):]: v.numpy() for k, v in tm.state_dict().items()
          if k.startswith(prefix)}
    got = _np_tree(convert(sd, name))
    want = _np_tree(jp["visual"]["trunk"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    assert set(flat_got) == set(flat_want)
    for path, value in flat_want.items():
        assert np.array_equal(flat_got[path], value), path


def test_resnet_keys_equal_build_resnet_vision_map(towers):
    _, jp, tm = towers["resnet"]
    want = {key for key, _, _ in
            jckpt.build_resnet_vision_map(jp["visual"])}
    got = {k for k in tm.state_dict() if k.startswith("visual.")}
    assert got == want


def test_head_keys_are_open_clip_names(towers):
    keys = {kind: {k for k in towers[kind][2].state_dict()
                   if k.startswith("visual.head.")}
            for kind in ("vit", "eva")}
    assert keys["vit"] == {"visual.head.mlp.fc1.weight",
                           "visual.head.mlp.fc1.bias",
                           "visual.head.mlp.fc2.weight",
                           "visual.head.mlp.fc2.bias"}
    assert keys["eva"] == {"visual.head.proj.weight"}


@pytest.mark.parametrize("kind", list(TOWERS))
def test_masks_equal_jax(towers, kind):
    """Weight decay and --lock-image on each tower: the port's masks over
    its names equal JAX's over its tree, through the bridge's map."""
    from cosmos_tpu_torch.models.convert import (build_name_map,
                                                 vision_entries)

    _, jp, tm = towers[kind]
    path_of = {k: p for k, p, _ in build_name_map(0, 1)
               + vision_entries(_np_tree(jp["visual"]))}

    def at(tree, path):
        for p in path:
            tree = tree[p]
        return bool(tree)

    jax_wd = jtrain.wd_mask(jp)
    jax_lock = jtrain.frozen_mask(jp, lock_image=True)
    port_wd, port_lock = wd_mask(tm), frozen_mask(tm, lock_image=True)
    assert set(port_wd) == set(port_lock) == set(tm.state_dict())
    for name in port_wd:
        assert port_wd[name] == at(jax_wd, path_of[name]), name
        assert port_lock[name] == at(jax_lock, path_of[name]), name
    assert all(port_lock[n] for n in port_lock if n.startswith("visual."))


def _refusal(kind, **ov):
    name, base = _overrides(kind)
    return name, dict(base, **ov)


REFUSALS = {
    # name: (config, overrides, create_model flags, JAX's error, port's)
    "token pool on ConvNeXt": (*_refusal("convnext", vision_timm_pool="token"),
                               {}, ValueError),
    "token pool on FastViT": (*_refusal("fastvit", vision_timm_pool="token"),
                              {}, ValueError),
    "drop path on EVA02": (*_refusal("eva", vision_timm_drop_path=0.1), {},
                           NotImplementedError),
    "drop path on FastViT": (*_refusal("fastvit", vision_timm_drop_path=0.1),
                             {}, NotImplementedError),
    "drop path on the ViT": (*_refusal("vit", vision_timm_drop_path=0.1), {},
                             NotImplementedError),
    "head dropout": (*_refusal("eva", vision_timm_drop=0.1), {},
                     NotImplementedError),
    "unknown trunk": (*_refusal("eva", vision_timm_model_name="vit_nope"), {},
                      NotImplementedError),
    "cosmos on a timm tower": (*_refusal("eva"), dict(cosmos=True),
                               ValueError),
    "output_all on a timm tower": (*_refusal("eva"), dict(output_all=True),
                                   ValueError),
    "attentional_pool on a timm tower": (*_refusal("eva"),
                                         dict(attentional_pool=True),
                                         ValueError),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_refusals_raise_in_both(case):
    name, ov, flags, err = REFUSALS[case]
    with pytest.raises(err):
        jax_create_model(name, use_flash=False, **flags, **ov)
    with pytest.raises(err):
        create_model(name, device="cpu", **flags, **ov)


@pytest.mark.parametrize("kind", ["eva", "resnet"])
def test_csa_and_unlocked_groups_raise_in_both(towers, kind):
    jm, jp, tm = towers[kind]
    x = _images(1, _image_size(kind), 6)
    with pytest.raises(NotImplementedError):
        jm.apply({"params": jp}, jnp.asarray(x), False, True,
                 method=jm.encode_image)
    with pytest.raises(NotImplementedError):
        tm.encode_image(torch.from_numpy(x), csa=True)
    with pytest.raises(ValueError):
        jtrain.frozen_mask(jp, lock_image=True, unlocked_groups=1)
    with pytest.raises(ValueError):
        frozen_mask(tm, lock_image=True, unlocked_groups=1)


def test_segmentation_refuses_towers_in_both(towers):
    """JAX's segmentor fails on a timm tower (no visual proj), the port's
    refuses it at construction."""
    from cosmos_tpu.data.tokenizer import SimpleTokenizer
    from cosmos_tpu.segmentation.segmentor import (
        CLIPSegmentor as JaxSegmentor)
    from cosmos_tpu_torch.models.factory import get_tokenizer
    from cosmos_tpu_torch.segmentation import CLIPSegmentor

    jm, jp, tm = towers["eva"]
    names = ["sky", "tree"]
    with pytest.raises(NotImplementedError, match="CLIP ViT tower"):
        CLIPSegmentor(tm, get_tokenizer(), names)
    seg = JaxSegmentor(jm, jp, SimpleTokenizer(context_length=16), names,
                       slide_crop=32, slide_stride=32)
    with pytest.raises(KeyError, match="proj"):
        seg.forward_slide(np.zeros((32, 32, 3), np.uint8))


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_configs_count_jax_parameters_on_meta(name):
    jm, _ = jax_create_model(name, init_params=False)
    v, t = jm.cfg.vision_cfg, jm.cfg.text_cfg
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jnp.zeros((1, v.image_size, v.image_size, 3)),
        jnp.zeros((1, t.context_length), jnp.int32))["params"]

    def count(tree):
        return sum(int(np.prod(x.shape))
                   for x in jax.tree_util.tree_leaves(tree))

    tm = create_model(name, device="meta")
    assert next(tm.parameters()).device.type == "meta"
    visual = sum(p.numel() for p in tm.visual.parameters())
    total = sum(p.numel() for p in tm.parameters())
    assert (visual, total - visual) == (count(shapes["visual"]),
                                        count(shapes) - count(
                                            shapes["visual"]))


def test_trace_exports_a_tower(towers):
    from cosmos_tpu_torch.models.trace import trace_model

    _, _, tm = towers["eva"]
    programs = trace_model(tm, batch_size=2)
    x = torch.from_numpy(_images(2, 32, 7))
    with torch.no_grad():
        got = programs["encode_image"].module()(x)
        want = tm.encode_image(x, True)["image_features"]
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_profiler_counts_a_conv_tower():
    """The FLOPs report on ConvNeXt: FlopCounterMode counts the convs by
    torch's formulas (2 x output elements x kernel taps x in-channels per
    group) beside the matmuls."""
    from cosmos_tpu_torch.training.profiler import _flops, profile_model

    name, ov = _overrides("convnext")
    row = profile_model(name, device="cpu", **ov)
    tm = create_model(name, device="cpu", **ov)
    assert row["mparams"] == round(
        sum(p.numel() for p in tm.parameters()) / 1e6, 2)
    stem = tm.visual.trunk.stem[0]
    x = torch.zeros(1, 64, 64, 3)
    stem_flops = _flops(stem, x)
    assert stem_flops == 2 * (16 * 16 * 8) * (4 * 4 * 3)
    assert _flops(tm.encode_image, x) > 10 * stem_flops


def test_native_vit_avg_pool_equals_jax():
    """The native ViT's ``avg`` pooling (the trainer's --pool-type), which
    the port took on with the timm ViT trunk's pooling."""
    ov = dict(embed_dim=32, vision_width=128, vision_head_width=64,
              vision_image_size=32, vision_patch_size=8, vision_layers=2,
              vision_pool_type="avg", **{k: v for k, v in TEXT.items()
                                         if k != "embed_dim"})
    jm, jp = H.jax_create_fast("ViT-Tiny-Test", use_flash=False, seed=4, **ov)
    tm = create_model("ViT-Tiny-Test", device="cpu", **ov)
    tm.load_state_dict(state_dict_from_jax_params(_np_tree(jp)), strict=True)
    x = _images(2, 32, 8)
    want = _jax_encode_image(jm, jp, x)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], **F32_TOL)
