"""The port's CLIP (cosmos_tpu_torch.models) against cosmos_tpu's on the same
weights: the weight bridge, the encoders, the eval forward and the COSMOS
forward with local crops at a tiny head-dim-64 geometry, one full-width
ViT-B-16 encode, and reference-checkpoint loading.

The JAX side runs with use_flash=True, so its self-attention is the Pallas
kernel in interpret mode; the port's runs the kernel wrapper's CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.models.checkpoint import params_to_torch_state_dict
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.vit import interpolate_pos_embed as jax_interp
from cosmos_tpu.training.zero_shot import truncate_to_eot
from cosmos_tpu_torch import create_model, load_checkpoint
from cosmos_tpu_torch.models.checkpoint import read_checkpoint
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.vit import interpolate_pos_embed

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
# ViT-Tiny-Test has head dim 16, which the kernel does not take; these
# overrides give both towers head dim 64 so the kernel path runs
TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)
EOT = 49407
# f32 on both sides: XLA's and torch's CPU kernels sum in other orders;
# measured differences are ~3e-6 on token outputs of magnitude ~4
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


def _tokens(n, length, seed, eot_lo, eot_hi):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, length), np.int64)
    for i, e in enumerate(rng.integers(eot_lo, eot_hi + 1, n)):
        toks[i, 0] = 49406
        toks[i, 1:e] = rng.integers(1, 49000, e - 1)
        toks[i, e] = EOT
    return toks


def _images(n, size, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, size, size, 3)).astype(np.float32)


# XLA's CPU compiler without its optimisation passes: the same functions,
# compiled in about half the time
FAST_XLA = {"xla_backend_optimization_level": 0}


def _port(name, precision, jp, **overrides):
    """The port's model built on the meta device, taking JAX's weights
    whole (it has no buffers, so nothing is left uninitialised)."""
    tm = create_model(name, precision, device="meta", **COSMOS,
                      **overrides).to_empty(device="cpu")
    tm.load_state_dict(
        state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp)),
        strict=True)
    return tm


def _pair(name, precision, **overrides):
    """(jax model, jax params, port model with the same weights)."""
    jm, jp = H.jax_create_fast(name, precision=precision, use_flash=True,
                               **COSMOS, **dict(overrides))
    return jm, jp, _port(name, precision, jp, **overrides)


def _drawn_params(jm, seed):
    """Parameters at the shapes JAX's init gives (``jax.eval_shape``, no
    init compiled or run), drawn with numpy as the init draws them: normal
    weights of std 0.02, LayerNorm scales near 1."""
    c = jm.cfg
    shapes = jax.eval_shape(
        lambda key, x, y: jm.init(key, x, y, batch_size=1)["params"],
        jax.random.PRNGKey(0),
        jnp.zeros((1, c.vision_cfg.image_size, c.vision_cfg.image_size, 3),
                  jnp.float32),
        jnp.zeros((1, c.text_cfg.context_length), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32) * np.float32(
            0.02)
        last = str(path[-1])
        return x + np.float32(1.0) if "scale" in last and x.ndim == 1 else x
    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def tiny():
    return _pair("ViT-Tiny-Test", "fp32", **TINY)


def test_bridge_equals_params_to_torch_state_dict(tiny):
    _, jp, tm = tiny
    got = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    want = params_to_torch_state_dict(jp)
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        assert np.array_equal(got[k].numpy(), v), k
    assert set(got) == set(tm.state_dict())


def test_encode_image(tiny):
    jm, jp, tm = tiny
    x = _images(3, 64, 0)
    want = jm.apply({"params": jp}, jnp.asarray(x), True,
                    method=jm.encode_image)
    with torch.no_grad():
        got = tm.encode_image(torch.from_numpy(x), normalize=True)
    assert set(got) == set(want) == {"image_features", "image_tokens"}
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **F32_TOL)


@pytest.mark.parametrize("truncate", [False, True])
def test_encode_text(tiny, truncate):
    jm, jp, tm = tiny
    toks = _tokens(4, 16, 1, 3, 6)
    if truncate:
        toks = truncate_to_eot(toks, multiple=4)
        assert toks.shape[1] == 8
    want = jm.apply({"params": jp}, jnp.asarray(toks, jnp.int32), False,
                    method=jm.encode_text)
    with torch.no_grad():
        got = tm.encode_text(torch.from_numpy(toks), normalize=False)
    assert set(got) == set(want) == {"text_features", "text_tokens"}
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **F32_TOL)


def test_eval_forward(tiny):
    jm, jp, tm = tiny
    g, toks = _images(2, 64, 2), _tokens(2, 16, 3, 4, 14)
    want = jm.apply({"params": jp}, jnp.asarray(g),
                    jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(g), torch.from_numpy(toks))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **F32_TOL)


def test_cosmos_forward_with_local_crops(tiny):
    """2 global 64px crops + 2 local 32px crops (position embedding
    interpolated from grid 4 to 2) + 4 caption views, batch 2."""
    jm, jp, tm = tiny
    b = 2
    g, loc = _images(2 * b, 64, 4), _images(2 * b, 32, 5)
    toks = _tokens(4 * b, 16, 6, 3, 15)
    want = jm.apply({"params": jp}, jnp.asarray(g),
                    jnp.asarray(toks, jnp.int32), jnp.asarray(loc),
                    batch_size=b)
    with torch.no_grad():
        got = tm(torch.from_numpy(g), torch.from_numpy(toks),
                 torch.from_numpy(loc), batch_size=b)
    assert set(got) == set(want)
    assert got["img_crossmodal_features"].shape == (4 * b, 64)
    assert got["txt_crossmodal_features"].shape == (4 * b, 64)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), **F32_TOL)


@pytest.mark.parametrize("src,dst", [(4, 2), (14, 6), (7, 9)])
def test_interpolate_pos_embed(src, dst):
    pe = np.random.default_rng(src * dst).standard_normal(
        (1 + src * src, 32)).astype(np.float32)
    want = jax_interp(jnp.asarray(pe), (src, src), (dst, dst))
    got = interpolate_pos_embed(torch.from_numpy(pe), (src, src), (dst, dst))
    assert got.shape == (1 + dst * dst, 32)
    # float32 bicubic weights (torch) against float64 weights rounded to
    # float32 (the JAX package's matrix): 16 taps of weight error ~6e-8
    # relative on inputs |x| < 5 bound the difference near 1e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-6)


def test_bf16_encoders():
    jm, jp, tm = _pair("ViT-Tiny-Test", "bf16", **TINY)
    x, toks = _images(2, 64, 7), _tokens(2, 16, 8, 3, 12)
    want_i = jm.apply({"params": jp}, jnp.asarray(x), True,
                      method=jm.encode_image)["image_features"]
    want_t = jm.apply({"params": jp}, jnp.asarray(toks, jnp.int32), True,
                      method=jm.encode_text)["text_features"]
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(x), True)["image_features"]
        got_t = tm.encode_text(torch.from_numpy(toks), True)["text_features"]
    assert got_i.dtype == got_t.dtype == torch.bfloat16
    # bf16 rounds after every matmul on both sides, in places that differ
    # by one ulp; over two layers the normalised features (|x| < 0.5)
    # measured within 3e-3
    np.testing.assert_allclose(_np(got_i), _np(want_i), atol=1e-2)
    np.testing.assert_allclose(_np(got_t), _np(want_t), atol=1e-2)


def test_full_width_vit_b16_encoders():
    """The real geometry once: ViT-B-16 COSMOS, f32, batch 2 (vision L=197
    with 12 heads, text L=77 causal with 8 heads)."""
    jm, _ = jax_create_model("ViT-B-16", precision="fp32", use_flash=True,
                             init_params=False, **COSMOS)
    jp = _drawn_params(jm, seed=3)
    tm = _port("ViT-B-16", "fp32", jp)
    x, toks = _images(2, 224, 9), _tokens(2, 77, 10, 5, 40)

    def run(method, key, inp):
        fn = jax.jit(lambda p, a: jm.apply({"params": p}, a, False,
                                           method=method)[key])
        return fn.lower(jp, inp).compile(FAST_XLA)(jp, inp)

    want_i = run(jm.encode_image, "image_features", jnp.asarray(x))
    want_t = run(jm.encode_text, "text_features",
                 jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(x))["image_features"]
        got_t = tm.encode_text(torch.from_numpy(toks))["text_features"]
    assert got_i.shape == got_t.shape == (2, 512)
    # twelve f32 layers of 768/512 width: summation-order differences grow
    # to ~1e-5 on unnormalised features of magnitude ~1
    np.testing.assert_allclose(_np(got_i), _np(want_i), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(got_t), _np(want_t), atol=2e-4, rtol=2e-4)


def test_load_checkpoint_student_teacher(tmp_path, tiny):
    _, _, tm = tiny
    sd = tm.state_dict()
    teacher = {k: v + 1.0 for k, v in sd.items()}
    path = tmp_path / "epoch_3.pt"
    torch.save({"epoch": 3, "name": "tiny",
                "student": {f"module.{k}": v for k, v in sd.items()},
                "teacher": {f"module.{k}": v for k, v in teacher.items()}},
               path)
    for which, want in (("student", sd), ("teacher", teacher)):
        got = read_checkpoint(str(path), which=which)
        assert list(got) == list(want)
        for k in want:
            assert torch.equal(got[k], want[k]), k
    m = create_model("ViT-Tiny-Test", device="cpu", seed=1, **COSMOS, **TINY)
    load_checkpoint(m, str(path), which="teacher", strict=True)
    assert torch.equal(m.logit_scale, teacher["logit_scale"])


def test_create_model_seed_and_dtype():
    a = create_model("ViT-B-32", "bf16", device="cpu", seed=5,
                     vision_layers=1, text_layers=1)
    b = create_model("ViT-B-32", "bf16", device="cpu", seed=5,
                     vision_layers=1, text_layers=1)
    c = create_model("ViT-B-32", "bf16", device="cpu", seed=6,
                     vision_layers=1, text_layers=1)
    for (k, va), vb, vc in zip(a.state_dict().items(),
                               b.state_dict().values(),
                               c.state_dict().values()):
        assert va.dtype == torch.float32, k
        assert torch.equal(va, vb), k
    assert not torch.equal(a.visual.proj, c.visual.proj)
    assert a.visual.transformer.resblocks[0].attn.num_heads == 12
    assert a.visual.patch_size == 32 and not a.training
    out = a.encode_image(torch.zeros(1, 224, 224, 3))["image_features"]
    assert out.dtype == torch.bfloat16 and out.shape == (1, 512)
