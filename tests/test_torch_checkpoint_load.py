"""The port's checkpoint load (cosmos_tpu_torch.models.checkpoint) against
cosmos_tpu.models.checkpoint on the same files: the position-table resizes,
a checkpoint at another image size (--pretrained with --force-image-size),
a plain-CLIP checkpoint in a COSMOS model, the CustomTextCLIP layout, both
forms of text_projection, rank-only reshapes, the refusals, flax .msgpack
files in float32 and bfloat16, TorchScript archives, and pickled modules.

Each JAX model's parameters are drawn with numpy from a seed at the
shapes jax.eval_shape gives (no JAX init is compiled), and the port model
starts from the same values through the bridge (state_dict_from_jax_params),
so the keys a checkpoint lacks keep the same values on both sides and the
whole state dict can be compared.
The resizes are held to 1e-6.  The bicubic one is F.interpolate on the port
side, which gives the float64 resize rounded to float32 (checked exactly),
and JAX's interpolation matrices in a float32 einsum on the other, which
rounds: about 1e-6 of the table's largest magnitude, so the tables here are
at the models' initial scale (normal, std width ** -0.5 of a width-768
tower).  Everything else is exact.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models import checkpoint as jckpt
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.factory import init_model_params
from cosmos_tpu.training.checkpoint import save_params_msgpack
from cosmos_tpu_torch.models import checkpoint as pckpt
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model

RESIZE_TOL = dict(atol=1e-6, rtol=0)
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_random(name, seed=3, **kw):
    """(JAX model, parameters drawn from ``seed`` with numpy at the shapes
    of JAX's init)."""
    jm, _ = jax_create_model(name, use_flash=False, init_params=False, **kw)
    shapes = jax.eval_shape(lambda: init_model_params(jm))
    rng = np.random.default_rng(seed)
    return jm, jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.2).astype(np.float32),
        shapes)


_PAIRS = {}


def pair(name, seed=3, **kw):
    """(JAX model, JAX parameters, port model holding the same weights);
    the models are built once a configuration, the port's weights set
    anew on every call."""
    key = (name, seed, tuple(sorted(kw.items())))
    if key not in _PAIRS:
        jm, jp = jax_random(name, seed, **kw)
        _PAIRS[key] = jm, jp, create_model(name, device="cpu", **kw)
    jm, jp, tm = _PAIRS[key]
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    return jm, jp, tm


def _pair(**kw):
    return pair("ViT-Tiny-Test", **kw)


def _source_state_dict(seed=7, **kw):
    """A reference-format state dict of random weights (a port model's)."""
    return create_model("ViT-Tiny-Test", device="cpu", seed=seed,
                        **kw).state_dict()


def _assert_loaded_equal(tm, jparams, tol=None):
    want = state_dict_from_jax_params(_np_tree(jparams))
    got = tm.state_dict()
    assert set(got) == set(want)
    for k in want:
        if tol is None:
            assert torch.equal(got[k], want[k].to(got[k].dtype)), k
        else:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       err_msg=k, **tol)


@pytest.mark.parametrize("src,dst", [(2, 4), (14, 21), (16, 7), (5, 5)])
def test_resize_pos_embed_equals_jax(src, dst):
    pe = (np.random.default_rng(src * 100 + dst).standard_normal(
        (1 + src * src, 24)) * 768 ** -0.5).astype(np.float32)
    want = jckpt.resize_pos_embed(pe, 1 + dst * dst)
    got = pckpt.resize_pos_embed(torch.from_numpy(pe), 1 + dst * dst)
    exact = pckpt.resize_pos_embed(torch.from_numpy(pe).double(),
                                   1 + dst * dst).float()
    assert got.shape == (1 + dst * dst, 24)
    assert torch.equal(got, exact)
    np.testing.assert_allclose(got.numpy(), want, **RESIZE_TOL)


@pytest.mark.parametrize("src,dst", [(77, 64), (16, 33), (77, 77), (10, 3)])
def test_resize_text_pos_embed_equals_jax(src, dst):
    pe = np.random.default_rng(src + dst).standard_normal(
        (src, 16)).astype(np.float32)
    want = jckpt.resize_text_pos_embed(pe, dst)
    got = pckpt.resize_text_pos_embed(torch.from_numpy(pe), dst)
    np.testing.assert_allclose(got.numpy(), want, **RESIZE_TOL)


@pytest.mark.parametrize("cosmos", [False, True], ids=["clip", "cosmos"])
def test_checkpoint_at_another_image_size(tmp_path, cosmos):
    """Fault 1: a 32 px checkpoint ([5, 32] position table) into a 64 px
    model ([17, 32]); the parent port's strict load raised."""
    kw = COSMOS if cosmos else {}
    path = tmp_path / "ckpt.pt"
    torch.save({"student": _source_state_dict(**kw)}, path)
    jm, jp, tm = _pair(vision_image_size=64, **kw)
    want = jckpt.load_checkpoint(jm, jp, str(path))
    pckpt.load_checkpoint(tm, str(path))
    assert tm.visual.positional_embedding.shape == (17, 32)
    _assert_loaded_equal(tm, want, RESIZE_TOL)


def test_text_table_resized_linearly(tmp_path):
    path = tmp_path / "ckpt.pt"
    torch.save(_source_state_dict(), path)
    jm, jp, tm = _pair(text_context_length=24)
    want = jckpt.load_checkpoint(jm, jp, str(path))
    pckpt.load_checkpoint(tm, str(path))
    assert tm.positional_embedding.shape == (24, 32)
    _assert_loaded_equal(tm, want, RESIZE_TOL)


def test_plain_clip_checkpoint_in_a_cosmos_model(tmp_path, caplog):
    """Fault 2: the COSMOS heads the file lacks keep their initial values,
    each warned about but distill_logit_scale; the parent port raised
    'Missing key(s)'."""
    path = tmp_path / "ckpt.pt"
    torch.save(_source_state_dict(), path)
    jm, jp, tm = _pair(**COSMOS)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    want = jckpt.load_checkpoint(jm, jp, str(path))
    with caplog.at_level(logging.WARNING):
        pckpt.load_checkpoint(tm, str(path))
    _assert_loaded_equal(tm, want)
    missing = [k for k in init if "cross_pool" in k or "token_mapping" in k]
    assert missing
    for k in missing + ["distill_logit_scale"]:
        assert torch.equal(tm.state_dict()[k], init[k]), k
    warned = {r.getMessage() for r in caplog.records}
    assert {f"missing torch key {k}" for k in missing} <= warned
    assert "missing torch key distill_logit_scale" not in warned


def test_strict_load_raises_on_a_missing_key(tmp_path):
    sd = _source_state_dict()
    del sd["visual.ln_post.bias"]
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path)
    jm, jp, tm = _pair()
    with pytest.raises(KeyError, match="missing torch key"):
        jckpt.load_checkpoint(jm, jp, str(path), strict=True)
    with pytest.raises(KeyError, match="missing torch key"):
        pckpt.load_checkpoint(tm, str(path), strict=True)


@pytest.mark.parametrize("key", ["visual.ln_post.weight",
                                 "transformer.resblocks.0.mlp.c_fc.weight"])
def test_a_shape_mismatch_raises(tmp_path, key):
    sd = _source_state_dict()
    sd[key] = torch.zeros(*sd[key].shape[:-1], sd[key].shape[-1] + 1)
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path)
    _, _, tm = _pair()
    with pytest.raises(ValueError, match=f"shape mismatch for {key}"):
        pckpt.load_checkpoint(tm, str(path))


@pytest.mark.parametrize("form", ["module_prefix", "custom_text",
                                  "rank_reshape", "state_dict_entry"])
def test_reference_layouts(tmp_path, form):
    sd = _source_state_dict()
    if form == "module_prefix":
        ckpt = {f"module.{k}": v for k, v in sd.items()}
    elif form == "custom_text":
        # CustomTextCLIP keeps its text tower under text.
        text = ("token_embedding", "positional_embedding", "transformer",
                "ln_final", "text_projection")
        ckpt = {(f"text.{k}" if k.startswith(text) else k): v
                for k, v in sd.items()}
    elif form == "rank_reshape":
        ckpt = dict(sd, logit_scale=sd["logit_scale"].reshape(1))
    else:
        ckpt = {"state_dict": sd, "epoch": 2}
    ckpt_path = tmp_path / "ckpt.pt"
    torch.save(ckpt, ckpt_path)
    jm, jp, tm = _pair()
    want = jckpt.load_checkpoint(jm, jp, str(ckpt_path))
    pckpt.load_checkpoint(tm, str(ckpt_path))
    _assert_loaded_equal(tm, want)
    for k, v in sd.items():
        assert torch.equal(tm.state_dict()[k], v), k


@pytest.mark.parametrize("model_form", ["matrix", "linear"])
def test_linear_text_projection(tmp_path, model_form):
    """A checkpoint whose text_projection is an nn.Linear: loaded into a
    proj_bias model, kept at its initial value (silently) in a bare-matrix
    one, as the JAX package does."""
    kw = {"text_proj_bias": True} if model_form == "linear" else {}
    sd = _source_state_dict()
    w = sd.pop("text_projection")
    sd["text_projection.weight"] = w.t().contiguous()
    sd["text_projection.bias"] = torch.linspace(-1, 1, w.shape[1])
    path = tmp_path / "ckpt.pt"
    torch.save(sd, path)
    jm, jp, tm = _pair(**kw)
    init = {k: v.clone() for k, v in tm.state_dict().items()}
    want = jckpt.load_checkpoint(jm, jp, str(path))
    pckpt.load_checkpoint(tm, str(path))
    _assert_loaded_equal(tm, want)
    got = tm.state_dict()
    if model_form == "linear":
        assert torch.equal(got["text_projection.weight"],
                           sd["text_projection.weight"])
        assert torch.equal(got["text_projection.bias"],
                           sd["text_projection.bias"])
    else:
        assert torch.equal(got["text_projection"], init["text_projection"])


def test_linear_text_projection_encodes_as_jax():
    jm, jp, tm = _pair(text_proj_bias=True)
    toks = np.zeros((2, 16), np.int32)
    toks[:, :4] = [[49406, 320, 1125, 49407], [49406, 777, 49407, 0]]
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t,
                                         method=jm.encode_text))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        got = tm.encode_text(torch.from_numpy(toks).long())
    np.testing.assert_allclose(got["text_features"].numpy(),
                               np.asarray(want["text_features"]),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flax_msgpack(tmp_path, dtype):
    """A file written by the JAX package's save_params_msgpack, in float32
    and in bfloat16 (whose dtype name numpy does not know)."""
    jm, jp, _ = _pair(**COSMOS)
    src = jax_random("ViT-Tiny-Test", seed=11, **COSMOS)[1]
    if dtype == "bfloat16":
        src = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), src)
    path = tmp_path / "params.msgpack"
    save_params_msgpack(src, str(path))
    want = state_dict_from_jax_params(
        jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), src))
    sd = pckpt.read_checkpoint(str(path))
    assert {str(v.dtype) for v in sd.values()} == {f"torch.{dtype}"}
    for k in want:
        assert torch.equal(sd[k].float(), want[k]), k
    _, _, tm = _pair(**COSMOS)
    pckpt.load_checkpoint(tm, str(path))
    loaded = jckpt.load_checkpoint(jm, jp, str(path))
    _assert_loaded_equal(tm, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), loaded))


def test_msgpack_needs_every_key(tmp_path):
    src = jax_random("ViT-Tiny-Test", seed=11)[1]
    path = tmp_path / "params.msgpack"
    save_params_msgpack(src, str(path))
    _, _, tm = _pair(**COSMOS)
    with pytest.raises(KeyError, match="missing torch key"):
        pckpt.load_checkpoint(tm, str(path))


def test_torchscript_archive_and_pickled_module(tmp_path):
    tm = create_model("ViT-Tiny-Test", device="cpu", seed=5)
    sd = tm.state_dict()
    ln = torch.nn.LayerNorm(32)
    ln.load_state_dict(tm.visual.ln_post.state_dict())
    scripted = torch.jit.script(ln)
    jit_path = tmp_path / "ln.pt"
    torch.jit.save(scripted, str(jit_path))
    got = pckpt.read_checkpoint(str(jit_path))
    assert set(got) == {"weight", "bias"}
    assert torch.equal(got["weight"], sd["visual.ln_post.weight"])
    pickled = tmp_path / "module.pt"
    torch.save(tm.visual.ln_post, pickled)
    with pytest.raises(ValueError, match="pickled nn.Module"):
        pckpt.read_checkpoint(str(pickled))
