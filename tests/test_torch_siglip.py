"""The SigLIP-shaped towers of the port (cosmos_tpu_torch/models/vit.py's
``MAPHead``, ``sincos_2d_pos_embed`` and the native ViT's options; the
big_vision converter of models/convert.py) against cosmos_tpu's, on the CPU:

  - the sin-cos table, bit for bit, and kept out of the parameters;
  - ``MAPHead`` against JAX's and a numpy transcription of big_vision's
    pooling;
  - ``encode_image`` in option combinations that cover every value of every
    option of the native ViT, on the kernel path (K1's plain version) and
    with ``use_flash=False``, and the full COSMOS forward failing where
    JAX's does;
  - ``ViT-B-16-SigLIP``'s leaf shapes, the big_vision load path and the
    weight bridge's keys;
  - one ``--siglip`` step with patch dropout (both sides given the same
    kept tokens) against JAX's ``make_train_step``.

Widths: a tiny ViT-B-16 layout at head dim 64, so K1 and K2 take the
self-attentions; float32 throughout, compared within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.models import vit as jvit
from cosmos_tpu.models.checkpoint import params_to_torch_state_dict
from cosmos_tpu.models.convert import convert_state_dict as jax_convert
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import create_model, create_optimizer, \
    create_train_state, make_train_step
from cosmos_tpu_torch.models import checkpoint as pckpt
from cosmos_tpu_torch.models import vit as pvit
from cosmos_tpu_torch.models.convert import (build_name_map,
                                             state_dict_from_jax_params)
from cosmos_tpu_torch.models.factory import get_tokenizer
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig, wd_mask
from test_siglip_convert import make_bv_npz

TOL = dict(rtol=1e-5, atol=1e-5)
# head dim 64: the port's self-attentions take K1 (and K2)
KERNEL = dict(R.TINY, embed_dim=128, vision_width=128, vision_head_width=64,
              text_width=128, text_heads=2)
SIGLIP_MODEL = dict(KERNEL, **R.SIGLIP_TOWERS)


def jax_model(kw, seed=1, scale=0.1):
    """JAX's ViT-B-16 with the overrides ``kw`` and parameters drawn with
    numpy at the shapes ``jax.eval_shape`` gives (no JAX init is compiled;
    a model JAX cannot initialise raises as its init would)."""
    jm, _ = jax_create_model("ViT-B-16", use_flash=False, init_params=False,
                             **kw)
    v, t = jm.cfg.vision_cfg, jm.cfg.text_cfg
    extra = ({"batch_size": 1} if v.output_all and v.attentional_pool
             else {})
    shapes = jax.eval_shape(
        lambda key, x, y: jm.init(key, x, y, **extra)["params"],
        jax.random.PRNGKey(0),
        jnp.zeros((1, v.image_size, v.image_size, 3), jnp.float32),
        jnp.zeros((1, t.context_length), jnp.int32))
    rng = np.random.default_rng(seed)
    return jm, jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        shapes)


def jax_apply(jm, params, *args, **kw):
    """``jm.apply`` jitted: one compile in place of an eager compile of
    every op."""
    return jax.jit(lambda p, *a: jm.apply({"params": p}, *a, **kw))(
        params, *args)


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _port(kw, init, **extra):
    model = create_model("ViT-B-16", device="cpu", **kw, **extra).eval()
    model.load_state_dict(init, strict=True)
    return model


def _close(got, want, what=""):
    w = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), w, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
        err_msg=what)


# --- the sin-cos table -------------------------------------------------------

@pytest.mark.parametrize("cls", [True, False])
@pytest.mark.parametrize("dim,grid", [(8, 1), (32, 2), (64, 7), (768, 14)])
def test_sincos_table_equals_jax(dim, grid, cls):
    np.testing.assert_array_equal(pvit.sincos_2d_pos_embed(dim, grid, cls),
                                  jvit.sincos_2d_pos_embed(dim, grid, cls))


def test_sincos_table_is_a_constant():
    kw = dict(KERNEL, vision_pos_embed_type="sin_cos_2d",
              vision_class_token=False)
    model = create_model("ViT-B-16", device="cpu", **kw)
    table = model.visual.positional_embedding
    assert not isinstance(table, torch.nn.Parameter)
    np.testing.assert_array_equal(table.numpy(),
                                  jvit.sincos_2d_pos_embed(128, 2, False))
    names = ("visual.positional_embedding",)
    assert not set(names) & set(dict(model.named_parameters()))
    assert not set(names) & set(wd_mask(model))
    assert not set(names) & set(model.state_dict())
    assert all(p is not table for p in create_optimizer(
        model, scheduler.const_lr(1e-3, 0, 10)).param_groups[0]["params"])


# --- MAPHead -------------------------------------------------------------------

def _bigvision_map(sd, x, heads):
    """big_vision's MAP pooling, transcribed in numpy from its npz layout
    (erf GELU)."""
    from math import erf

    mp = "img/MAPHead_0"
    att = f"{mp}/MultiHeadDotProductAttention_0"
    b, n, d = x.shape
    hd = d // heads

    def proj(v, name):
        return (v @ sd[f"{att}/{name}/kernel"].reshape(d, d)
                + sd[f"{att}/{name}/bias"].reshape(-1))

    probe = np.broadcast_to(sd[f"{mp}/probe"][0], (b, 1, d))
    q = proj(probe, "query").reshape(b, 1, heads, hd)
    k = proj(x, "key").reshape(b, n, heads, hd)
    v = proj(x, "value").reshape(b, n, heads, hd)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
    w = np.exp(logits - logits.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    o = np.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, 1, d)
    o = o @ sd[f"{att}/out/kernel"].reshape(d, d) + sd[f"{att}/out/bias"]
    y = (o - o.mean(-1, keepdims=True)) / np.sqrt(o.var(-1, keepdims=True)
                                                  + 1e-5)
    y = y * sd[f"{mp}/LayerNorm_0/scale"] + sd[f"{mp}/LayerNorm_0/bias"]
    h = y @ sd[f"{mp}/MlpBlock_0/Dense_0/kernel"] \
        + sd[f"{mp}/MlpBlock_0/Dense_0/bias"]
    h = 0.5 * h * (1.0 + np.vectorize(erf)(h / np.sqrt(2.0)))
    o = o + h @ sd[f"{mp}/MlpBlock_0/Dense_1/kernel"] \
        + sd[f"{mp}/MlpBlock_0/Dense_1/bias"]
    return o[:, 0]


def test_map_head_equals_jax_and_big_vision():
    from test_siglip_convert import D, H

    sd = make_bv_npz(np.random.default_rng(2))
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, D)).astype(np.float32)
    jm, jp = jax_model(_bv_model_kw())
    tree = jax_convert(jm, jp, sd)["visual"]["attn_pool"]
    head_j = jvit.MAPHead(num_heads=H)
    want = jax.jit(lambda p, v: head_j.apply({"params": p}, v))(
        tree, jnp.asarray(x))
    head = pvit.MAPHead(D, H)
    head.load_state_dict({k[len("visual.attn_pool."):]: v for k, v in _sd(
        {"visual": {"attn_pool": tree}, "text": {}}).items()}, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    _close(got, want, "MAPHead vs JAX")
    _close(got, _bigvision_map(sd, x.astype(np.float64), H),
           "MAPHead vs big_vision")


# --- the tower's options ---------------------------------------------------------

# (class_token, pool_type, no_proj, patch_bias, final_ln_after_pool,
#  pos_embed_type): every value of every option at least once
OPTION_CASES = {
    "siglip": (False, "map", True, True, False, "learnable"),
    "map_cls_sincos": (True, "map", False, False, True, "sin_cos_2d"),
    "avg_sincos": (False, "avg", False, True, True, "sin_cos_2d"),
    "tok_no_proj": (True, "tok", True, False, False, "learnable"),
    "tok_no_cls": (False, "tok", False, False, True, "learnable"),
    "none_cls": (True, "none", False, True, False, "learnable"),
    "none_sincos": (False, "none", True, False, True, "sin_cos_2d"),
    "avg_cls": (True, "avg", True, True, False, "learnable"),
}


def _option_kw(case):
    cls, pool, no_proj, bias, ln_after, pos = OPTION_CASES[case]
    return dict(KERNEL, vision_class_token=cls, vision_pool_type=pool,
                vision_no_proj=no_proj, vision_patch_bias=bias,
                vision_final_ln_after_pool=ln_after,
                vision_pos_embed_type=pos)


# the cases also run at 24 px, where the position table is resized: with
# no CLS row (learned and sin-cos) and with one (sin-cos)
RESIZED = ("siglip", "avg_sincos", "map_cls_sincos")


@pytest.mark.parametrize("case", sorted(OPTION_CASES))
def test_encode_image_equals_jax(case):
    kw = _option_kw(case)
    # every leaf drawn at random (an init's zero biases would hide a bias)
    jm, jp = jax_model(kw)
    init = _sd(jp)
    models = {flash: _port(kw, init, use_flash=flash)
              for flash in (None, False)}
    rng = np.random.default_rng(5)
    for size in (16, 24) if case in RESIZED else (16,):
        images = rng.standard_normal((3, size, size, 3)).astype(np.float32)
        want = jax_apply(jm, jp, jnp.asarray(images),
                         method=jm.encode_image)
        for flash, model in models.items():
            with torch.no_grad(), R.kernel_calls() as calls:
                got = model.encode_image(torch.from_numpy(images))
            assert set(got) == set(want)
            for k in want:
                assert tuple(got[k].shape) == tuple(want[k].shape), k
                _close(got[k].numpy(), want[k], f"{case} {size} {k}")
            # one vision block: K1 once on the kernel path
            assert calls["K1"] == (1 if flash is None else 0)


@pytest.mark.parametrize("case,kw", [
    ("siglip_at_the_embedding_width", dict(SIGLIP_MODEL)),
    ("none_pool", dict(KERNEL, vision_pool_type="none")),
    ("no_proj_at_another_width", dict(SIGLIP_MODEL, embed_dim=32)),
])
def test_cosmos_model_refused_where_jax_refuses(case, kw):
    # JAX's init traces the cross-modal heads, which fail on these towers
    kw = dict(kw, **R.COSMOS)
    try:
        jm, jp = jax_model(kw)
    except TypeError:
        with pytest.raises(ValueError, match="cross-modal heads"):
            create_model("ViT-B-16", device="meta", **kw)
        assert case != "siglip_at_the_embedding_width"
        return
    assert case == "siglip_at_the_embedding_width"
    rng = np.random.default_rng(6)
    g = rng.standard_normal((4, 16, 16, 3)).astype(np.float32)
    loc = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    t = rng.integers(1, 127, (6, 12)).astype(np.int32)
    want = jax_apply(jm, jp, jnp.asarray(g), jnp.asarray(t),
                     jnp.asarray(loc), batch_size=2)
    with torch.no_grad():
        got = _port(kw, _sd(jp))(torch.from_numpy(g),
                                 torch.from_numpy(t.astype(np.int64)),
                                 torch.from_numpy(loc), batch_size=2)
    for k in ("img_crossmodal_features", "txt_crossmodal_features"):
        _close(got[k].numpy(), want[k], k)


# --- ViT-B-16-SigLIP and big_vision weights ---------------------------------------

def test_vit_b16_siglip_builds_with_jax_leaf_shapes():
    jm, _ = jax_create_model("ViT-B-16-SigLIP", init_params=False)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 224, 224, 3)),
                            jnp.zeros((1, 64), jnp.int32))["params"]
    model = create_model("ViT-B-16-SigLIP", device="meta")
    got = {n: tuple(p.shape) for n, p in model.named_parameters()}
    seen = set()
    for key, path, tf in build_name_map(12, 12):
        node = shapes
        try:
            for p in path:
                node = node[p]
        except KeyError:
            continue
        shape = tuple(node.shape)
        if tf == "t":
            shape = shape[::-1]
        elif tf == "conv":
            shape = tuple(shape[i] for i in (3, 2, 0, 1))
        assert got[key] == shape, key
        seen.add(key)
    assert seen == set(got)
    n_jax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(
        shapes))
    assert sum(int(np.prod(s)) for s in got.values()) == n_jax
    assert model.visual.attn_pool is not None and model.visual.proj is None
    # its HF tokenizer needs a download
    with pytest.raises(NotImplementedError, match="HF tokenizers"):
        get_tokenizer("ViT-B-16-SigLIP")


def _bv_model_kw():
    from test_siglip_convert import (CTX, D, H, HD, IMAGE, L_IMG, L_TXT,
                                     PATCH, VOCAB)

    return dict(embed_dim=D, vision_image_size=IMAGE, vision_patch_size=PATCH,
                vision_width=D, vision_layers=L_IMG, vision_head_width=HD,
                text_context_length=CTX, text_vocab_size=VOCAB, text_width=D,
                text_heads=H, text_layers=L_TXT, init_logit_bias=-5.0,
                **R.SIGLIP_TOWERS)


@pytest.fixture(scope="module")
def big_vision(tmp_path_factory):
    """A big_vision npz made from a seed, JAX's model and its converted
    tree, and the file."""
    sd = make_bv_npz(np.random.default_rng(0))
    path = tmp_path_factory.mktemp("bv") / "siglip.npz"
    np.savez(path, **{f"params/{k}": v for k, v in sd.items()})
    jm, jp = jax_model(_bv_model_kw())
    return sd, jm, jax_convert(jm, jp, sd), str(path)


def test_big_vision_loads_through_the_load_path(big_vision):
    from test_siglip_convert import CTX, IMAGE, VOCAB

    _, jm, tree, path = big_vision
    model = create_model("ViT-B-16", device="cpu", **_bv_model_kw())
    pckpt.load_checkpoint(model, path)
    assert model.logit_scale.item() == pytest.approx(np.log(10.0))
    assert model.logit_bias.item() == -10.0
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2, IMAGE, IMAGE, 3)).astype(np.float32)
    tokens = rng.integers(1, VOCAB, size=(2, CTX)).astype(np.int32)
    want = jax_apply(jm, tree, jnp.asarray(images), jnp.asarray(tokens))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(images),
                           torch.from_numpy(tokens.astype(np.int64)))
    for k in ("image_features", "text_features"):
        _close(got[k].numpy(), want[k], k)


@pytest.mark.parametrize("change,match", [
    (dict(vision_pool_type="tok"), "no slot in the target model"),
    (dict(text_vocab_size=80), "shape mismatch at token_embedding.weight"),
])
def test_big_vision_merge_errors_are_jax_s(big_vision, change, match):
    sd, _, _, path = big_vision
    kw = dict(_bv_model_kw(), **change)
    jm, jp = jax_model(kw)
    with pytest.raises((ValueError, AssertionError)):
        jax_convert(jm, jp, sd)
    model = create_model("ViT-B-16", device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        pckpt.load_checkpoint(model, path)


def test_bridge_keys_are_jax_s_plus_the_siglip_parts(big_vision):
    tree = big_vision[2]
    got = _sd(tree)
    want = params_to_torch_state_dict(tree)
    extra = set(got) - set(want)
    assert set(want) <= set(got)
    assert extra == {"visual.conv1.bias", "logit_bias"} | {
        f"visual.attn_pool.{n}" for n in (
            "probe", "ln.weight", "ln.bias", *(f"{m}.{leaf}" for m in (
                "q", "kv", "out", "c_fc", "c_proj")
                for leaf in ("weight", "bias")))}
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), k)


# --- the --siglip step ------------------------------------------------------------

PATCH_DROP = 0.5


def _keep_indices():
    """The tokens the student's tower call keeps of each of its 2 x 4 global
    crops (16 px, 4 patches, no CLS token): the first token, then one of
    the other 3 (``int(3 * 0.5)``)."""
    rng = np.random.default_rng(7)
    return np.stack([rng.permutation(3)[:1] for _ in range(8)])


def test_siglip_step_equals_jax(monkeypatch):
    kw = dict(SIGLIP_MODEL, **R.SIGLIP, vision_patch_dropout=PATCH_DROP)
    jm, jp = jax_model(kw)
    init = _sd(jp)
    # the global crops only: an 8 px local crop has one patch, which the
    # first-token rule leaves no patch to drop
    batch = {k: v for k, v in R.step_batch(4, 1).items()
             if k != "local_images"}
    keep = _keep_indices()

    def jax_drop(x, rng, prob, exclude_first_token=True):
        idx = jnp.asarray(keep)
        jax_calls.append(idx.shape)
        kept = jnp.take_along_axis(x[:, 1:], idx[..., None], axis=1)
        return jnp.concatenate([x[:, :1], kept], axis=1)

    jax_calls = []
    monkeypatch.setattr(jvit, "patch_dropout", jax_drop)
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    cosmos=False, siglip=True)
    mesh = create_mesh(1)
    step = jax_train.make_train_step(jm, opt, mesh, cfg)
    state, metrics = H.run_jax(step,
                               jax_train.create_train_state(jp, opt, mesh),
                               shard_batch(batch, mesh))
    assert len(jax_calls) == 1       # traced once
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params),
            "teacher": _sd(state.teacher_params)}

    port_calls = []
    orig = pvit.patch_dropout

    def port_drop(x, prob, generator=None, **k):
        idx = torch.from_numpy(keep)
        port_calls.append(idx.shape)
        return orig(x, prob, keep_idx=idx)

    monkeypatch.setattr(pvit, "patch_dropout", port_drop)
    model = create_model("ViT-B-16", device="cpu", **kw)
    model.load_state_dict(init, strict=True)
    popt = create_optimizer(model, scheduler.const_lr(R.LR, 0, 10),
                            beta1=R.BETA1, beta2=0.98, eps=R.EPS,
                            weight_decay=0.5)
    pcfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                           lr_schedule=scheduler.const_lr(R.LR, 0, 10),
                           log_grad_norm=True, cosmos=False, siglip=True)
    pstate = create_train_state(model, popt)
    with R.kernel_calls() as calls:
        got = make_train_step(model, popt, pcfg)(
            pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert port_calls == jax_calls
    assert set(got) == set(want["metrics"])
    for k, w in want["metrics"].items():
        _close(float(got[k]), w, k)
    for which, module in (("student", pstate.student),
                          ("teacher", pstate.teacher)):
        sd = module.state_dict()
        assert set(sd) == set(want[which])
        for n, w in want[which].items():
            _close(sd[n].numpy(), w.numpy(), f"{which} {n}")
    # the student's vision call and its text call each take K1 in the
    # forward and K2 in the backward; SigLIP runs no teacher forward
    assert calls["K1"] == calls["K2"] == 2
