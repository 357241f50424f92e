"""The tiny COSMOS model with the fused-LayerNorm paths on, the port against
cosmos_tpu on the same weights, under each setting:

- ``fused``: ``layers.FUSED_LN`` (K3 forward, K4 backward);
- ``hybrid``: ``layers.HYBRID_LN`` (plain forward, K4 backward; on the JAX
  side ``_hybrid_ln_active`` is patched to its TPU answer, as
  tests/test_layer_norm.py does, since JAX takes it only on the TPU);
- ``fuse_ln``: ``create_model(fuse_ln=True)`` (K5 before every QKV
  projection, K6 for every MLP) with ``FUSED_LN`` for the other
  LayerNorms.

The towers are 128 wide so that ``supported`` holds for their LayerNorms;
the poolers (64 wide) stay on the plain LayerNorm in both packages.  The
JAX side runs its Pallas kernels in interpret mode; the port runs the
kernel wrappers' CPU paths (the plain versions), whose calls are counted
here as the kernels' launches would be on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.losses.contrastive import COSMOSLoss as JaxCOSMOSLoss
from cosmos_tpu.models import layers as jlayers
from cosmos_tpu.ops.experimental import layer_norm as jln
from cosmos_tpu_torch import COSMOSLoss, create_model
from cosmos_tpu_torch.models import layers as tlayers
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.ops.experimental import layer_norm as tln
from cosmos_tpu_torch.ops.experimental import ln_matmul as tlm
from cosmos_tpu_torch.ops.experimental import mlp_block as tmb

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
# ViT-Tiny-Test (2 layers per tower) at width 128 with head dim 64
TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)
SETTINGS = ["fused", "hybrid", "fuse_ln"]
EOT = 49407
B = 2
# float32 on both sides: XLA's and torch's CPU kernels sum in other orders
F32_TOL = dict(atol=1e-4, rtol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def pairs():
    """{fuse_ln: (jax model, jax params, port model)} on the same weights."""
    out = {}
    for fuse in (False, True):
        jm, jp = H.jax_create_fast("ViT-Tiny-Test", precision="fp32",
                                   use_flash=True, seed=0, fuse_ln=fuse,
                                   **COSMOS, **TINY)
        tm = create_model("ViT-Tiny-Test", "fp32", device="cpu",
                          fuse_ln=fuse, **COSMOS, **TINY)
        tm.load_state_dict(state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, jp)), strict=True)
        out[fuse] = (jm, jp, tm)
    return out


def _setting(monkeypatch, pairs, setting):
    """Turn the setting's toggles on in both packages; return its pair."""
    if setting == "hybrid":
        monkeypatch.setattr(tlayers, "HYBRID_LN", True)
        monkeypatch.setattr(jlayers, "HYBRID_LN", True)
        monkeypatch.setattr(jlayers, "_hybrid_ln_active", jln.supported)
    else:
        monkeypatch.setattr(tlayers, "FUSED_LN", True)
        monkeypatch.setattr(jlayers, "FUSED_LN", True)
    return pairs[setting == "fuse_ln"]


def _count_calls(monkeypatch):
    """Count the calls of each kernel wrapper (K3, K4, K5, K6)."""
    counts = {"K3": 0, "K4": 0, "K5": 0, "K6": 0}
    for key, mod, name in (("K3", tln, "layer_norm_fwd"),
                           ("K4", tln, "layer_norm_bwd"),
                           ("K5", tlm, "ln_matmul_fwd"),
                           ("K6", tmb, "mlp_block_fwd")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _key=key):
            counts[_key] += 1
            return _real(*args)

        monkeypatch.setattr(mod, name, spy)
    return counts


def _captions(eots, length=16, seed=0):
    eots = np.asarray(eots)
    rng = np.random.default_rng(seed)
    toks = np.zeros(eots.shape + (length,), np.int64)
    for idx in np.ndindex(eots.shape):
        e = eots[idx]
        toks[idx][0] = 49406
        toks[idx][1:e] = rng.integers(1, 49000, e - 1)
        toks[idx][e] = EOT
    return toks


def _inputs(seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((2 * B, 64, 64, 3)).astype(np.float32)
    loc = rng.standard_normal((2 * B, 32, 32, 3)).astype(np.float32)
    t = _captions([[5, 12], [7, 15], [3, 9], [4, 6]], seed=seed).reshape(
        4 * B, 16)
    return g, loc, t


# kernel calls of one COSMOS forward of the tiny model (2 layers per
# tower; globals [4,17,128], locals [4,5,128], captions [8,16,128]): per
# tower call ln_pre (vision only), 2 per block and ln_post / ln_final; the
# poolers' 64-wide LayerNorms are not supported.  Under fuse_ln the blocks
# run K5 and K6 instead of their two LayerNorms.
FORWARD_CALLS = {
    "fused": {"K3": 6 + 6 + 5, "K4": 0, "K5": 0, "K6": 0},
    "hybrid": {"K3": 0, "K4": 0, "K5": 0, "K6": 0},
    "fuse_ln": {"K3": 2 + 2 + 1, "K4": 0, "K5": 6, "K6": 6},
}


@pytest.mark.parametrize("setting", SETTINGS)
def test_encoders_and_cosmos_forward_equal_jax(monkeypatch, pairs, setting):
    jm, jp, tm = _setting(monkeypatch, pairs, setting)
    g, loc, t = _inputs(1)
    want_i = jm.apply({"params": jp}, jnp.asarray(g), True,
                      method=jm.encode_image)
    want_t = jm.apply({"params": jp}, jnp.asarray(t, jnp.int32), False,
                      method=jm.encode_text)
    want = jm.apply({"params": jp}, jnp.asarray(g), jnp.asarray(t, jnp.int32),
                    jnp.asarray(loc), batch_size=B)
    with torch.no_grad():
        got_i = tm.encode_image(torch.from_numpy(g), normalize=True)
        got_t = tm.encode_text(torch.from_numpy(t), normalize=False)
        counts = _count_calls(monkeypatch)
        got = tm(torch.from_numpy(g), torch.from_numpy(t),
                 torch.from_numpy(loc), batch_size=B)
    assert counts == FORWARD_CALLS[setting]
    for w, gt in ((want_i, got_i), (want_t, got_t), (want, got)):
        assert set(gt) == set(w)
        for k in w:
            np.testing.assert_allclose(_np(gt[k]), _np(w[k]), err_msg=k,
                                       **F32_TOL)


def _jax_cosmos_loss(jm, jp, tp, g, t, loc, b):
    """The COSMOS loss of cosmos_tpu's train step (train.py:500-522)."""
    s = jm.apply({"params": jp}, g, t, loc, batch_size=b)
    tt = jm.apply({"params": tp}, g, t[:2 * b])

    def v(x, n):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    vi, k = g.shape[0] // b + loc.shape[0] // b, t.shape[0] // b
    losses = JaxCOSMOSLoss()(
        v(s["image_features"], vi), v(s["text_features"], k),
        s["logit_scale"], v(tt["image_features"], 2),
        v(tt["text_features"], 2), s["distill_logit_scale"],
        v(s["img_crossmodal_features"], vi),
        v(s["txt_crossmodal_features"], k), output_dict=True)
    return losses["distill_loss"] + losses["clip_loss"]


# the backward of the same forward: every supported LayerNorm of the
# student takes K4 under "fused" and "hybrid"; the teacher runs under
# no_grad (globals 6 K3 and captions 5 K3 under fused, 2 + 1 under fuse_ln)
STEP_CALLS = {
    "fused": {"K3": 17 + 11, "K4": 17, "K5": 0, "K6": 0},
    "hybrid": {"K3": 0, "K4": 17, "K5": 0, "K6": 0},
    "fuse_ln": {"K3": 5 + 3, "K4": 5, "K5": 6 + 4, "K6": 6 + 4},
}


@pytest.mark.parametrize("setting", SETTINGS)
def test_every_parameter_gradient_equals_jax(monkeypatch, pairs, setting):
    """The gradient of the COSMOS loss (student forward with gradient,
    teacher forward without) reaches every parameter and equals
    jax.value_and_grad through the JAX package's custom VJPs."""
    jm, jp, tm = _setting(monkeypatch, pairs, setting)
    g, loc, t = _inputs(3)
    want, want_g = H.run_jax(jax.jit(jax.value_and_grad(
        lambda p, *a: _jax_cosmos_loss(jm, p, *a, B))),
        jp, jp, jnp.asarray(g), jnp.asarray(t, jnp.int32), jnp.asarray(loc))
    want_g = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, want_g))

    teacher = create_model("ViT-Tiny-Test", "fp32", device="cpu",
                           fuse_ln=setting == "fuse_ln", **COSMOS, **TINY)
    teacher.load_state_dict(tm.state_dict())
    tm.zero_grad(set_to_none=True)
    counts = _count_calls(monkeypatch)
    s = tm(torch.from_numpy(g), torch.from_numpy(t), torch.from_numpy(loc),
           batch_size=B)
    with torch.no_grad():
        tt = teacher(torch.from_numpy(g), torch.from_numpy(t[:2 * B]))

    def v(x, n):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    loss = COSMOSLoss()(
        v(s["image_features"], 4), v(s["text_features"], 4),
        s["logit_scale"], v(tt["image_features"], 2),
        v(tt["text_features"], 2), s["distill_logit_scale"],
        v(s["img_crossmodal_features"], 4),
        v(s["txt_crossmodal_features"], 4))
    loss.backward()
    assert counts == STEP_CALLS[setting]
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    missing = [n for n, gr in grads.items() if gr is None]
    assert not missing, f"no gradient for {missing}"
    assert set(grads) == set(want_g)
    for n, gr in grads.items():
        # float32 on both sides: summation order through four layers and
        # the loss, as in tests/test_torch_train.py
        np.testing.assert_allclose(_np(gr), want_g[n].numpy(), atol=1e-5,
                                   rtol=1e-4, err_msg=n)
    tm.zero_grad(set_to_none=True)


def test_state_dict_is_the_same_with_fuse_ln(pairs):
    """fuse_ln changes the kernels, not the parameters: the same names and
    shapes, and the weights of one load into the other strictly."""
    plain, fused = pairs[False][2], pairs[True][2]
    a, b = plain.state_dict(), fused.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    fused.load_state_dict(a, strict=True)
    assert fused.visual.transformer.resblocks[0].fuse_ln
    assert not plain.visual.transformer.resblocks[0].fuse_ln
