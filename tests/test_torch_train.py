"""The port's COSMOS training step (cosmos_tpu_torch.training.train) against
cosmos_tpu's on the same weights: the weight-decay mask, the optimizer's
groups, the gradient of every parameter of the tiny model, and the
length-bucketed text forward.  Three whole train steps are in
tests/test_torch_train_steps.py.

The JAX side runs with use_flash=True, so its self-attention forward and
backward are the Pallas kernels in interpret mode; the port's runs the
autograd Function's CPU path (the plain versions of K1 and K2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cosmos_tpu.losses.contrastive import COSMOSLoss as JaxCOSMOSLoss
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (COSMOSLoss, create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.models.convert import (_count_blocks, build_name_map,
                                             state_dict_from_jax_params)
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig, wd_mask

COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
# ViT-Tiny-Test with head dim 64 in both towers (the kernels' head dims),
# as in tests/test_torch_model.py
TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)
EOT = 49407
B = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _pair(seed=0, **kw):
    """(jax model, jax params, port model with the same weights), float32."""
    jm, jp = jax_create_model("ViT-Tiny-Test", precision="fp32",
                              use_flash=True, seed=seed, **COSMOS, **TINY,
                              **kw)
    tm = create_model("ViT-Tiny-Test", "fp32", device="cpu", **COSMOS,
                      **TINY, **kw)
    tm.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    return jm, jp, tm


def _captions(eots, length=16, seed=0):
    """[k, B, length] ids: SOT, random ids, EOT at the given positions."""
    eots = np.asarray(eots)
    rng = np.random.default_rng(seed)
    toks = np.zeros(eots.shape + (length,), np.int64)
    for idx in np.ndindex(eots.shape):
        e = eots[idx]
        toks[idx][0] = 49406
        toks[idx][1:e] = rng.integers(1, 49000, e - 1)
        toks[idx][e] = EOT
    return toks


def _batch(seed, eots):
    """2 global 64px and 2 local 32px uint8 crops and len(eots) caption
    views of batch B, views leading."""
    rng = np.random.default_rng(seed)
    return {
        "global_images": rng.integers(0, 256, (2, B, 64, 64, 3), np.uint8),
        "local_images": rng.integers(0, 256, (2, B, 32, 32, 3), np.uint8),
        "texts": _captions(eots, seed=seed),
    }


def wd_mask_from_jax(params):
    """cosmos_tpu's wd_mask as {port state-dict key: bool}, through the
    name map of the weight bridge."""
    mask = jax_train.wd_mask(params)
    out = {}
    for tkey, fpath, _ in build_name_map(_count_blocks(params["visual"]),
                                         _count_blocks(params["text"])):
        node = mask
        try:
            for p in fpath:
                node = node[p]
        except KeyError:
            continue
        out[tkey] = bool(node)
    return out


@pytest.fixture(scope="module")
def tiny():
    return _pair()


def test_wd_mask_equals_jax(tiny):
    _, jp, tm = tiny
    got = wd_mask(tm)
    want = wd_mask_from_jax(jp)
    assert set(got) == set(want) == set(tm.state_dict())
    assert got == want
    assert got["visual.conv1.weight"] and got["text_projection"]
    assert not got["logit_scale"] and not got["ln_final.weight"]


def test_optimizer_groups_and_lr_count(tiny):
    _, _, tm = tiny
    lr_fn = scheduler.cosine_lr(1e-3, 2, 20)
    opt = create_optimizer(tm, lr_fn, weight_decay=0.5)
    mask = wd_mask(tm)
    decayed, plain = opt.param_groups
    assert decayed["weight_decay"] == 0.5 and plain["weight_decay"] == 0.0
    assert len(decayed["params"]) == sum(mask.values())
    assert len(plain["params"]) == len(mask) - sum(mask.values())
    assert isinstance(opt, torch.optim.AdamW)
    assert opt.num_updates == 0 and decayed["lr"] == lr_fn(0)


class _Two(torch.nn.Module):
    """A decayed [out, in] weight and an exempt bias, as a Dense layer."""

    def __init__(self, w, b):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(w.T.copy()))
        self.bias = torch.nn.Parameter(torch.from_numpy(b.copy()))


@pytest.mark.parametrize("clip", [None, 0.05])
def test_optimizer_updates_equal_optax(clip):
    """Three updates from the same gradients: cosmos_tpu's optax chain
    (clip_by_global_norm, adamw with the mask) against create_optimizer."""
    rng = np.random.default_rng(8)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    b = rng.standard_normal(4).astype(np.float32)
    grads = [(rng.standard_normal((6, 4)).astype(np.float32),
              rng.standard_normal(4).astype(np.float32)) for _ in range(3)]
    jax_lr = jax_sched.cosine_lr(1e-2, 2, 10)
    tx = jax_train.create_optimizer(jax_lr, beta1=0.9, beta2=0.98, eps=1e-8,
                                    weight_decay=0.5, grad_clip_norm=clip)
    params = {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}
    opt_state = tx.init(params)
    for gw, gb in grads:
        updates, opt_state = tx.update(
            {"kernel": jnp.asarray(gw), "bias": jnp.asarray(gb)}, opt_state,
            params)
        params = optax.apply_updates(params, updates)

    module = _Two(w, b)
    opt = create_optimizer(module, scheduler.cosine_lr(1e-2, 2, 10),
                           beta1=0.9, beta2=0.98, eps=1e-8, weight_decay=0.5,
                           grad_clip_norm=clip)
    for gw, gb in grads:
        module.weight.grad = torch.from_numpy(gw.T.copy())
        module.bias.grad = torch.from_numpy(gb.copy())
        opt.step()
    # float32 AdamW arithmetic in two orders: a few ulps of lr
    np.testing.assert_allclose(_np(module.weight),
                               np.asarray(params["kernel"]).T,
                               atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(_np(module.bias), np.asarray(params["bias"]),
                               atol=1e-7, rtol=1e-6)


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


def test_every_parameter_gradient_equals_jax(tiny):
    """The gradient of the COSMOS loss reaches every parameter of the
    student (none is None: the attention output is differentiable) and
    equals jax.value_and_grad of the same loss."""
    jm, jp, tm = tiny
    rng = np.random.default_rng(3)
    g = rng.standard_normal((2 * B, 64, 64, 3)).astype(np.float32)
    loc = rng.standard_normal((2 * B, 32, 32, 3)).astype(np.float32)
    t = _captions([[5, 12], [7, 15], [3, 9], [4, 6]], seed=4).reshape(
        4 * B, 16)
    want, want_g = jax.jit(jax.value_and_grad(
        lambda p, *a: _jax_cosmos_loss(jm, p, *a, B)))(
        jp, jp, jnp.asarray(g), jnp.asarray(t, jnp.int32), jnp.asarray(loc))
    want_g = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, want_g))

    teacher = create_model("ViT-Tiny-Test", "fp32", device="cpu", **COSMOS,
                           **TINY)
    teacher.load_state_dict(tm.state_dict())
    tm.zero_grad(set_to_none=True)
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
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-6)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    missing = [n for n, gr in grads.items() if gr is None]
    assert not missing, f"no gradient for {missing}"
    assert set(grads) == set(want_g)
    for n, gr in grads.items():
        w = want_g[n].numpy()
        # float32 on both sides: summation order through four layers and
        # the loss; measured at most 6e-6 on gradients up to 2.7
        np.testing.assert_allclose(_np(gr), w, atol=1e-5, rtol=1e-4,
                                   err_msg=n)
    tm.zero_grad(set_to_none=True)


def test_train_step_needs_two_caption_views(tiny):
    _, _, tm = tiny
    opt = create_optimizer(tm, scheduler.const_lr(1e-3, 0, 10))
    step = make_train_step(tm, opt, TrainStepConfig())
    state = create_train_state(tm, opt)
    batch = _batch(0, [[5, 6]])
    with pytest.raises(ValueError, match=">= 2 caption views"):
        step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert state.step == 0
    # a state made for another optimizer is refused, not silently mixed
    other = create_train_state(tm, create_optimizer(
        tm, scheduler.const_lr(1e-3, 0, 10)))
    with pytest.raises(ValueError, match="another model or optimizer"):
        step(other, {k: torch.from_numpy(v) for k, v in batch.items()})


@pytest.mark.parametrize("fits", [True, False])
def test_bucketed_text_forward(fits):
    """text_bucket=8 at context 16: the short bucket (3 of the 4 non-global
    captions) runs at 8 tokens when it fits; the features equal JAX's
    bucketed forward and the port's unbucketed one."""
    jm, jp, tm = _pair(seed=2, text_bucket=8)
    plain = create_model("ViT-Tiny-Test", "fp32", device="cpu", **COSMOS,
                         **TINY)
    plain.load_state_dict(tm.state_dict())
    rest = [[3, 12], [5, 4]] if fits else [[3, 12], [9, 4]]
    t = _captions([[14, 9], [6, 15]] + rest, seed=5).reshape(4 * B, 16)
    rng = np.random.default_rng(6)
    g = rng.standard_normal((2 * B, 64, 64, 3)).astype(np.float32)
    eot = t[2 * B:].argmax(-1)
    assert (np.sort(eot)[:3].max() + 1 <= 8) == fits

    calls = []
    hook = tm.transformer.register_forward_pre_hook(
        lambda mod, args: calls.append(args[0].shape[:2]))
    want = jax.jit(lambda p, g_, t_: jm.apply({"params": p}, g_, t_, None,
                                              batch_size=B))(
        jp, jnp.asarray(g), jnp.asarray(t, jnp.int32))
    with torch.no_grad():
        got = tm(torch.from_numpy(g), torch.from_numpy(t), None, batch_size=B)
        ref = plain(torch.from_numpy(g), torch.from_numpy(t), None,
                    batch_size=B)
    hook.remove()
    # head (views 0-1, full length), the short bucket, the longest quarter
    assert calls == [(2 * B, 16), (3, 8 if fits else 16), (1, 16)]
    assert got["text_tokens"].shape == (2 * B, 16, 64)
    for k in ("text_features", "txt_crossmodal_features",
              "img_crossmodal_features"):
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), atol=1e-5,
                                   err_msg=k)
        np.testing.assert_allclose(_np(got[k]), _np(ref[k]), atol=1e-5,
                                   err_msg=k)
