"""One train step of each mode of the port (cosmos_tpu_torch.training.train)
against cosmos_tpu's make_train_step on a one-device mesh, from the same
weights and uint8 batches: plain CLIP, SigLIP and distillation, the exact
accumulation of the plain CLIP step, the averaged accumulation of COSMOS
and SigLIP, and a LiT-locked COSMOS step.  Compared: the loss and the
metrics, every gradient (JAX's from its first Adam moment, mu = (1 - b1)
g after one update) and the updated student and teacher.

A ViT-B-16 layout cut to width 32 and head dim 16, so both sides take
their plain attention paths (the kernel paths have their own tests).
"""

import jax
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import (TrainStepConfig, freeze,
                                             frozen_mask)

TINY = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
            vision_width=32, vision_layers=2, vision_head_width=16,
            text_context_length=12, text_vocab_size=128, text_width=32,
            text_heads=2, text_layers=2)
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
SIGLIP = dict(init_logit_scale=float(np.log(10.0)), init_logit_bias=-10.0)
LOCK = dict(lock_image=True, lock_text=True, unlocked_groups=2,
            text_unlocked_layers=1)
# AdamW's first step is lr·g/(|g| + eps): a large eps keeps it a smooth
# function of the gradient, so the float noise of a gradient that is zero
# in exact arithmetic (an attention's key bias) stays noise in the update
B, LR, BETA1, EPS = 4, 1e-3, 0.9, 1e-3

# mode -> (model overrides, step config, micro-batches, locked)
MODES = {
    "clip": ({}, dict(cosmos=False), 1, False),
    "siglip": (SIGLIP, dict(cosmos=False, siglip=True), 1, False),
    "distill": ({}, dict(cosmos=False, distill=True), 1, False),
    "clip-accum-exact": ({}, dict(cosmos=False, accum_freq=2), 2, False),
    "siglip-accum-mean": (SIGLIP, dict(cosmos=False, siglip=True,
                                       accum_freq=2), 2, False),
    "cosmos-accum-mean": (COSMOS, dict(cosmos=True, accum_freq=2), 2, False),
    "cosmos-locked": (COSMOS, dict(cosmos=True), 1, True),
}


def _batch(seed, accum):
    """uint8 views of batch B (2 global 16px, 2 local 8px crops, 3 caption
    views), with a leading micro-batch axis when ``accum`` > 1."""
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum > 1 else ()
    return {
        "global_images": rng.integers(0, 256, lead + (2, B, 16, 16, 3),
                                      np.uint8),
        "local_images": rng.integers(0, 256, lead + (2, B, 8, 8, 3),
                                     np.uint8),
        "texts": rng.integers(1, 127, lead + (3, B, 12)).astype(np.int32),
    }


def _adam_mu(state):
    """The first moment of the (first) Adam state in an optax state."""
    if hasattr(state, "mu"):
        return state.mu
    if isinstance(state, (tuple, list)):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _jax_step(mode, jm, jp, batch, dist):
    model_kw, cfg_kw, accum, locked = MODES[mode]
    lr = jax_sched.const_lr(LR, 0, 10)
    lock = {}
    if locked:
        lock = dict(lock_image=True, lock_text=True,
                    lock_image_unlocked_groups=2, lock_text_unlocked_layers=1)
    opt = jax_train.create_optimizer(lr, beta1=BETA1, beta2=0.98, eps=EPS,
                                     weight_decay=0.5, **lock)
    frozen = jax_train.frozen_mask(jp, **LOCK) if locked else None
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    frozen=frozen, **cfg_kw)
    mesh = create_mesh(1)
    step = jax_train.make_train_step(
        jm, opt, mesh, cfg, dist_model=None if dist is None else dist[0])
    state = jax_train.create_train_state(jp, opt, mesh)
    args = (shard_batch(batch, mesh, batch_axis=2 if accum > 1 else 1),)
    if dist is not None:
        args += (dist[1],)
    state, metrics = H.run_jax(step, state, *args)
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - BETA1),
                                   _adam_mu(state.opt_state))
    return ({k: float(v) for k, v in metrics.items()}, _sd(grads),
            _sd(state.params), _sd(state.teacher_params))


def _port_step(mode, init, batch, dist_init):
    model_kw, cfg_kw, accum, locked = MODES[mode]
    kw = dict(TINY, **model_kw)
    tm = create_model("ViT-B-16", device="cpu", **kw)
    tm.load_state_dict(init, strict=True)
    mask = None
    if locked:
        mask = frozen_mask(tm, **LOCK)
        freeze(tm, mask)
    dist = None
    if dist_init is not None:
        dist = create_model("ViT-B-16", device="cpu", **TINY)
        dist.load_state_dict(dist_init, strict=True)
    lr = scheduler.const_lr(LR, 0, 10)
    opt = create_optimizer(tm, lr, beta1=BETA1, beta2=0.98, eps=EPS,
                           weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True, frozen=mask,
                          **cfg_kw)
    step = make_train_step(tm, opt, cfg, dist_model=dist)
    state = create_train_state(tm, opt)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = {n: p.grad for n, p in tm.named_parameters()
             if p.grad is not None}
    return metrics, grads, state, mask


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_matches_jax(mode):
    model_kw, cfg_kw, accum, locked = MODES[mode]
    jm, jp = H.jax_create_fast("ViT-B-16", seed=1, **TINY, **model_kw)
    dist = None
    if cfg_kw.get("distill"):
        dist = H.jax_create_fast("ViT-B-16", seed=2, **TINY)
    batch = _batch(3, accum)
    # the JAX step donates its state: the weights are read first
    init = _sd(jp)
    dist_init = None if dist is None else _sd(dist[1])
    want, want_g, want_s, want_t = _jax_step(mode, jm, jp, batch, dist)
    got, grads, state, mask = _port_step(mode, init, batch, dist_init)

    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    # every trainable parameter's gradient; a frozen one has none, and JAX
    # hands Adam zeros for it
    trainable = {n for n, p in state.student.named_parameters()
                 if p.requires_grad}
    assert set(grads) <= trainable
    for n in want_g:
        w = want_g[n].numpy()
        if n not in trainable:
            assert not w.any(), n
            continue
        g = grads[n].numpy() if n in grads else np.zeros_like(w)
        # atol 1e-6 of a gradient at unit scale: float32 sums in another
        # order cancel to a few 1e-6 in tensors of gradients up to ~5
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=n)
    for module, want_p in ((state.student, want_s), (state.teacher, want_t)):
        got_p = module.state_dict()
        assert set(got_p) == set(want_p)
        for n, w in want_p.items():
            np.testing.assert_allclose(got_p[n].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)
    if locked:
        frozen = [n for n, f in mask.items() if f]
        assert frozen and len(frozen) < len(mask)
        for n in frozen:
            assert torch.equal(state.student.state_dict()[n], init[n]), n
        # the optimizer holds the trainable parameters only
        held = {id(p) for g in state.optimizer.param_groups
                for p in g["params"]}
        assert held == {id(p) for p in state.student.parameters()
                        if p.requires_grad}


@pytest.mark.parametrize("cfg,match", [
    (dict(cosmos=True, siglip=True), "modes are exclusive"),
    (dict(cosmos=False, siglip=True, distill=True), "modes are exclusive"),
    (dict(cosmos=False, distill=True), "needs the frozen dist_model"),
    (dict(cosmos=True, accum_freq=0), "accum_freq must be >= 1"),
])
def test_step_refuses_what_jax_refuses(cfg, match):
    tm = create_model("ViT-B-16", device="cpu", **TINY, **COSMOS)
    opt = create_optimizer(tm, scheduler.const_lr(LR, 0, 10))
    with pytest.raises(ValueError, match=match):
        make_train_step(tm, opt, TrainStepConfig(**cfg))


def test_accum_with_distill_is_refused_as_in_jax():
    tm = create_model("ViT-B-16", device="cpu", **TINY)
    opt = create_optimizer(tm, scheduler.const_lr(LR, 0, 10))
    cfg = TrainStepConfig(cosmos=False, distill=True, accum_freq=2)
    with pytest.raises(ValueError, match="accum_freq > 1 unsupported with "
                       "distill"):
        make_train_step(tm, opt, cfg, dist_model=tm)


def test_optimizer_with_frozen_parameters_is_refused():
    tm = create_model("ViT-B-16", device="cpu", **TINY)
    opt = create_optimizer(tm, scheduler.const_lr(LR, 0, 10))
    mask = frozen_mask(tm, lock_image=True)
    with pytest.raises(ValueError, match="optimizer holds frozen"):
        make_train_step(tm, opt, TrainStepConfig(cosmos=False, frozen=mask))
