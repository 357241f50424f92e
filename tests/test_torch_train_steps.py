"""Three COSMOS train steps of the port (cosmos_tpu_torch.training.train)
against cosmos_tpu's make_train_step on a one-device mesh, from the same
init and uint8 batches: the losses per step, then every student and teacher
parameter and both logit scales.

The JAX side runs with use_flash=True, so its self-attention forward and
backward are the Pallas kernels in interpret mode; the port's runs the
autograd Function's CPU path (the plain versions of K1 and K2).
"""

import jax
import numpy as np
import pytest
import torch

from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_optimizer, create_train_state,
                              make_train_step)
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig

from test_torch_train import _batch, _np, _pair


def _steps_jax(jm, jp, batches, lr_fn, momentum):
    opt = jax_train.create_optimizer(lr_fn, beta1=0.9, beta2=0.98,
                                     eps=1e-8, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(cosmos=True, local_loss=True,
                                    lr_schedule=lr_fn,
                                    momentum_teacher=momentum,
                                    fix_momentum=True)
    mesh = create_mesh(1)
    step = jax_train.make_train_step(jm, opt, mesh, cfg)
    state = jax_train.create_train_state(jp, opt, mesh)
    metrics = []
    for batch in batches:
        b = dict(batch, texts=batch["texts"].astype(np.int32))
        state, m = step(state, shard_batch(b, mesh, batch_axis=1))
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def test_three_train_steps_match_jax():
    """Three steps of the bench recipe (tanh GELU, text bucket, AdamW
    betas 0.9/0.98, eps 1e-8, weight decay 0.5, local loss) from the same
    init and uint8 batches; the bucket fits on steps 0 and 2, not on 1."""
    jm, jp, tm = _pair(seed=1, act_approx=True, text_bucket=8)
    lr_fn = jax_sched.cosine_lr(1e-3, 2, 20)
    momentum = 0.9
    batches = [_batch(10, [[9, 14], [11, 6], [3, 5], [4, 13]]),
               _batch(11, [[15, 8], [10, 12], [3, 9], [10, 12]]),
               _batch(12, [[6, 7], [13, 15], [6, 2], [2, 4]])]
    jstate, jmetrics = _steps_jax(jm, jp, batches, lr_fn, momentum)

    t_lr = scheduler.cosine_lr(1e-3, 2, 20)
    opt = create_optimizer(tm, t_lr, beta1=0.9, beta2=0.98, eps=1e-8,
                           weight_decay=0.5)
    cfg = TrainStepConfig(cosmos=True, local_loss=True, lr_schedule=t_lr,
                          momentum_teacher=momentum, fix_momentum=True,
                          log_grad_norm=True)
    step = make_train_step(tm, opt, cfg)
    state = create_train_state(tm, opt)
    assert not any(p.requires_grad for p in state.teacher.parameters())
    metrics = [step(state, {k: torch.from_numpy(v) for k, v in b.items()})
               for b in batches]
    assert state.step == 3 and opt.num_updates == 3

    losses = [float(m["loss"]) for m in metrics]
    for s, (m, jmet) in enumerate(zip(metrics, jmetrics)):
        # the tolerance of tests/test_train_dynamics_oracle.py:318-321
        assert abs(float(m["loss"]) - jmet["loss"]) < 1e-3 * (s + 1), (
            s, losses, [j["loss"] for j in jmetrics])
        for k in ("clip_loss", "distill_loss", "logit_scale"):
            np.testing.assert_allclose(float(m[k]), jmet[k], rtol=1e-5,
                                       err_msg=f"{k} step {s}")
        assert m["momentum"] == pytest.approx(jmet["momentum"])
        assert m["lr"] == pytest.approx(jmet["lr"], rel=1e-6)
        assert torch.isfinite(m["grad_norm"])
    assert losses[0] != losses[-1]

    # after step 3: every student and teacher parameter, both logit scales
    # (the model's atol of tests/test_train_dynamics_oracle.py:329-339).
    # The key third of a self-attention in_proj_bias is the exception: it
    # shifts every logit of a row alike, so softmax makes its gradient 0 in
    # exact arithmetic and both sides hand AdamW float noise, which its
    # normalisation turns into steps of up to about lr.  Those elements are
    # held to the sum of the three learning rates instead.
    d = {"visual": 128, "text": 128}
    lr_sum = sum(lr_fn(s) for s in range(3))
    for tree, module in ((jstate.params, state.student),
                         (jstate.teacher_params, state.teacher)):
        want = state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, tree))
        got = module.state_dict()
        assert set(got) == set(want)
        for k in want:
            g, w = _np(got[k]), want[k].numpy()
            if k.endswith("attn.in_proj_bias") and ".resblocks." in k:
                w_ = d["visual" if k.startswith("visual.") else "text"]
                np.testing.assert_allclose(g[w_:2 * w_], w[w_:2 * w_],
                                           atol=lr_sum, err_msg=k)
                g, w = np.delete(g, np.s_[w_:2 * w_]), np.delete(
                    w, np.s_[w_:2 * w_])
            np.testing.assert_allclose(g, w, atol=5e-4, err_msg=k)
        for k in ("logit_scale", "distill_logit_scale"):
            np.testing.assert_allclose(_np(got[k]), want[k].numpy(),
                                       atol=1e-4, err_msg=k)
            assert 0.0 <= float(got[k]) <= np.log(100.0)
    # the teacher moved off its init, towards the student
    init = _pair(seed=1, act_approx=True, text_bucket=8)[2].state_dict()
    k = "visual.transformer.resblocks.0.attn.in_proj_weight"
    assert not torch.equal(state.teacher.state_dict()[k], init[k])
