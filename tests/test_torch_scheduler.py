"""The port's schedules (cosmos_tpu_torch.training.scheduler) against
cosmos_tpu.training.scheduler at every step across warm-up, the cosine and
the cooldown."""

import numpy as np
import pytest

from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu_torch.training import scheduler as sched

# the JAX schedules run in float32 (one rounding of each result, a few in
# cos(pi * e / es)), the port's in float64: a few float32 ulps of base_lr
RTOL, ATOL = 1e-6, 1e-12


def _check(jax_fn, fn, steps, scale):
    for s in steps:
        got = fn(s)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, float(jax_fn(s)), rtol=RTOL,
                                   atol=ATOL + 4e-7 * scale, err_msg=str(s))


@pytest.mark.parametrize("name", ["cosine", "const", "const-cooldown"])
@pytest.mark.parametrize("warmup", [0, 1, 7])
def test_lr_schedules(name, warmup):
    steps, base = 40, 5e-4
    kw = dict(cooldown_steps=12, cooldown_power=1.5, cooldown_end_lr=1e-5)
    _check(jax_sched.get_lr_scheduler(name, base, warmup, steps, **kw),
           sched.get_lr_scheduler(name, base, warmup, steps, **kw),
           range(steps + 1), base)


@pytest.mark.parametrize("warmup", [0, 5])
def test_cosine_scheduler(warmup):
    _check(jax_sched.cosine_scheduler(0.996, 1.0, warmup, 30),
           sched.cosine_scheduler(0.996, 1.0, warmup, 30), range(31), 1.0)


def test_train_recipe_schedule():
    """cosine LR 5e-4 with warm-up 2000 (scripts/train_cc3m.sh)."""
    _check(jax_sched.cosine_lr(5e-4, 2000, 100000),
           sched.cosine_lr(5e-4, 2000, 100000),
           [0, 1, 999, 1999, 2000, 2001, 50000, 99999, 100000], 5e-4)


def test_unknown_scheduler():
    with pytest.raises(ValueError, match="Unknown scheduler"):
        sched.get_lr_scheduler("linear", 1e-3, 0, 10)
