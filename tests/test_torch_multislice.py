"""The port's multislice gather (``ClipLoss`` with ``slice_group`` and
``gather_scope``, ``make_train_step`` over a ('slice', 'data') mesh)
against cosmos_tpu's hierarchical gather on a 2 x 2 multislice mesh, on 4
gloo ranks of the CPU (tests/torch_dp_ranks.py), in one spawn.

``gather_scope='global'`` gathers within the slice, then the slices'
blocks across slices: the loss and the updated student and teacher are
JAX's (without the local loss), and the flat world-4 step's for both
``local_loss`` settings.
``'slice'`` keeps the negatives slice-local: the loss is JAX's per-slice
loss, and the gradients still average over every rank, so all four ranks
end on the same weights.  CoCa's step (coca_Tiny-Test) over the 2 slices
is the flat world-4 step, which tests/test_torch_dp_train.py holds to
JAX's at world 2.  Tolerance ``rtol=1e-5, atol=1e-5`` (the largest
error found: 4.8e-07).  JAX's refusals (a bad scope, the no-grad gather
with slices, SigLIP on a multislice mesh) hold with JAX's messages.
"""

import types

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.losses import contrastive as jax_losses
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.parallel.mesh import create_multislice_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch.losses import contrastive as C
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
# (gather_scope, local_loss) of each case
CASES = {"global": ("global", False), "global-local": ("global", True),
         "slice": ("slice", False), "slice-local": ("slice", True)}
# the cases held to JAX's step; the global scope's local loss is held to
# the flat step's, which tests/test_torch_dp_train.py holds to JAX's
JAX_CASES = ("global", "slice", "slice-local")


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _jax_step(jm, jp, batch, scope, local_loss):
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    cosmos=True, local_loss=local_loss,
                                    gather_scope=scope)
    mesh = create_multislice_mesh(2, devices=jax.devices()[:4])
    state = jax_train.create_train_state(
        jax.tree_util.tree_map(np.array, jp), opt, mesh)
    step = jax_train.make_train_step(jm, opt, mesh, cfg)
    state, metrics = H.run_jax(step, state,
                               shard_batch(batch, mesh, batch_axis=1))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params), "teacher": _sd(state.teacher_params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, jp = H.jax_create_fast("ViT-B-16", seed=1, **R.TINY, **R.COSMOS)
    batch = R.step_batch(8, 1)
    step = dict(init=_sd(jp), batch=batch)
    payload = {case: ("sharded_step", dict(
        step, kind="multislice", shape=(2,),
        cfg_kw=dict(gather_scope=scope, local_loss=local)))
        for case, (scope, local) in CASES.items()}
    for local in (False, True):
        payload[f"flat-{local}"] = ("sharded_step", dict(
            step, kind="dp", cfg_kw=dict(local_loss=local)))
    coca = dict(init=R.step_model("coca").state_dict(),
                batch=R.coca_step_batch(8), mode="coca")
    payload["coca-slices"] = ("sharded_step", dict(coca, kind="multislice",
                                                   shape=(2,)))
    payload["coca-flat"] = ("sharded_step", dict(coca, kind="dp"))
    data = str(tmp_path_factory.mktemp("ms_trainer"))
    R.write_trainer_data(data)
    payload["trainer"] = ("trainer_runs", dict(argvs=[
        R.trainer_argv(data, "ms", "--num-slices", "2", "--gather-scope",
                       "slice", "--epochs", "1"),
        R.trainer_argv(data, "ms", "--num-slices", "2", "--epochs", "2",
                       "--resume", "latest")]))
    ranks = R.start(R.beyond_rank, 4, payload)
    want = {case: _jax_step(jm, jp, batch, *CASES[case]) for case in JAX_CASES}
    return {"want": want, "ranks": ranks()}


def _close(got, want, what):
    assert set(got) == set(want), what
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(got[n]), w, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
            err_msg=f"{what} {n}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_multislice_step_equals_jax(runs, case, part):
    for rank in runs["ranks"]:
        _close(rank[case][part], runs["want"][case][part], f"{case} {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
@pytest.mark.parametrize("local", [False, True])
def test_hierarchical_gather_equals_the_flat_step(runs, local, part):
    case = "global-local" if local else "global"
    for rank in runs["ranks"]:
        _close(rank[case][part], rank[f"flat-{local}"][part],
               f"{case} vs flat {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_coca_over_slices_equals_the_flat_step(runs, part):
    for rank in runs["ranks"]:
        _close(rank["coca-slices"][part], rank["coca-flat"][part],
               f"coca over slices vs flat {part}")


def test_slice_scope_is_the_per_slice_loss_with_averaged_gradients(runs):
    ranks = runs["ranks"]
    # slice-local negatives: another loss than the global scope's ...
    assert ranks[0]["slice"]["metrics"]["loss"] != pytest.approx(
        ranks[0]["global"]["metrics"]["loss"], rel=1e-3)
    # ... but one update on every rank: the mean spans the slices
    for case in ("slice", "slice-local"):
        for r in ranks[1:]:
            assert r[case]["metrics"] == ranks[0][case]["metrics"]
            for which in ("student", "teacher"):
                for n, t in ranks[0][case][which].items():
                    assert torch.equal(r[case][which][n], t), (case, n)


def test_refusals_are_jax_s():
    with pytest.raises(ValueError) as want:
        jax_losses.ClipLoss(gather_scope="pod")
    with pytest.raises(ValueError) as got:
        C.ClipLoss(gather_scope="pod")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jax_losses.COSMOSLoss(slice_axis="slice", gather_with_grad=False)
    with pytest.raises(ValueError) as got:
        C.COSMOSLoss(slice_group=object(), gather_with_grad=False)
    assert str(got.value) == str(want.value)


def test_siglip_is_refused_on_a_multislice_mesh():
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training import train as T

    jm, _ = jax_create_model("ViT-B-16", init_params=False, **R.TINY)
    with pytest.raises(ValueError) as want:
        jax_train.make_train_step(
            jm, None, create_multislice_mesh(2, devices=jax.devices()[:4]),
            jax_train.TrainStepConfig(cosmos=False, siglip=True))
    model = create_model("ViT-B-16", device="meta", **R.TINY, **R.SIGLIP)
    mesh = types.SimpleNamespace(mesh_dim_names=("slice", "data"),
                                 get_group=lambda name: None)
    with pytest.raises(ValueError) as got:
        T.make_train_step(model, None,
                          T.TrainStepConfig(cosmos=False, siglip=True),
                          mesh=mesh)
    assert str(got.value) == str(want.value)


def test_trainer_runs_over_slices_in_both_scopes(runs):
    ranks = [r["trainer"] for r in runs["ranks"]]
    for r in ranks:
        assert r["epochs"] == [[0], [1]]
        assert r["losses"] == ranks[0]["losses"]
        assert np.all(np.isfinite(sum(r["losses"], [])))
    assert all(np.isfinite(v) for v in ranks[0]["val_loss"])


@pytest.mark.parametrize("argv,world,message", [
    (["--mesh-shape", "2,2", "--num-slices", "2"], 4,
     "--num-slices composes with the 1-D data mesh only; drop the ',tp' "
     "--mesh-shape"),
    (["--fsdp", "--num-slices", "2"], 2,
     "--fsdp (GSPMD global-batch step) does not compose with --num-slices "
     "(shard_map hierarchical-gather step) yet; pick one"),
    (["--num-slices", "2"], 3, "3 devices do not factor into 2 slices"),
    (["--mesh-shape", "2,2"], 2, "this world has 2 rank(s)")])
def test_the_trainer_refuses_jax_s_combinations(argv, world, message):
    from cosmos_tpu_torch.training import main as pmain
    from cosmos_tpu_torch.training.params import parse_args

    with pytest.raises(ValueError) as e:
        pmain.check_mesh_shape(parse_args(argv), world)
    assert message in str(e.value)
