"""The port's FSDP (``cosmos_tpu_torch/parallel/fsdp.py``, FSDP2's
``fully_shard`` under ``make_train_step_gspmd``) against cosmos_tpu's
``create_train_state_fsdp`` and GSPMD step, on gloo ranks of the CPU
(tests/torch_dp_ranks.py).

The placement rules (``fsdp_spec``, ``fsdp_tp_spec``) equal JAX's leaf for
leaf, with no process.  One spawn of 2 ranks runs the data-parallel step,
the FSDP step (saving its gathered checkpoint) and a data-parallel resume
of that checkpoint; one spawn of 4 runs FSDP x TP on a (2, 2) mesh.  The
loss, the metrics and the updated student and teacher lie within
``rtol=1e-5, atol=1e-5`` of JAX's on the same weights and uint8 batch (the
largest error found: 4.8e-07 on the updated student); an FSDP rank holds
about half the stateful bytes of a data-parallel one; the resumed state
holds the checkpoint's bits.

``min_size=0``, as JAX's FSDP tests: the tiny model's leaves are all under
the 64 Ki-element default.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_ranks as R
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.parallel import fsdp as jax_fsdp
from cosmos_tpu.parallel.mesh import DATA_AXIS, create_mesh
from cosmos_tpu.parallel.tp import MODEL_AXIS, create_tp_mesh
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch.models.convert import (build_name_map,
                                             state_dict_from_jax_params)
from cosmos_tpu_torch.parallel import fsdp

TOL = dict(rtol=1e-5, atol=1e-5)
GLOBAL_BATCH = 4
MIN_SIZE = 0


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _jax_gspmd_step(jm, jp, batch, mesh):
    """One step of JAX's GSPMD step over FSDP placement on ``mesh``."""
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    cosmos=True)
    # the step donates its state: a copy of the weights each time
    state = jax_train.create_train_state_fsdp(
        jax.tree_util.tree_map(np.array, jp), opt, mesh, min_size=MIN_SIZE)
    step = jax_train.make_train_step_gspmd(jm, opt, mesh, cfg)
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS))),
        batch)
    state, metrics = step(state, sharded)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params), "teacher": _sd(state.teacher_params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's FSDP step on 2 devices and FSDP x TP on a (2, 2) mesh; the
    port's 2-rank and 4-rank spawns."""
    jm, jp = jax_create_model("ViT-B-16", seed=1, **R.TINY, **R.COSMOS)
    init = _sd(jp)
    batch = R.step_batch(GLOBAL_BATCH, 1)
    ckpt = str(tmp_path_factory.mktemp("fsdp_ckpt"))
    step = dict(init=init, batch=batch, min_size=MIN_SIZE)
    two = R.start(R.beyond_rank, 2, {
        "dp": ("sharded_step", dict(step, kind="dp")),
        "fsdp": ("sharded_step", dict(step, kind="fsdp", save=ckpt)),
        "resume_dp": ("resumed", dict(kind="dp",
                                      path=f"{ckpt}/epoch_1.pt")),
    })
    four = R.start(R.beyond_rank, 4, {
        "fsdp_tp": ("sharded_step", dict(step, kind="fsdp_tp",
                                         shape=(2, 2)))})
    devs = jax.devices()
    want = {"fsdp": _jax_gspmd_step(jm, jp, batch,
                                    create_mesh(2, devices=devs[:2])),
            "fsdp_tp": _jax_gspmd_step(jm, jp, batch,
                                       create_tp_mesh(2, 2, devs[:4]))}
    two, four = two(), four()
    saved = torch.load(f"{ckpt}/epoch_1.pt", map_location="cpu",
                       weights_only=True)
    return {"want": want, "two": two, "four": four, "saved": saved}


def _close(got, want, what):
    assert set(got) == set(want), what
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(got[n]), w, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
            err_msg=f"{what} {n}")


# --- placement rules -----------------------------------------------------

@pytest.mark.parametrize("shape,n,min_size", [
    ((512, 768), 8, 0), ((1024, 96), 8, 0), ((7, 13), 8, 0), ((768,), 8, None),
    ((), 8, None), ((768, 768), 2, 0), ((3, 768), 4, None),
    ((2304, 768), 8, None), ((16, 16, 3, 768), 4, 0)])
def test_fsdp_spec_equals_jax(shape, n, min_size):
    kw = {} if min_size is None else {"min_size": min_size}
    spec = jax_fsdp.fsdp_spec(np.zeros(shape, np.float32), n, **kw)
    want = next((d for d, ax in enumerate(spec) if ax == DATA_AXIS), None)
    assert fsdp.fsdp_spec(shape, n, **kw) == want
    assert fsdp.FSDP_MIN_SIZE == jax_fsdp.FSDP_MIN_SIZE


def _torch_dim(d, tf, ndim):
    """A dim of a JAX leaf -> the same dim of the port's tensor."""
    if d is None or tf is None:
        return d
    return {"t": lambda: 1 - d, "conv": lambda: (2, 3, 1, 0)[d],
            "cls": lambda: 2, "pos": lambda: d + 1}[tf]()


@pytest.fixture(scope="module")
def jax_params():
    return jax_create_model("ViT-B-16", seed=1, **R.TINY, **R.COSMOS)[1]


@pytest.mark.parametrize("tp,n_data", [(1, 2), (1, 8), (2, 2), (4, 2)])
def test_placements_equal_jax_leaf_for_leaf(jax_params, tp, n_data):
    from cosmos_tpu_torch import create_model

    jp = jax_params
    model = create_model("ViT-B-16", device="meta", **R.TINY, **R.COSMOS)
    got = fsdp.fsdp_placements(model, n_data, tp, MIN_SIZE)
    mesh_shape = {DATA_AXIS: n_data, MODEL_AXIS: tp}
    seen = 0
    for key, path, tf in build_name_map(1, 1):
        node = jp
        try:
            for p in path:
                node = node[p]
        except KeyError:
            continue
        leaf = np.asarray(node)
        if tp > 1:
            keys = [jax.tree_util.DictKey(p) for p in path]
            spec = jax_fsdp.fsdp_tp_spec(keys, leaf, n_data, tp, MIN_SIZE)
        else:
            spec = jax_fsdp.fsdp_spec(leaf, n_data, MIN_SIZE)
        d = next((i for i, ax in enumerate(spec) if ax == DATA_AXIS), None)
        assert got[key] == _torch_dim(d, tf, leaf.ndim), (key, spec)
        seen += 1
    assert seen == len(got) and mesh_shape


# --- the steps -----------------------------------------------------------

@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_fsdp_step_equals_jax(runs, part):
    got = runs["two"][0]["fsdp"][part]
    _close(got, runs["want"]["fsdp"][part], f"fsdp {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_fsdp_step_equals_the_dp_step(runs, part):
    r0 = runs["two"][0]
    _close(r0["fsdp"][part], r0["dp"][part], f"fsdp vs dp {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_fsdp_tp_step_equals_jax(runs, part):
    # the whole state is gathered to rank 0
    _close(runs["four"][0]["fsdp_tp"][part], runs["want"]["fsdp_tp"][part],
           f"fsdp x tp {part}")


def test_every_rank_logs_the_same_metrics_and_rank_0_the_state(runs):
    for case, ranks in (("fsdp", runs["two"]), ("fsdp_tp", runs["four"])):
        for r in ranks[1:]:
            assert r[case]["metrics"] == ranks[0][case]["metrics"]
            assert r[case]["student"] == r[case]["teacher"] == {}


def _expected_bytes(n_data: int, tp: int) -> float:
    """A rank's bytes of params, teacher and both Adam moments (float32)
    under JAX's placement: each leaf divided by the axes it shards over."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.parallel.tp import tp_spec

    model = create_model("ViT-B-16", device="meta", **R.TINY, **R.COSMOS)
    dims = fsdp.fsdp_placements(model, n_data, tp, MIN_SIZE)
    return sum(16 * p.numel()
               / (tp if tp > 1 and tp_spec(n, p.shape) is not None else 1)
               / (n_data if dims[n] is not None else 1)
               for n, p in model.named_parameters())


def test_fsdp_state_really_shards(runs):
    # params, Adam moments and teacher: about 1/2 a rank at world 2 (the
    # 0-d logit scales whole on both), as JAX places them
    dp = runs["two"][0]["dp"]["bytes"]
    assert dp == _expected_bytes(1, 1)
    for rank in runs["two"]:
        assert rank["fsdp"]["bytes"] <= 0.55 * dp
        assert rank["fsdp"]["bytes"] == pytest.approx(_expected_bytes(2, 1),
                                                      rel=0.02)
    # (2, 2): the Megatron leaves a quarter, the others a half
    for rank in runs["four"]:
        assert rank["fsdp_tp"]["bytes"] == pytest.approx(
            _expected_bytes(2, 2), rel=0.02)
        assert rank["fsdp_tp"]["bytes"] < rank["fsdp"]["bytes"] \
            if "fsdp" in rank else True


# --- checkpoints ---------------------------------------------------------

def test_fsdp_checkpoint_is_whole_and_resumes_data_parallel(runs):
    saved, r0 = runs["saved"], runs["two"][0]
    for which in ("student", "teacher"):
        assert saved[which].keys() == r0["fsdp"][which].keys()
        for n, t in saved[which].items():
            assert torch.equal(t, r0["fsdp"][which][n]), (which, n)
    for rank in runs["two"]:
        res = rank["resume_dp"]
        assert (res["epoch"], res["step"], res["num_updates"]) == (1, 1, 1)
        for which in ("student", "teacher"):
            for n, t in saved[which].items():
                assert torch.equal(res[which][n], t), (which, n)
        opt = saved["optimizer"]
        assert res["optimizer"]["param_groups"] == opt["param_groups"]
        for i, st in opt["state"].items():
            for k, v in st.items():
                assert torch.equal(res["optimizer"]["state"][i][k], v)
