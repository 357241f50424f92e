"""The port's training step and trainer under a process group of 2 gloo
ranks on the CPU (tests/torch_dp_ranks.py), against cosmos_tpu's
make_train_step on a 2-device mesh.

One step of COSMOS, of plain CLIP with the exact accumulation, of
SigLIP (its ring), of CoCa (coca_Tiny-Test, the gathered CoCaLoss) and of
plain CLIP on an HF text tower (BERT, its unreached pooler decayed),
from the same weights and uint8 batch, each rank on its contiguous block
of the global batch as a device of JAX's mesh: the averaged loss and
metrics, the averaged gradients (JAX's from its first Adam moment,
mu = (1 - b1) g after one update) and the updated student and teacher
within 1e-5 of JAX's, both ranks on the same bits, and, but for CoCa, the
same within 1e-5 of the port's one-process step on the whole batch
("world 2 on B/2 equals world 1 on B"); a process group of one rank gives
the one-process step's bits.  CoCa's caption cross-entropy is a mean over
each rank's unpadded tokens, averaged over the ranks as JAX's shard_map
step averages it, and its batch puts every pad on the first rank, so that
JAX holds the split.  Then the trainer, main([...]), at world 2
on the tiny config: only rank 0 writes checkpoints and looks for the
latest one, both ranks restore the path it chose, each rank reads its own
batches of --batch-size rows, and both end on the same bits.

A ViT-B-16 layout cut to one block a tower, width 32 and head dim 16, so
both sides take their plain attention paths.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.factory import init_model_params
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch.data.synthetic import write_shards
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params

WORLD = 2
GLOBAL_BATCH = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _adam_mu(state):
    if hasattr(state, "mu"):
        return state.mu
    if isinstance(state, (tuple, list)):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def _jax_step(mode, jm, jp, batch):
    _, cfg_kw, accum = R.STEP_MODES[mode]
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    **cfg_kw)
    mesh = create_mesh(WORLD)
    step = jax_train.make_train_step(jm, opt, mesh, cfg)
    state = jax_train.create_train_state(jp, opt, mesh)
    state, metrics = H.run_jax(step, state, shard_batch(
        batch, mesh, batch_axis=2 if accum > 1 else 1))
    grads = jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - R.BETA1),
                                   _adam_mu(state.opt_state))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": _sd(grads), "student": _sd(state.params),
            "teacher": _sd(state.teacher_params)}


def _jax_model(mode):
    """JAX's model of ``mode`` and its parameters; CoCa's and the HF
    tower's drawn with numpy at the shapes jax.eval_shape gives (no JAX
    init is compiled)."""
    model_kw = R.STEP_MODES[mode][0]
    if mode == "hf":
        return H.jax_model(dict(R.TINY, **model_kw))
    if mode not in R.STEP_MODELS:
        return H.jax_create_fast("ViT-B-16", seed=1, **R.TINY, **model_kw)
    jm, _ = jax_create_model(R.STEP_MODELS[mode], init_params=False,
                             use_flash=False)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: init_model_params(jm)))
    return jm, jp


@pytest.fixture(scope="module")
def steps():
    """{mode: (JAX on the 2-device mesh, [the port's 2 ranks], the port in
    one process without a process group, the port under a group of one
    rank)}.  The ranks, both groups, run while JAX compiles its steps."""
    payload, models, built = {}, {}, {}
    for mode, (model_kw, _, accum) in R.STEP_MODES.items():
        # modes of one model (plain CLIP, its exact accumulation) share it;
        # each step takes a copy of the weights
        key = (R.STEP_MODELS.get(mode), repr(model_kw))
        if key not in built:
            built[key] = _jax_model(mode)
        jm, jp = built[key][0], jax.tree_util.tree_map(np.array,
                                                       built[key][1])
        batch = (R.coca_step_batch(GLOBAL_BATCH) if mode == "coca"
                 else R.step_batch(GLOBAL_BATCH, accum))
        # the JAX step donates its state: the weights are read first
        payload[mode] = (_sd(jp), batch)
        models[mode] = (jm, jp, batch)
    join = R.start(R.steps_rank, WORLD, payload)
    # the group of one rank runs beside them
    join1 = R.start(R.steps_rank, 1, payload)
    want = {mode: _jax_step(mode, *models[mode]) for mode in models}
    ranks = join()
    # one thread, as each rank runs: the CPU kernels' summation order
    # depends on the thread count
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {mode: R.port_step(mode, *payload[mode]) for mode in payload}
    finally:
        torch.set_num_threads(threads)
    world1 = join1()[0]
    return {mode: (want[mode], [r[mode] for r in ranks], one[mode],
                   world1[mode])
            for mode in R.STEP_MODES}


def _close(got, want, what):
    """Two {name: tensor or array} maps within TOL, the atol scaled by the
    largest |value| of each tensor."""
    assert set(got) == set(want), what
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(got[n]), w, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
            err_msg=f"{what} {n}")


@pytest.mark.parametrize("part", ["metrics", "grads", "student", "teacher"])
@pytest.mark.parametrize("mode", sorted(R.STEP_MODES))
def test_world_2_step_matches_jax(steps, mode, part):
    want, ranks, _, _ = steps[mode]
    got = ranks[0][part]
    if part == "grads":
        # every trainable tensor has a gradient in these modes
        assert set(got) == set(want["grads"])
    _close(got, want[part], f"{mode} {part}")


@pytest.mark.parametrize("mode", sorted(R.STEP_MODES))
def test_both_ranks_hold_the_same_bits(steps, mode):
    _, (r0, r1), _, _ = steps[mode]
    assert r0["metrics"] == r1["metrics"]
    for part in ("grads", "student", "teacher"):
        for n, t in r0[part].items():
            assert torch.equal(t, r1[part][n]), f"{part} {n}"


@pytest.mark.parametrize("part", ["metrics", "grads", "student", "teacher"])
# CoCa's caption loss is a mean of the ranks' means, as JAX's (above)
@pytest.mark.parametrize("mode", sorted(set(R.STEP_MODES) - {"coca"}))
def test_world_2_on_half_batches_equals_world_1(steps, mode, part):
    _, ranks, one, _ = steps[mode]
    _close(ranks[0][part], one[part], f"{mode} {part}")


@pytest.mark.parametrize("mode", sorted(R.STEP_MODES))
def test_a_group_of_one_rank_is_the_one_process_step_to_the_bit(steps, mode):
    # every collective is an identity at world 1, and the gather's backward
    # keeps the cotangent's layout, so the same kernels run on the same bits
    _, _, one, world1 = steps[mode]
    assert world1["metrics"] == one["metrics"]
    for part in ("grads", "student", "teacher"):
        assert world1[part].keys() == one[part].keys()
        for n, t in one[part].items():
            assert torch.equal(world1[part][n], t), f"{part} {n}"


def test_patch_drop_stream_takes_the_rank_only_in_a_world():
    from cosmos_tpu_torch.training.train import patch_drop_generator

    def draw(*a):
        return torch.rand(4, generator=patch_drop_generator(*a))

    one = draw(5, 3, None)
    # a one-process run keeps its stream; each rank draws its own
    assert torch.equal(one, draw(5, 3, None, None))
    r0, r1 = draw(5, 3, None, 0), draw(5, 3, None, 1)
    assert not torch.equal(r0, r1) and not torch.equal(one, r0)
    assert not torch.equal(draw(5, 3, 0, 0), r0)


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """main([...]) at world 2: 1 epoch of 2 steps (global batch 4, 2 rows
    a rank), then --resume latest into a second."""
    d = tmp_path_factory.mktemp("dp_trainer")
    write_shards(str(d / "train-{i:04d}.tar"), 2, 8, seed=0, fmt="png",
                 size_range=(36, 72))
    write_shards(str(d / "val-{i:04d}.tar"), 1, 4, seed=1, fmt="png",
                 size_range=(36, 72))
    argv = ["--model", "ViT-Tiny-Test", "--dataset-type", "webdataset",
            "--train-data", str(d / "train-{0000..0001}.tar"),
            "--train-num-samples", "8", "--batch-size", "2",
            "--use-imagecrop-aug", "--local-crops-number", "2",
            "--caption-sampling-mode", "textcrop",
            "--num-sampled-captions", "3", "--cosmos", "--output-all",
            "--attentional-pool", "--add-zero-attn", "--fix-momentum",
            "--precision", "fp32", "--log-every-n-steps", "1",
            "--workers", "0", "--lr", "1e-3", "--warmup", "1",
            "--seed", "3", "--save-most-recent", "--mesh-shape", "2",
            "--val-data", str(d / "val-0000.tar"), "--val-num-samples", "4",
            "--logs-dir", str(d / "logs"), "--name", "dp"]
    ckpt = d / "logs" / "dp" / "checkpoints"
    return ckpt, R.spawn(R.trainer_rank, WORLD, {"argv": argv})


def test_trainer_rank_0_saves_and_picks_the_checkpoint(trainer):
    ckpt, (r0, r1) = trainer
    assert (r0["calls"]["save"], r1["calls"]["save"]) == (2, 0)
    assert (r0["calls"]["latest"], r1["calls"]["latest"]) == (1, 0)
    assert r0["calls"]["restore"] == r1["calls"]["restore"] == [
        str(ckpt / "epoch_latest.pt")]
    assert sorted(p.name for p in ckpt.iterdir()) == [
        "epoch_1.pt", "epoch_2.pt", "epoch_latest.pt"]
    # main keeps a process group it did not make
    assert r0["group_kept"] and r1["group_kept"]


def test_trainer_ranks_read_their_own_rows_and_end_on_the_same_bits(trainer):
    ckpt, (r0, r1) = trainer
    texts0, texts1 = r0["calls"]["texts"], r1["calls"]["texts"]
    assert len(texts0) == len(texts1) == 4
    for a, b in zip(texts0, texts1):
        assert a.shape == b.shape == (3, 2, 16)
        assert not np.array_equal(a, b)
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 4
    assert np.all(np.isfinite(r0["losses"]))
    # rank 0 evaluates; the other waits
    assert all(np.isfinite(v) for v in r0["val_loss"])
    assert r1["val_loss"] == [None, None]
    saved = torch.load(ckpt / "epoch_2.pt", map_location="cpu",
                       weights_only=True)
    for which in ("student", "teacher"):
        for n, t in saved[which].items():
            assert torch.equal(r0[which][n], t), f"{which} {n}"
            assert torch.equal(r1[which][n], t), f"{which} {n}"


@pytest.mark.parametrize("shape,world,ok", [
    ("1", 1, True), ("1,1", 1, True), ("2", 2, True), ("2,1", 2, True),
    ("2", 1, False), ("4", 2, False)])
def test_mesh_shape_names_the_world(shape, world, ok):
    from cosmos_tpu_torch.training import main as pmain
    from cosmos_tpu_torch.training.params import parse_args

    args = parse_args(["--mesh-shape", shape])
    if ok:
        pmain.check_mesh_shape(args, world)
    else:
        with pytest.raises(ValueError, match="one rank a card"):
            pmain.check_mesh_shape(args, world)


def test_a_data_mesh_larger_than_the_world_is_refused(tmp_path):
    from cosmos_tpu_torch.training import main as pmain

    with pytest.raises(ValueError, match="this world has 1 rank"):
        pmain.main(["--mesh-shape", "2", "--logs-dir", str(tmp_path)],
                   device="cpu")
    with pytest.raises(ValueError, match="coordinator"):
        pmain.main(["--num-processes", "2", "--logs-dir", str(tmp_path)],
                   device="cpu")
    assert not list(tmp_path.iterdir())
