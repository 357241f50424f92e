"""The port's losses under a process group (cosmos_tpu_torch.losses with
cosmos_tpu_torch.parallel.distributed) against cosmos_tpu.losses under
shard_map, on 2 and 3 gloo ranks on the CPU (tests/torch_dp_ranks.py).

Each rank holds its contiguous block of the batch, as a device of JAX's
data mesh does (``parallel/mesh.py`` ``shard_batch``).  Compared, for
every case of ``LOSS_CASES`` (ClipLoss under {global, local} x {gather
with, without gradient}; COSMOSLoss; DistillClipLoss; SigLipLoss's ring,
both ways and one way, 3 ranks for the remainder hop): each rank's loss
and its gradients with respect to its own feature blocks and the scales,
within 1e-5.  JAX runs on the first 2 or 3 of the 8 virtual CPU devices of
tests/conftest.py.  Also the process-group helpers of
``parallel/distributed.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dp_ranks as R
from cosmos_tpu.losses import contrastive as J
from cosmos_tpu_torch.parallel import distributed

WORLDS = (2, 3)
# features [V, 4 per rank, 8]
PER_RANK = 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(case, world):
    kind, _ = R.LOSS_CASES[case]
    return R.loss_inputs(kind, PER_RANK * world,
                         seed=sorted(R.LOSS_CASES).index(case))


@pytest.fixture(scope="module", params=WORLDS)
def port(request):
    """(world, {case: [each rank's result]}) from one spawn per world."""
    world = request.param
    payload = {case: _inputs(case, world) for case in R.LOSS_CASES}
    ranks = R.spawn(R.losses_rank, world, payload)
    return world, {case: [r[case] for r in ranks] for case in R.LOSS_CASES}


def _jax_case(case, inputs, world):
    """Each device's loss and gradients under shard_map, stacked by rank:
    feature gradients [V, world * B, D], loss and scale gradients
    [world]."""
    kind, kw = R.LOSS_CASES[case]
    jax_kw = dict(kw, axis_name="data")
    obj = {"clip": J.ClipLoss, "cosmos": J.COSMOSLoss,
           "distill": J.DistillClipLoss, "siglip": J.SigLipLoss}[kind](**jax_kw)
    feats = {k: v for k, v in inputs.items() if v.ndim == 3}
    scales = {k: v for k, v in inputs.items() if v.ndim == 0}

    def per_device(f, s):
        loss, (gf, gs) = jax.value_and_grad(
            lambda f, s: R.call_loss(obj, kind, {**f, **s}),
            argnums=(0, 1))(f, s)
        return loss[None], gf, {k: v[None] for k, v in gs.items()}

    mesh = Mesh(np.asarray(jax.devices()[:world]), ("data",))
    fn = shard_map(per_device, mesh=mesh, in_specs=(P(None, "data"), P()),
                   out_specs=(P("data"), P(None, "data"), P("data")),
                   check_vma=False)
    loss, gf, gs = jax.jit(fn)({k: jnp.asarray(v) for k, v in feats.items()},
                               {k: jnp.asarray(v) for k, v in scales.items()})
    return (np.asarray(loss), {k: np.asarray(v) for k, v in gf.items()},
            {k: np.asarray(v) for k, v in gs.items()})


@pytest.mark.parametrize("case", sorted(R.LOSS_CASES))
def test_loss_and_gradients_match_shard_map(port, case):
    world, results = port
    inputs = _inputs(case, world)
    want_loss, want_gf, want_gs = _jax_case(case, inputs, world)
    ranks = results[case]
    np.testing.assert_allclose([float(r["loss"]) for r in ranks], want_loss,
                               **TOL, err_msg="loss")
    for name, want in want_gf.items():
        if name not in ranks[0]:
            # the port detaches the teacher's and the frozen model's
            # features: JAX's gradient for them is zero too
            assert not want.any(), name
            continue
        got = np.concatenate([r[name] for r in ranks], axis=1)
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)
    for name, want in want_gs.items():
        if name == "dist_logit_scale":
            # the frozen model's scale: the port detaches it, and JAX's
            # step never differentiates the frozen model's parameters
            assert name not in ranks[0]
            continue
        got = np.array([r[name] for r in ranks])
        np.testing.assert_allclose(got, want, **TOL, err_msg=name)


def test_local_loss_changes_each_ranks_loss(port):
    # the global loss is the same on every rank; the local one is not
    world, results = port
    glob = [float(r["loss"]) for r in results["clip-global-grad"]]
    local = [float(r["loss"]) for r in results["clip-local-grad"]]
    assert max(glob) - min(glob) <= 1e-6 * max(abs(x) for x in glob)
    assert max(local) - min(local) > 1e-3


def test_helpers_are_identities_without_a_process_group():
    assert not distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.init_distributed("cpu") == (0, 1)
    assert not distributed.is_initialized()
    obj = {"path": "x"}
    assert distributed.broadcast_object(obj) is obj
    t = torch.arange(4.0)
    distributed.all_reduce_mean_([t])
    distributed.broadcast_([t])
    distributed.barrier()
    distributed.destroy()
    assert torch.equal(t, torch.arange(4.0))


@pytest.mark.parametrize("env,flags,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1"}, {},
     ("env://", 3, 4, 1)),
    ({}, dict(coordinator_address="host:1234", num_processes=2,
              process_id=1), ("tcp://host:1234", 1, 2, None)),
    ({"COORDINATOR_ADDRESS": "h:9", "NUM_PROCESSES": "3", "PROCESS_ID": "0"},
     {}, ("tcp://h:9", 0, 3, None)),
    # the JAX flags win over torchrun's environment
    ({"RANK": "0", "WORLD_SIZE": "2"},
     dict(coordinator_address="c:1", num_processes=4, process_id=2),
     ("tcp://c:1", 2, 4, None)),
])
def test_init_distributed_reads_torchrun_and_the_jax_flags(
        monkeypatch, env, flags, want):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "COORDINATOR_ADDRESS",
              "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = {}

    def fake_init(backend, init_method, rank, world_size, **kw):
        seen.update(backend=backend, init_method=init_method, rank=rank,
                    world=world_size, **kw)

    monkeypatch.setattr(torch.distributed, "init_process_group", fake_init)
    assert distributed.init_distributed("cpu", **flags) == want[1:3]
    assert (seen["init_method"], seen["rank"], seen["world"]) == want[:3]
    assert seen["backend"] == "gloo" and "device_id" not in seen
    # on the card: NCCL, bound to cuda:LOCAL_RANK (or the rank modulo the
    # host's cards)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    bound = []
    monkeypatch.setattr(torch.cuda, "set_device", bound.append)
    distributed.init_distributed(None, **flags)
    local = want[3] if want[3] is not None else want[1] % 2
    assert seen["backend"] == "nccl" and bound == [local]
    assert seen["device_id"] == torch.device("cuda", local)


def test_init_distributed_refuses_a_world_without_a_coordinator(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        distributed.init_distributed("cpu", num_processes=2)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        distributed.init_distributed(None)
