"""The ranks of the port's data-parallel tests (tests/test_torch_distributed.py,
tests/test_torch_dp_train.py): gloo process groups on the CPU.

``spawn(fn, world, payload)`` starts ``world`` processes with
``torch.multiprocessing`` on a ``FileStore`` (no port), calls
``fn(rank, world, payload)`` in each under the process group, and returns
the ranks' results.  A spawned process imports this module again, and no
more: it imports no JAX, so a rank starts in the time torch takes.  The
JAX side of each comparison runs in the test's own process.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a spawn may take before its ranks are killed: a rank that misses
# a collective hangs the others
SPAWN_TIMEOUT = 120.0

TINY = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
            vision_width=32, vision_layers=1, vision_head_width=16,
            text_context_length=12, text_vocab_size=128, text_width=32,
            text_heads=2, text_layers=1)
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
SIGLIP = dict(init_logit_scale=float(np.log(10.0)), init_logit_bias=-10.0)
LR, BETA1, EPS = 1e-3, 0.9, 1e-3


def _entry(rank: int, world: int, store: str, fn: Callable, payload_path: str,
           out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=SPAWN_TIMEOUT))
    try:
        with open(payload_path, "rb") as f:
            payload = pickle.load(f)
        try:
            result = fn(rank, world, payload)
        except BaseException:
            with open(f"{out}.{rank}.err", "w") as f:
                f.write(traceback.format_exc())
            raise
        torch.save(result, f"{out}.{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, payload: Any,
          timeout: float = SPAWN_TIMEOUT) -> List[Any]:
    """``fn(rank, world, payload)`` on ``world`` gloo ranks; the results in
    rank order.  Raises with the ranks' tracebacks if one fails, and kills
    them all if they outlast ``timeout`` seconds."""
    with tempfile.TemporaryDirectory(prefix="torch_dp_") as tmp:
        payload_path, out = f"{tmp}/payload.pkl", f"{tmp}/result"
        with open(payload_path, "wb") as f:
            pickle.dump(payload, f)
        ctx = mp.start_processes(
            _entry, args=(world, f"{tmp}/store", fn, payload_path, out),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"{fn.__name__} on {world} ranks outlasted "
                        f"{timeout} s")
        except Exception as e:
            errs = [open(f"{out}.{r}.err").read() for r in range(world)
                    if os.path.exists(f"{out}.{r}.err")]
            raise RuntimeError("\n".join(errs) or str(e)) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(5)
        return [torch.load(f"{out}.{r}.pt", weights_only=False)
                for r in range(world)]


def block(x: np.ndarray, rank: int, world: int, axis: int = 1) -> np.ndarray:
    """This rank's contiguous block of the batch axis (JAX's
    ``shard_batch`` layout)."""
    b = x.shape[axis] // world
    return np.take(x, range(rank * b, (rank + 1) * b), axis=axis)


# --- the losses ---------------------------------------------------------

# case -> (loss, constructor kwargs); every case runs at every world size
LOSS_CASES = {
    "clip-global-grad": ("clip", dict(local_loss=False, gather_with_grad=True)),
    "clip-global-nograd": ("clip", dict(local_loss=False,
                                        gather_with_grad=False)),
    "clip-local-grad": ("clip", dict(local_loss=True, gather_with_grad=True)),
    "clip-local-nograd": ("clip", dict(local_loss=True,
                                       gather_with_grad=False)),
    "cosmos-global": ("cosmos", dict(local_loss=False)),
    "cosmos-local": ("cosmos", dict(local_loss=True)),
    "distill-global": ("distill", dict(local_loss=False)),
    "distill-local-nograd": ("distill", dict(local_loss=True,
                                             gather_with_grad=False)),
    "siglip-bidir": ("siglip", dict(bidir=True)),
    "siglip-one-way": ("siglip", dict(bidir=False)),
}
# the feature inputs of each loss: name -> views
LOSS_INPUTS = {
    "clip": {"image_features": 3, "text_features": 2},
    "cosmos": {"s_image_features": 4, "s_text_features": 3,
               "t_image_features": 2, "t_text_features": 2,
               "s_img_crossmodal_features": 4,
               "s_txt_crossmodal_features": 3},
    "distill": {"image_features": 2, "text_features": 2,
                "dist_image_features": 2, "dist_text_features": 2},
    "siglip": {"image_features": 1, "text_features": 1},
}
LOSS_SCALES = {"clip": ("logit_scale",),
               "cosmos": ("logit_scale", "distill_logit_scale"),
               "distill": ("logit_scale", "dist_logit_scale"),
               "siglip": ("logit_scale", "logit_bias")}


def loss_inputs(kind: str, batch: int, dim: int = 8, seed: int = 0
                ) -> Dict[str, np.ndarray]:
    """Unit-norm [V, batch, dim] features and the scales, from a seed."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, views in LOSS_INPUTS[kind].items():
        x = rng.standard_normal((views, batch, dim)).astype(np.float32)
        out[name] = x / np.linalg.norm(x, axis=-1, keepdims=True)
    for name in LOSS_SCALES[kind]:
        out[name] = np.float32(-2.0 if name == "logit_bias"
                               else rng.uniform(2.0, 12.0))
    return out


def call_loss(fn, kind: str, t: Dict[str, Any]):
    """The scalar loss of one case: DistillClipLoss's two terms summed."""
    if kind == "distill":
        return sum(fn(**t))
    if kind == "siglip":
        return fn(t["image_features"], t["text_features"], t["logit_scale"],
                  t["logit_bias"])
    return fn(**t)


def losses_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """Each case's loss on this rank, and its gradients with respect to
    this rank's feature blocks and the scales (none where the loss detaches
    an input)."""
    from cosmos_tpu_torch.losses import contrastive as C

    ctor = {"clip": C.ClipLoss, "cosmos": C.COSMOSLoss,
            "distill": C.DistillClipLoss, "siglip": C.SigLipLoss}
    out = {}
    for case, inputs in payload.items():
        kind, kw = LOSS_CASES[case]
        t = {k: torch.tensor(block(v, rank, world) if v.ndim == 3 else v,
                             requires_grad=True)
             for k, v in inputs.items()}
        loss = call_loss(ctor[kind](**kw), kind, t)
        loss.backward()
        out[case] = {"loss": loss.detach().numpy(),
                     **{k: v.grad.numpy() for k, v in t.items()
                        if v.grad is not None}}
    return out


# --- the training step --------------------------------------------------

# mode -> (model overrides, step config, micro-batches)
STEP_MODES = {
    "cosmos": (COSMOS, dict(cosmos=True), 1),
    "clip-accum-exact": ({}, dict(cosmos=False, accum_freq=2), 2),
    "siglip": (SIGLIP, dict(cosmos=False, siglip=True), 1),
}


def step_batch(global_batch: int, accum: int, seed: int = 3
               ) -> Dict[str, np.ndarray]:
    """uint8 views of the global batch (2 global 16px, 2 local 8px crops,
    3 caption views), with a leading micro-batch axis when ``accum`` > 1."""
    rng = np.random.default_rng(seed)
    lead = (accum,) if accum > 1 else ()
    return {
        "global_images": rng.integers(0, 256, lead + (2, global_batch, 16,
                                                      16, 3), np.uint8),
        "local_images": rng.integers(0, 256, lead + (2, global_batch, 8, 8,
                                                     3), np.uint8),
        "texts": rng.integers(1, 127, lead + (3, global_batch, 12)).astype(
            np.int32),
    }


def port_step(mode: str, init: Dict[str, Any], batch: Dict[str, np.ndarray],
              steps: int = 1) -> Dict[str, Any]:
    """``steps`` steps of the port's ``make_train_step`` from ``init`` on
    ``batch`` (this rank's block under a process group): the last metrics,
    the averaged gradients and the updated student and teacher."""
    from cosmos_tpu_torch import (create_model, create_optimizer,
                                  create_train_state, make_train_step)
    from cosmos_tpu_torch.training import scheduler
    from cosmos_tpu_torch.training.train import TrainStepConfig

    model_kw, cfg_kw, _ = STEP_MODES[mode]
    model = create_model("ViT-B-16", device="cpu", **TINY, **model_kw)
    model.load_state_dict(init, strict=True)
    lr = scheduler.const_lr(LR, 0, 10)
    opt = create_optimizer(model, lr, beta1=BETA1, beta2=0.98, eps=EPS,
                           weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True, **cfg_kw)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    for _ in range(steps):
        metrics = step(state, {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None},
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict()}


def steps_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """Each mode's step on this rank's block of the payload's batch."""
    out = {}
    for mode, (init, batch) in payload.items():
        axis = 2 if STEP_MODES[mode][2] > 1 else 1
        local = {k: block(v, rank, world, axis) for k, v in batch.items()}
        out[mode] = port_step(mode, init, local)
    return out


# --- the trainer --------------------------------------------------------

def trainer_rank(rank: int, world: int, payload) -> Dict[str, Any]:
    """``main([...])`` twice under the process group, a run of one epoch
    then ``--resume latest`` into a second, recording which ranks save,
    look for the latest checkpoint and restore which path, the texts of
    every batch the step receives, and the student and teacher each rank
    ends on."""
    from cosmos_tpu_torch.training import checkpoint, main as trainer, train

    calls = {"save": 0, "latest": 0, "restore": [], "texts": []}
    live = {}
    save, latest, restore = (checkpoint.save_checkpoint,
                             checkpoint.get_latest_checkpoint,
                             checkpoint.restore_checkpoint)
    make_step = train.make_train_step

    def counted_save(*a, **kw):
        calls["save"] += 1
        return save(*a, **kw)

    def counted_latest(*a, **kw):
        calls["latest"] += 1
        return latest(*a, **kw)

    def counted_restore(state, path):
        calls["restore"].append(path)
        return restore(state, path)

    def recorded_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def recorded(state, batch):
            calls["texts"].append(batch["texts"].numpy().copy())
            live["state"] = state
            return step(state, batch)
        return recorded

    checkpoint.save_checkpoint = counted_save
    checkpoint.get_latest_checkpoint = counted_latest
    checkpoint.restore_checkpoint = counted_restore
    train.make_train_step = recorded_make_step
    argv = payload["argv"]
    runs = [trainer.main(argv + ["--epochs", "1"], device="cpu"),
            trainer.main(argv + ["--epochs", "2", "--resume", "latest"],
                         device="cpu")]
    state = live["state"]
    return {"calls": calls, "group_kept": dist.is_initialized(),
            "losses": [line["loss"] for r in runs
                       for s in r["train_epoch_stats"] for line in s["logged"]],
            "val_loss": [r.get("clip_val_loss") for r in runs],
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict()}
