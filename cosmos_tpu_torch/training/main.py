"""The trainer and eval entry point (counterpart of
``cosmos_tpu/training/main.py``).

    python -m cosmos_tpu_torch.training.main --train-data 'shards/{0000..0007}.tar' \\
        --dataset-type webdataset --train-num-samples 768 --model ViT-B-16 \\
        --use-imagecrop-aug --caption-sampling-mode textcrop \\
        --cosmos --output-all --attentional-pool --fix-momentum ...

The JAX trainer's flags (``training/params.py``), one process a card: the
model and its EMA teacher, AdamW with the weight-decay mask and
the LR schedule, the teacher-momentum schedule, resume (a path or
``latest``), the step's modes (COSMOS, plain CLIP, ``--siglip``,
``--distill-model`` with a local ``.pt``) and options (``--accum-freq``,
``--force-patch-dropout``, ``--grad-checkpointing``/``--remat-policy``,
``--lock-image*``/``--lock-text*``, ``--init-last-layer``,
``--flash-attention``), the epoch loop over webdataset shards or a CSV of
(image path, caption) rows with a CUDA-stream prefetcher, the per-epoch val
and retrieval evals of student and teacher, and ``.pt`` checkpoints in the
reference's layout (``training/checkpoint.py``), synced to a remote with
``--remote-sync`` (``training/file_utils.py``).  ``--trace`` exports the
encoders (``models/trace.py``); ``--profile-steps N`` writes a
``torch.profiler`` Chrome trace of the first N steps of the first epoch to
``<logs>/<name>/profile/rank<r>.trace.json``.  The evals: val loss, COCO/Flickr retrieval, and zero-shot
classification on ImageNet (``--imagenet-val``, ``--imagenet-v2``) and the
classification sets (``--zeroshot-eval-datasets`` under
``--classification-data-dir``).  Without train data, or with ``--eval-mode
retrieval/classification``, it only evaluates (``--pretrained`` a local
``.pt``); ``--eval-mode segmentation`` exits naming its own entry point,
``python -m cosmos_tpu_torch.training.seg_eval``.

Data parallelism, the JAX trainer's data mesh with one process a card::

    torchrun --nproc-per-node N -m cosmos_tpu_torch.training.main <flags>

or JAX's ``--coordinator-address/--num-processes/--process-id`` in each
process.  Each rank reads its share of the shards and takes ``--batch-size``
rows a step, so the global batch is N times it; the losses gather the
features of every rank and the step averages the gradients
(``parallel/distributed.py``, ``train.py``).  Rank 0 starts every rank
from its weights, picks the checkpoint ``--resume latest`` names, runs the
evals, writes the checkpoints, ``out.log`` and the reports, while the other
ranks wait at a barrier.

``main(argv, device=None)`` runs on the card and raises without CUDA;
``device="cpu"`` runs on the CPU (gloo under a world).  The module imports
no torch at its top: the loader's worker processes re-import the
``__main__`` module, and must stay free of torch and CUDA.  A flag whose
feature is not ported yet raises ``NotImplementedError`` at start-up,
naming its ROADMAP item by title (``UNPORTED``): nothing runs in another
mode than the one asked for.
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import time
from typing import Any, Callable, Dict, Union

import numpy as np

logger = logging.getLogger(__name__)

# ROADMAP's items, by title, for what the port refuses
NEEDS_DOWNLOAD = 'queue 1, "Not queued": it needs a download'
BEYOND_DP = 'queue 1, "Beyond DP"'
OTHER_TOWERS = 'queue 1, "Other towers, configs and tools"'

# (flag as given, whether the args set it, ROADMAP item): features the port
# does not have yet.  Each is refused at start-up when set.
UNPORTED = (
    ("--huggingface-*", lambda a: (bool(a.huggingface_model_name)
                                   or a.huggingface_repo_name
                                   != "sankim2/cosmos"), NEEDS_DOWNLOAD),
    ("--mesh-shape dp,tp with tp > 1",
     lambda a: a.mesh_shape is not None and "," in a.mesh_shape
     and int(a.mesh_shape.split(",")[1]) > 1, BEYOND_DP),
    ("--fsdp", lambda a: a.fsdp, BEYOND_DP),
    ("--num-slices", lambda a: a.num_slices != 1 or a.gather_scope != "global",
     BEYOND_DP),
    ("CoCa models and --coca-*", lambda a: ("coca" in a.model.lower()
                                             or a.coca_caption_loss_weight != 2.0
                                             or a.coca_contrastive_loss_weight
                                             != 1.0), OTHER_TOWERS),
)


def check_ported(args) -> None:
    """Raise NotImplementedError for the first flag whose feature is not
    ported, or a ``--distill-pretrained`` that is not a local file, naming
    its ROADMAP item."""
    for flag, is_set, item in UNPORTED:
        if is_set(args):
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP {item})")
    if args.distill:
        _pretrained_path(args.distill_pretrained, "--distill-pretrained")


def random_seed(seed: int = 42) -> None:
    import random

    random.seed(seed)
    np.random.seed(seed)


def experiment_name(args) -> str:
    """Auto-name from date/model/lr/batch."""
    if args.name:
        return args.name
    date_str = datetime.datetime.now().strftime("%Y_%m_%d-%H_%M_%S")
    parts = [
        date_str,
        f"model_{args.model.replace('/', '-')}",
        f"lr_{args.lr}",
        f"b_{args.batch_size}",
    ]
    if getattr(args, "wandbkeyword", ""):
        parts.append(f"key_{args.wandbkeyword}")
    return "-".join(parts)


def _pretrained_path(pretrained: str, flag: str = "--pretrained") -> str:
    if not os.path.isfile(pretrained):
        raise NotImplementedError(
            f"{flag} {pretrained!r}: only a local .pt file is ported; "
            f"a pretrained tag needs a download (ROADMAP {NEEDS_DOWNLOAD})")
    return pretrained


def check_mesh_shape(args, world: int) -> None:
    """``--mesh-shape N`` (or ``N,1``) names the data axis: N must be the
    number of ranks, one a card."""
    if args.mesh_shape is None:
        return
    dp = int(args.mesh_shape.split(",")[0])
    if dp != world:
        raise ValueError(
            f"--mesh-shape {args.mesh_shape}: the data axis is one rank a "
            f"card, and this world has {world} rank(s)")


def main(argv=None, *, device: Union[str, "torch.device", None] = None
         ) -> Dict[str, Any]:
    from ..parallel import distributed
    from .params import parse_args

    args = parse_args(argv)
    check_ported(args)
    # a process group the caller made is the caller's to destroy
    owned = not distributed.is_initialized()
    rank, world = distributed.init_distributed(
        device, args.coordinator_address, args.num_processes,
        args.process_id)
    try:
        check_mesh_shape(args, world)
        return _main(args, device, rank, world)
    finally:
        if owned:
            distributed.destroy()


def _broadcast_state(state) -> None:
    """Rank 0's student, teacher, optimizer state and step counts on
    every rank (the identity without a process group)."""
    import torch

    from ..parallel import distributed

    opt_state = [v for s in state.optimizer.state.values()
                 for v in s.values() if torch.is_tensor(v)]
    distributed.broadcast_([*state.student.state_dict().values(),
                            *state.teacher.state_dict().values(),
                            *opt_state])
    state.step, state.optimizer.num_updates = distributed.broadcast_object(
        (state.step, state.optimizer.num_updates))


def _main(args, device, rank: int, world: int) -> Dict[str, Any]:
    from ..models.convert import load_checkpoint
    from ..models.factory import (create_model, get_tokenizer, resolve_device,
                                  resolve_dtype)
    from ..parallel import distributed
    from .checkpoint import (get_latest_checkpoint, restore_checkpoint,
                             save_checkpoint)
    from .data_pipeline import get_data
    from .evaluate import evaluate
    from .logger import setup_logging
    from .scheduler import cosine_scheduler, get_lr_scheduler
    from .train import (TrainStepConfig, create_optimizer, create_train_state,
                        freeze, frozen_mask, make_train_step)

    dev = resolve_device(device)
    random_seed(args.seed)
    is_main = rank == 0

    # rank 0's name: the date in the default one differs between ranks
    args.name = distributed.broadcast_object(experiment_name(args))
    log_dir = os.path.join(args.logs_dir, args.name)
    if is_main:
        os.makedirs(log_dir, exist_ok=True)
    setup_logging(os.path.join(log_dir, "out.log") if is_main else None,
                  level=logging.DEBUG if args.debug else logging.INFO,
                  include_host=world > 1, rank=rank if world > 1 else None)
    if args.checkpoint_path is None:
        args.checkpoint_path = os.path.join(log_dir, "checkpoints")
    logger.info(f"device {dev}, rank {rank} of {world}")

    if is_main:
        with open(os.path.join(log_dir, "params.txt"), "w") as f:
            for k in sorted(vars(args)):
                f.write(f"{k}: {getattr(args, k)}\n")

    if is_main and args.copy_codebase:
        # reproducibility snapshot: the package next to the run's logs
        import shutil

        code_dir = os.path.join(log_dir, "code")
        if os.path.exists(code_dir):
            logger.warning(f"--copy-codebase: {code_dir} already exists; "
                           "skipping (use --name for a fresh experiment)")
        else:
            src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
            shutil.copytree(
                src, os.path.join(code_dir, "cosmos_tpu_torch"),
                ignore=shutil.ignore_patterns(
                    "__pycache__", "*.pyc", "logs", "wandb"),
            )
            logger.info(f"copied codebase to {code_dir}")

    # --- model -----------------------------------------------------------
    overrides: Dict[str, Any] = {}
    if args.siglip:
        # SigLIP's init: logit scale ln 10, bias -10
        overrides.update(init_logit_scale=float(np.log(10.0)),
                         init_logit_bias=-10.0)
    if args.pool_type:
        overrides["vision_pool_type"] = args.pool_type
    if args.force_image_size is not None:
        overrides["vision_image_size"] = args.force_image_size
    if args.force_quick_gelu:
        overrides["quick_gelu"] = True
    model = create_model(
        args.model,
        precision=args.precision,
        cosmos=args.cosmos,
        output_all=args.output_all,
        attentional_pool=args.attentional_pool,
        add_zero_attn=args.add_zero_attn,
        act_approx=args.gelu_approx,
        text_bucket=args.text_bucket,
        grad_checkpointing=args.grad_checkpointing,
        remat_policy=args.remat_policy,
        # 'on' and 'auto' take the kernel path where its gate admits it
        # (on the CPU its plain version), 'off' the plain attention
        use_flash={"auto": None, "on": True, "off": False}[
            args.flash_attention],
        force_patch_dropout=args.force_patch_dropout,
        seed=args.seed,
        device=dev,
        **overrides,
    )
    pretrained = _pretrained_path(args.pretrained) if args.pretrained else None
    if pretrained:
        model.load_state_dict(load_checkpoint(pretrained), strict=True)
        logger.info(f"loaded student weights from {pretrained}")
    tokenizer = get_tokenizer(args.model)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model {args.model}: {n_params / 1e6:.1f}M params")

    # the frozen model of --distill-model: never in the optimizer, the EMA
    # or the checkpoint
    dist_model = None
    if args.distill:
        dist_model = create_model(args.distill_model,
                                  precision=args.precision, device=dev)
        dist_model.load_state_dict(load_checkpoint(args.distill_pretrained),
                                   strict=True)
        logger.info(f"distilling from {args.distill_model} "
                    f"({args.distill_pretrained})")

    if args.trace:
        # the serving encoders from the initial weights, at --batch-size;
        # training goes on after
        trace_dir = args.trace_path or os.path.join(log_dir, "traced")
        if is_main:
            from ..models.trace import save_traced, trace_model

            save_traced(trace_model(model, batch_size=args.batch_size),
                        trace_dir)
            logger.info(f"traced encoders -> {trace_dir}")

    # --- data ------------------------------------------------------------
    data = get_data(
        args,
        tokenizer,
        process_index=rank,
        process_count=world,
        image_size=model.cfg.vision_cfg.image_size,
        context_length=model.cfg.text_cfg.context_length,
    )

    # --- eval-only -------------------------------------------------------
    if args.eval_mode == "segmentation":
        raise SystemExit(
            "--eval-mode segmentation: segmentation has its own CLI — "
            "python -m cosmos_tpu_torch.training.seg_eval (see "
            "scripts/inference_segmentation.sh)"
        )
    if "train" not in data or args.eval_mode:
        # rank 0 evaluates while the others wait
        if not is_main:
            distributed.barrier()
            return {}
        teacher = None
        if pretrained:
            # the reference loads student AND teacher from the checkpoint;
            # a bare state dict gives the same weights for both
            import copy

            teacher = copy.deepcopy(model).requires_grad_(False)
            teacher.load_state_dict(load_checkpoint(pretrained, "teacher"),
                                    strict=True)
        metrics = evaluate(model, teacher, data, 0, args, tokenizer)
        print(json.dumps(metrics, default=float))
        distributed.barrier()
        return metrics

    # --- optimizer / schedules -------------------------------------------
    train_info = data["train"]
    steps_per_epoch = train_info.num_batches
    total_steps = steps_per_epoch * args.epochs
    if args.skip_scheduler:
        # no warm-up or decay: the LR stays at its base value
        base_lr = float(args.lr)
        lr_schedule: Callable[[int], float] = lambda step: base_lr  # noqa: E731
    else:
        if args.lr_scheduler == "const-cooldown" and not args.epochs_cooldown:
            raise ValueError(
                "--lr-scheduler const-cooldown requires --epochs-cooldown"
            )
        lr_schedule = get_lr_scheduler(
            args.lr_scheduler,
            args.lr,
            args.warmup,
            total_steps,
            cooldown_steps=steps_per_epoch * (args.epochs_cooldown or 0),
            cooldown_power=args.lr_cooldown_power,
            cooldown_end_lr=args.lr_cooldown_end,
        )
    # LiT locking: frozen parameters take no gradient and stay out of the
    # optimizer
    frozen = None
    if args.lock_image or args.lock_text:
        frozen = frozen_mask(model, args.lock_image, args.lock_text,
                             args.lock_image_unlocked_groups,
                             args.lock_text_unlocked_layers,
                             args.lock_text_freeze_layer_norm)
        freeze(model, frozen)
        logger.info(f"locked {sum(frozen.values())} of {len(frozen)} "
                    "parameter tensors")
    optimizer = create_optimizer(
        model,
        lr_schedule,
        beta1=args.beta1,
        beta2=args.beta2,
        eps=args.eps,
        weight_decay=args.wd,
        grad_clip_norm=args.grad_clip_norm,
    )
    momentum_schedule = cosine_scheduler(
        args.momentum_teacher, 1.0, 0, total_steps
    )
    step_cfg = TrainStepConfig(
        cosmos=args.cosmos,
        siglip=args.siglip,
        distill=args.distill,
        accum_freq=args.accum_freq,
        frozen=frozen,
        seed=args.seed,
        local_loss=args.local_loss,
        gather_with_grad=args.gather_with_grad,
        momentum_teacher=args.momentum_teacher,
        fix_momentum=args.fix_momentum,
        momentum_schedule=momentum_schedule,
        lr_schedule=lr_schedule,
        input_dtype=resolve_dtype(args.precision),
        log_grad_norm=(args.grad_clip_norm is not None or args.log_grad_norm),
        **({"image_mean": tuple(args.image_mean)} if args.image_mean else {}),
        **({"image_std": tuple(args.image_std)} if args.image_std else {}),
    )
    model.train()
    # the teacher starts as a copy of the (possibly pretrained) student
    state = create_train_state(model, optimizer)
    if args.init_last_layer:
        import torch

        from ..models.init_utils import reinit_last_transformer_layer

        # after the teacher's copy, an independent draw for each
        reinit_last_transformer_layer(
            state.student, torch.Generator().manual_seed(args.seed + 1))
        reinit_last_transformer_layer(
            state.teacher, torch.Generator().manual_seed(args.seed + 2))
    step_fn = make_train_step(model, optimizer, step_cfg,
                              dist_model=dist_model)

    # --- resume ------------------------------------------------------------
    start_epoch = 0
    resume = args.resume
    if resume == "latest":
        # rank 0 picks and tells the others: each rank looking for itself
        # could race a save and restore another epoch
        resume = distributed.broadcast_object(
            get_latest_checkpoint(args.checkpoint_path) if is_main else None)
        logger.info(f"resume latest -> {resume}")
    if resume:
        # the saved epoch is the COMPLETED-epoch count: training continues
        # from that index
        start_epoch = restore_checkpoint(state, resume)
        logger.info(f"resumed from {resume} at epoch {start_epoch}")
    # every rank starts from rank 0's state
    _broadcast_state(state)

    # --- remote sync daemon (rank 0) -------------------------------------
    sync_proc = None
    if args.remote_sync and is_main:
        from .file_utils import remote_sync, start_sync_process

        if not remote_sync(args.checkpoint_path, args.remote_sync,
                           args.remote_sync_protocol):
            logger.error("initial remote sync failed — continuing without")
        else:
            sync_proc = start_sync_process(
                args.remote_sync_frequency,
                args.checkpoint_path,
                args.remote_sync,
                args.remote_sync_protocol,
            )
            sync_proc.start()

    # --- reporting (only reports: a missing package is a warning) -----------
    writer = None
    wandb_run = None
    if is_main and "tensorboard" in args.report_to:
        try:
            from torch.utils.tensorboard import SummaryWriter

            writer = SummaryWriter(os.path.join(log_dir, "tensorboard"))
        except Exception as e:
            logger.warning(f"tensorboard unavailable: {e}")
    if is_main and "wandb" in args.report_to:
        try:
            import wandb

            wandb_run = wandb.init(
                project=args.wandb_project_name,
                entity=args.wandb_entity_name,
                notes=args.wandb_notes,
                name=args.name,
                config=vars(args),
                resume="auto",
            )
        except Exception as e:
            logger.warning(f"wandb unavailable: {e}")

    # --- epoch loop ----------------------------------------------------------
    profiler = None
    if args.profile_steps > 0:
        # every rank traces, into a file of its own
        profile_dir = os.path.join(log_dir, "profile")
        logger.info(f"profiling first {args.profile_steps} steps -> "
                    f"{profile_dir}")
        profiler = StepProfiler(
            os.path.join(profile_dir, f"rank{rank}.trace.json"), dev)
    loader_iter = iter(train_info.dataloader)
    all_metrics: Dict[str, Any] = {"train_epoch_stats": []}
    try:
        for epoch in range(start_epoch, args.epochs):
            logger.info(f"epoch {epoch} start")
            train_info.set_epoch(epoch)
            epoch_metrics, stats = train_one_epoch(
                step_fn, state, loader_iter, steps_per_epoch,
                epoch=epoch, args=args, device=dev, writer=writer,
                wandb_run=wandb_run, global_batch=args.batch_size * world,
                profiler=profiler,
            )
            all_metrics.update(epoch_metrics)
            all_metrics["train_epoch_stats"].append(stats)
            if profiler is not None:
                # a first epoch shorter than --profile-steps ends the trace
                profiler.stop()
                args.profile_steps = 0

            completed = epoch + 1
            eval_now = args.val_frequency and (
                completed % args.val_frequency == 0 or completed == args.epochs
            )
            if eval_now:
                # rank 0 evaluates while the others wait
                t0 = time.perf_counter()
                if is_main:
                    eval_metrics = evaluate(state.student, state.teacher,
                                            data, completed, args, tokenizer)
                    all_metrics.update(eval_metrics)
                    if writer is not None:
                        for k, v in eval_metrics.items():
                            if isinstance(v, (int, float)):
                                writer.add_scalar(f"eval/{k}", v, completed)
                distributed.barrier()
                stats["eval_s"] = time.perf_counter() - t0
            # the final epoch always saves, whatever the cadence
            save_now = completed == args.epochs or (
                args.save_frequency and completed % args.save_frequency == 0
            )
            if save_now:
                # every rank holds the same state: rank 0 writes it
                if is_main:
                    save_checkpoint(
                        state,
                        args.checkpoint_path,
                        completed,
                        name=args.name,
                        save_latest=args.save_most_recent,
                        delete_previous=args.delete_previous_checkpoint,
                    )
                distributed.barrier()
    finally:
        shutdown = getattr(train_info.dataloader, "shutdown", None)
        if shutdown is not None:
            shutdown()
        if profiler is not None:
            profiler.stop()
        if sync_proc is not None:
            sync_proc.terminate()
            sync_proc.join()
    if sync_proc is not None:
        # one final sync after the daemon stops: checkpoints written in the
        # last period would otherwise never reach the remote
        from .file_utils import remote_sync

        if not remote_sync(args.checkpoint_path, args.remote_sync,
                           args.remote_sync_protocol):
            logger.error("final remote sync failed")
    return all_metrics


class StepProfiler:
    """``torch.profiler`` over the host and, on the card, the device,
    started at construction; ``stop`` ends it once (later calls do
    nothing) and writes the Chrome trace to ``path``."""

    def __init__(self, path: str, device: "torch.device"):
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self.path = path
        self.device = device
        self._prof = torch.profiler.profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        if self.device.type == "cuda":
            # the traced steps' kernels end before the trace does
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._prof = None


def train_one_epoch(
    step_fn,
    state,
    loader_iter,
    steps_per_epoch: int,
    *,
    epoch: int,
    args,
    device: "torch.device",
    writer=None,
    wandb_run=None,
    global_batch: int,
    profiler: "StepProfiler | None" = None,
):
    """The hot loop: fetch a batch (prefetched onto the device), step, and
    every --log-every-n-steps (and at the last step) read the metrics and
    log them with the samples/s of the window since the last log and the
    time spent waiting for data.  The ``profiler`` stops before step
    ``args.profile_steps``, which then becomes 0.  Returns (the last logged
    metrics as ``train_*``, the epoch's stats: wall and data-wait seconds,
    the ms per step from CUDA events around the step calls on the card,
    and every logged line)."""
    import torch

    from ..data.prefetch import DevicePrefetcher, to_device

    metrics: Dict[str, float] = {}
    data_time = 0.0
    data_total = 0.0
    samples_per_step = global_batch * max(1, args.accum_freq)

    def _host_batches():
        for _ in range(steps_per_epoch):
            if args.accum_freq > 1:
                # one update's micro-batches, stacked: [A, V, B, ...]
                micro = [next(loader_iter) for _ in range(args.accum_freq)]
                yield {k: np.stack([m[k] for m in micro]) for k in micro[0]}
            else:
                yield next(loader_iter)

    depth = max(0, args.prefetch_depth)
    if depth:
        batch_iter = DevicePrefetcher(_host_batches(), device, depth=depth)
    else:
        batch_iter = (to_device(b, device) for b in _host_batches())

    cuda = device.type == "cuda"
    events = []
    logged = []
    t_start = t_end = time.perf_counter()
    t_window, steps_in_window = t_end, 0
    try:
        for i in range(steps_per_epoch):
            if profiler is not None and i == args.profile_steps:
                profiler.stop()
                args.profile_steps = 0
            batch = next(batch_iter)
            t_data = time.perf_counter()
            data_time += t_data - t_end
            data_total += t_data - t_end
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                m = step_fn(state, batch)
                end.record()
                events.append((start, end))
            else:
                m = step_fn(state, batch)
            steps_in_window += 1
            if (i % args.log_every_n_steps == 0) or (i == steps_per_epoch - 1):
                loss = float(m["loss"])  # waits for the step
                t_step = time.perf_counter()
                samples_per_sec = (
                    samples_per_step * steps_in_window
                    / max(t_step - t_window, 1e-9)
                )
                scalars = {k: float(v) for k, v in m.items()}
                logger.info(
                    f"epoch {epoch} step {i}/{steps_per_epoch} "
                    f"loss {loss:.4f} "
                    + " ".join(
                        f"{k} {v:.4g}" for k, v in scalars.items()
                        if k != "loss"
                    )
                    + f" samples/s {samples_per_sec:.1f}"
                    + f" data_t {data_time:.2f}s"
                )
                step_num = epoch * steps_per_epoch + i
                if writer is not None:
                    for k, v in scalars.items():
                        writer.add_scalar(f"train/{k}", v, step_num)
                    writer.add_scalar("train/samples_per_sec",
                                      samples_per_sec, step_num)
                if wandb_run is not None:
                    wandb_run.log(
                        {**{f"train/{k}": v for k, v in scalars.items()},
                         "train/samples_per_sec": samples_per_sec},
                        step=step_num,
                    )
                logged.append(dict(scalars, step=i,
                                   samples_per_s=samples_per_sec,
                                   data_t=data_time))
                metrics = scalars
                data_time = 0.0
                t_end = time.perf_counter()
                t_window, steps_in_window = t_end, 0
            else:
                t_end = time.perf_counter()
    finally:
        # an exception mid-epoch must not leave the producer thread parked
        # on a full queue of device batches
        if hasattr(batch_iter, "close"):
            batch_iter.close()
    wall = time.perf_counter() - t_start
    step_ms = None
    if events:
        events[-1][1].synchronize()
        step_ms = [s.elapsed_time(e) for s, e in events]
    stats = dict(epoch=epoch, steps=steps_per_epoch, wall_s=wall,
                 data_wait_s=data_total, data_wait_share=data_total / wall,
                 samples_per_s=samples_per_step * steps_per_epoch / wall,
                 step_ms=step_ms, logged=logged)
    return {f"train_{k}": v for k, v in metrics.items()}, stats


if __name__ == "__main__":
    main()
