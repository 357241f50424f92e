#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cosmos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one Hopper card (sm_90a)
and nvcc.  It builds every CUDA kernel of the serving and training paths
from the sources in the checkout and then:

  1. prints the card, its power limit and the torch / CUDA versions;
  2. builds every kernel of the port, the packed-QKV attention forward
     (K1) and backward (K2) and the fused-LayerNorm kernels K3-K6, one nvcc
     each, started together, and prints the build time and ptxas's
     register and spill lines; then the host us per call of the K3 and
     K4 wrappers beside F.layer_norm's and the parts of a launch path,
     while the process is still small;
  3. holds K1 to its plain PyTorch version at the serving path's
     geometries in float32 and bfloat16, and times K1, the plain version
     and, as a yardstick only, F.scaled_dot_product_attention on the same
     split heads, beside the least time the card could take (bound);
  4. serves COSMOS ViT-B-16 zero-shot retrieval at full width in bfloat16
     (512 images, 2560 captions with EOT truncation), checks that every
     self-attention went through K1, times the encoders and gives K1's
     share of each tower call;
  5. runs the same float32 weights on the card and on the CPU and compares
     the encoders and the COSMOS forward;
  6. holds K2 to its plain version at the training step's geometries in
     float32 and bfloat16, checks that two launches on the same inputs give
     the same bits, times K2, K1, the plain version and, as a yardstick
     only, the backward of F.scaled_dot_product_attention, beside K2's
     bound, compares the
     autograd Function's gradient (K1 then K2) on the card with the CPU's,
     and holds K1 and K2 to their plain versions at ragged lengths
     (L = 1, 63, 65, 130) in both dtypes;
  7. trains full-width ViT-B-16 COSMOS in bfloat16 (the bench recipe:
     tanh GELU, text bucket 32, per-card batch 64 with 2 global 224px, 6
     local 96px crops and 8 caption views) for 3 + 10 steps on a fixed
     synthetic batch, checks finite, falling loss (the 13th within 1e-3
     of the FMA kernels' 8.20856), the logit-scale clamp and the launches
     of every kernel per step (K1 and K2; none of K3-K6), and times the 10
     steps;
  8. takes one training step of the same recipe, 2 layers per tower, batch
     2, float32, on the card and on the CPU from the same weights, and
     compares the loss, gradients and updated student and teacher;
  9. holds the fused-LayerNorm kernels to their plain versions at the
     training step's LayerNorm geometries in float32 and bfloat16: K3
     (forward), K4 (backward), K5 (LayerNorm -> QKV projection) and K6
     (LayerNorm -> MLP; tanh GELU, plus one geometry per other
     activation), checks that two launches of each give the same bits and
     that K3's bfloat16 statistics are the bits of K5's statistics pass,
     and times each beside its plain version, the stock composition as a
     yardstick (F.layer_norm, its autograd backward, F.layer_norm +
     F.linear, F.layer_norm + F.linear + F.gelu + F.linear), its bound and,
     in bfloat16, the time before its Hopper redesign (PR 3's kernels); K3,
     K4 and their stock yardsticks also get device ms per launch (the
     profiler's kernel time, or CUDA events around calls held behind a
     sleep kernel where the profiler records none; K3/K4's events time
     is printed beside it) and host us per call (200 calls enqueued)
     apart from the wall ms of back-to-back calls; then holds K3-K6 to
     their plain versions at ragged row counts (R = 1, 63, 65, 130, 7392)
     in both dtypes, and K3/K4 at D = 1024, 1536 and 7168 (their general
     paths), with the same bits on a repeat;
 10. trains full-width ViT-B-16 COSMOS in bfloat16 (phase 7's recipe) for
     3 + 5 steps under each setting of the fused-LayerNorm paths: (a)
     layers.FUSED_LN, (b) layers.HYBRID_LN, (c) fuse_ln=True with
     FUSED_LN; checks finite, falling losses, the clamps, every student
     gradient and the exact launches of K1-K6 per step (derived from the
     step's tower calls), holds (c)'s 8th loss within 1e-3 of the loss
     before the K5/K6 redesign, and prints ms per step, samples/s, peak
     memory and a profile beside phase 7's step;
 11. repeats phase 8's 2-layer float32 step, card against CPU, under each
     of (a)-(c);
 12. drives the trainer, python -m cosmos_tpu_torch.training.main, through
     main([...]) at full width: ViT-B-16 COSMOS with scripts/train_cc3m.sh's
     flags (amp, exact GELU, no text bucket, multi-crop 2 + 6, textcrop
     with 8 captions, momentum 0.999 fixed, a checkpoint every epoch) at
     batch 64 on webdataset shards of synthetic JPEGs written from a seed
     (min(8, cpus - 1) loader workers), 2 epochs of 4 steps with val and
     COCO retrieval evals of student and teacher, then --resume latest for
     a third; checks finite losses, the logit-scale clamp, the exact K1/K2
     launches of every step (none of K3-K6), K1 only in the evals, the
     resumed run's epoch and LR, the metrics' ranges and that every
     checkpoint loads; prints ms per step (CUDA events), samples/s, the
     data-wait share, the loader alone (samples/s, per worker) and each
     eval's wall time;
 13. drives the zero-shot classification eval through the trainer's entry
     point, main([... "--eval-mode", "classification" ...]): ViT-B-16
     COSMOS in bfloat16 (amp) from a checkpoint of random weights, student
     and teacher, on an ImageNet val layout of 1000 class dirs x 1 seeded
     JPEG and a CIFAR-10 test batch of 2000 seeded images; checks 12 K1
     launches in every text and image call and none of K2-K6, the
     classifiers' prompt counts (80000 for ImageNet), the images of each
     pass and top-1/top-5 in [0, 1]; prints the classifier's build time
     and prompts/s, images/s, and holds the ImageNet classifier's columns
     of 8 classes, card against CPU, in float32;
 14. drives the segmentation eval, python -m
     cosmos_tpu_torch.training.seg_eval, through main([...]) in float32
     (its default) from the same checkpoint's weights on a voc20 layout
     (16 seeded 500x375 images) and an ade20k layout (16 images, 4 with a
     short side below 336), with --use-csa and without, then 10 PAMR
     steps on 2 images; checks 11 K1 launches in every vision call with
     CSA and 12 without (at most 8 windows a call), 12 in every text call,
     none of K2-K6, and mIoU/aAcc/mAcc in [0, 100]; prints images/s and
     windows/s, holds one image's logits, card against CPU, and times K1
     in float32 at a chunk of 8 windows [8, 197, 2304] beside SDPA and its
     bound;
 15. the trainer's options and modes: (a) holds K1 and K2 to their plain
     versions, and times them, at the lengths patch dropout at p = 0.5
     leaves ViT-B-16 at batch 64 ([128,99,2304] globals, [384,19,2304]
     locals) in float32 and bfloat16; (b) takes one 2-layer float32 step
     at batch 2 on the card and on the CPU from the same weights for plain
     CLIP with 2 micro-batches and patch dropout, SigLIP, distillation,
     LiT-locked COSMOS and COSMOS under each remat policy family, and
     compares the loss, every gradient and the updated student and
     teacher (each remat policy also against no remat on the card); (c)
     drives main([...]) at full width (ViT-B-16, amp, batch 64, phase 12's
     shards and flags, 1 epoch of 4 steps) for plain CLIP (--accum-freq 2
     --force-patch-dropout 0.5 --grad-checkpointing), LiT-locked COSMOS
     with --init-last-layer and remat, --siglip --accum-freq 2,
     --distill-model ViT-B-16 from a random .pt, and COSMOS with
     --flash-attention off; checks the exact K1/K2 launches of every step
     (none in the last; none of K3-K6), finite losses, the clamp, frozen
     parameters unchanged, the re-drawn last blocks, the samples of a step
     and one COCO retrieval eval after the locked run, and prints ms per
     step, samples/s and peak memory beside phase 12's step;
 16. data parallelism: (a) runs the trainer at world 1 on NCCL under
     torchrun (python -m torch.distributed.run --standalone
     --nproc-per-node 1 chip_smoke.py --dp-rank OUT <flags>, this script as
     the rank, which drives main([...]) as phase 12 does) with phase 12's
     flags and shards, one loader thread, 1 epoch of 4 steps and then
     --resume latest into a second, beside the same two runs in this
     process without a process group; checks that the logged metrics of
     every step and epoch_2.pt (student, teacher, optimizer state) are the
     same bits, the exact K1/K2 launches of every step (phase 12's), K1
     only in the evals; prints ms per step of both and the ms of the step's
     cross-rank mean of the gradients; (b) takes 3 steps of make_train_step
     (COSMOS, float32, full width and depth) at world 2, 32 rows a rank,
     one rank a card under NCCL where the machine has two cards, else both
     on this card under gloo, and holds the first to the world-1 step on
     all 64 rows in this process (loss, every gradient, the updated
     student and teacher) and the ranks to the same bits after the third;
     SigLIP's ring at world 2 runs under NCCL, and under gloo a send/recv
     of a CUDA tensor is tried and its refusal reported;
 17. the trainer's last flags: main([...]) at full width (phase 12's
     flags, batch 64, 2 epochs of 4 steps, no evals) on a CSV of 256
     seeded JPEG rows under --dataset-type auto, with --profile-steps 2,
     --trace, --remote-sync <tmp>/remote --remote-sync-protocol fsspec
     (every 2 s) and --save-most-recent; checks finite losses, the exact
     K1/K2 launches of every step and none in the export, each
     epoch_N.pt on the remote byte for byte and nothing else there (no
     epoch_latest, no checkpoint in writing),
     K1 and K2 kernel events in the Chrome trace (re-captured once where
     CUPTI gave none); loads the exported encoders (amp at batch 64 from
     the initial weights, and a float32 export at batch 8) in a fresh
     process, checks 12 K1 launches a tower call there and the live
     model's features (1e-5 float32, 2**-7 amp); runs the FLOPs/params
     profiler on plain and COSMOS ViT-B-16 with K1 counting (plain:
     149.62 M parameters, 41.09 GFLOPs); prints the host us per call of
     K1, K3 and K4 through their operators beside the call without the
     dispatcher and the bare ctypes call, the ms per step beside phase
     7's and the CSV loader's samples/s.

With ``--dp-rank OUT <trainer flags>`` the script is phase 16(a)'s rank
and nothing else.  Any failed check raises, so the script exits non-zero.  The last lines are
the card's name and power limit, one JSON object with the kernel records,
and {"ok": true, "device": {...}}.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import filecmp
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
# H100 SXM, dense (NVIDIA data sheet): HBM bytes/s and peak operations/s by
# input type (float32 arithmetic outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)
# (label, B, L, 3D, heads, causal): the serving path's attention geometries
GEOMETRIES = [
    ("vision ViT-B-16 224px", 256, 197, 3 * 768, 12, False),
    ("vision ViT-B-32 224px", 256, 50, 3 * 768, 12, False),
    ("vision ViT-B-16 96px locals", 1536, 37, 3 * 768, 12, False),
    ("text full context", 1280, 77, 3 * 512, 8, True),
    ("text EOT-truncated", 1280, 32, 3 * 512, 8, True),
    ("text serving batch", 256, 48, 3 * 512, 8, True),
    ("head dim 128", 64, 197, 3 * 1024, 8, False),
]
MAIN_GEOMETRY = (GEOMETRIES[0][0], torch.bfloat16)
# (label, B, L, 3D, heads, causal): the training step's attention geometries
# at a per-card batch of 64 (2 global crops, 6 local crops, 8 caption views:
# 2 full-length head views, 288 bucketed at 32 tokens, the longest 96 at 77)
TRAIN_GEOMETRIES = [
    ("vision globals", 128, 197, 3 * 768, 12, False),
    ("vision 96px locals", 384, 37, 3 * 768, 12, False),
    ("text unbucketed", 512, 77, 3 * 512, 8, True),
    ("text head views", 128, 77, 3 * 512, 8, True),
    ("text short bucket", 288, 32, 3 * 512, 8, True),
    ("text long quarter", 96, 77, 3 * 512, 8, True),
    ("head dim 128", 64, 197, 3 * 1024, 8, False),
]
TRAIN_MAIN = ("vision globals", torch.bfloat16)
# self-attention calls per training step with the text bucket: the
# student's forward runs the globals, the locals and three text calls
# (head, short bucket, long quarter), 12 layers each; the teacher's forward
# (no gradient) runs the globals and the head views
STUDENT_CALLS = {"vision globals": 12, "vision 96px locals": 12,
                 "text head views": 12, "text short bucket": 12,
                 "text long quarter": 12}
TEACHER_CALLS = {"vision globals": 12, "text head views": 12}
TRAIN_RECIPE = dict(cosmos=True, output_all=True, attentional_pool=True,
                    add_zero_attn=True, act_approx=True, text_bucket=32)
# the serving phase's tower calls: 256 images at 224px, 256 captions whose
# EOT positions (8..40) truncate to 48 tokens
SERVING_GEOMETRIES = {"image": "vision ViT-B-16 224px",
                      "text": "text serving batch"}
# kernel vs plain version on the same card.  float32: summation order only
# (measured ~7e-7).  bfloat16: the kernel rounds exp(s - m) to bf16 and
# divides by the row sum at the end, the plain version rounds the
# normalised P: one bf16 ulp of outputs |o| < 4 plus 1% relative
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}
# K2 vs plain version on the same card.  float32: summation order over up
# to 197 keys or queries (FMA chains against cuBLAS blocked sums).
# bfloat16: both round P and ds to bf16 before their products; a last-bit
# float32 difference can move one across a bf16 boundary, so one bf16 ulp
# of gradients |g| < 4 plus 1% relative, as for K1
KERNEL_BWD_TOL = {torch.float32: (1e-4, 1e-4),
                  torch.bfloat16: (1.6e-2, 1e-2)}
# phase 7's 13th loss on the default path before the redesign (repeated to
# every digit across runs); the tensor cores sum in another order, so the
# loss is held within 1e-3 of it
PREV_LOSS_13 = 8.20856
LOSS_13_TOL = 1e-3
# phase 10(c)'s 8th loss under fuse_ln with the K5/K6 of before the Hopper
# redesign (the mma.sync kernels; PERF.md, PR 3's findings); the wgmma
# kernels sum in another order, so it is held within LOSS_13_TOL
PREV_LOSS_FUSE_LN_8 = 8.25550
# (B, L, 3D, heads, causal): lengths on both sides of the kernels' 64-row
# tiles, checked against the plain versions but not timed
RAGGED_GEOMETRIES = [
    (3, 1, 3 * 768, 12, False),
    (3, 65, 3 * 768, 12, True),
    (2, 130, 3 * 512, 8, False),
    (2, 63, 3 * 1024, 8, True),
]
# (label, B, L, D): the training step's LayerNorm inputs at a per-card
# batch of 64; K5 and K6 take the same rows flattened (R = B * L)
LN_GEOMETRIES = [
    ("vision globals", 128, 197, 768),
    ("vision 96px locals", 384, 37, 768),
    ("text head views", 128, 77, 512),
    ("text short bucket", 288, 32, 512),
    ("text long quarter", 96, 77, 512),
]
LN_MAIN = ("vision globals", torch.bfloat16)
# K3-K6 in bfloat16 before their Hopper redesigns, ms per call at each
# geometry (PR 3's kernel table, `git show ac95ce3:PERF.md`: K3/K4 as first
# ported, K5/K6 the mma.sync kernels, NVIDIA H100 80GB HBM3 at 700 W);
# printed beside this run's times, not checked
PREV_LN_BF16_MS = {
    ("K3", "vision globals"): 0.0604, ("K4", "vision globals"): 0.1440,
    ("K3", "vision 96px locals"): 0.0624, ("K4", "vision 96px locals"): 0.0864,
    ("K3", "text head views"): 0.0630, ("K4", "text head views"): 0.0851,
    ("K3", "text short bucket"): 0.0647, ("K4", "text short bucket"): 0.0644,
    ("K3", "text long quarter"): 0.0523, ("K4", "text long quarter"): 0.0773,
    ("K5", "vision globals"): 1.3405, ("K6", "vision globals"): 5.7767,
    ("K5", "vision 96px locals"): 0.7677, ("K6", "vision 96px locals"): 4.6423,
    ("K5", "text head views"): 0.2381, ("K6", "text head views"): 1.3606,
    ("K5", "text short bucket"): 0.2352, ("K6", "text short bucket"): 1.3419,
    ("K5", "text long quarter"): 0.1915, ("K6", "text long quarter"): 0.9209,
}
# row counts on both sides of K5's 128-row and K6's 64-row tiles, and one
# that is not a multiple of either cluster's rows; checked, not timed
LN_RAGGED_ROWS = (1, 63, 65, 130, 7392)
# K3/K4 beyond the ported widths: ViT-L's 1024 (the widest ring path of
# K4), then K4's general path (1536) and both kernels' general paths
# (7168, K4's widest); (D, rows)
LN_WIDE = ((1024, (65, 7392)), (1536, (65, 7392)), (7168, (65, 1030)))
# K6's other activations, each at one geometry in bfloat16
MLP_EXTRA_ACTS = (("gelu", "vision 96px locals"),
                  ("quick_gelu", "text head views"))
# fused-LayerNorm kernels vs their plain versions on the same card.
# Tensors in the compute dtype (y, dx, the K5/K6 outputs): float32, the
# row sums in another order (measured ~5e-6 on |o| < 12); bfloat16, a last
# float32 bit can move one rounding: one bf16 ulp of |o| < 4 plus 1%
# relative, as for K1.  float32 statistics (mean, rstd): 1e-5.  dscale and
# dbias: float32 sums over up to 25216 rows in another order (measured
# 1.8e-4 on |v| ~ 600): 1e-2 + 1e-5 |v|.
LN_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1.6e-2, 1e-2)}
STATS_TOL = (1e-5, 1e-5)
PARAM_GRAD_TOL = (1e-2, 1e-5)
# the settings of the fused-LayerNorm paths (phases 10 and 11)
LN_SETTINGS = ("FUSED_LN", "HYBRID_LN", "fuse_ln")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def device_ms(fn, n: int = 20, warmup: int = 3):
    """(device time per call, how it was read): every kernel that ``n``
    calls launch, summed by torch.profiler, over ``n``; or, where three
    profiles come back without a single kernel (seen on the card), the
    CUDA-event time of ``events_device_ms``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
        if total > 0:
            return total / n / 1e3, "profiler"
    print("[device-ms] the profiler recorded no device time in three "
          "profiles: CUDA events behind a sleep kernel instead")
    return events_device_ms(fn, n), "events"


def events_device_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Device time per call from CUDA events around ``n`` calls, enqueued
    while a sleep kernel holds the stream, so that the calls run back to
    back and the events do not time the host's launches.  The sleep is
    lengthened until it outlasts the enqueueing."""
    for _ in range(warmup):
        fn()
    cycles = 10 ** 8
    for _ in range(4):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / n
        cycles *= 4
    check(False, "the calls took longer to enqueue than four sleeps")


def host_us(fn, n: int = 200, warmup: int = 3) -> float:
    """Host time per call: ``n`` calls enqueued back to back on the host
    clock, then one synchronize (outside the timing)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, ops: float, op_dtype):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the peak rate of their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[op_dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def attention_bound(b, l, d, causal, dtype):
    """(bound_ms, bound_by, bytes, ops) for one forward call: qkv read once
    and the output written once; QK^T and P.V over the key positions this
    call needs (the lower triangle with the diagonal when causal)."""
    nbytes = 4 * b * l * d * torch.tensor([], dtype=dtype).element_size()
    pairs = l * (l + 1) // 2 if causal else l * l
    ops = 4 * b * pairs * d
    return (*_bound(nbytes, ops, dtype), nbytes, ops)


def attention_bwd_bound(b, l, d, causal, dtype):
    """(bound_ms, bound_by, bytes, ops) for one backward call: qkv and dout
    read once and d(qkv) written once (7·B·L·D elements); 10·B·pairs·D
    operations (S recomputed, dV, dP, dQ, dK), pairs the lower triangle
    with the diagonal when causal (fused_attention.py:287-301)."""
    nbytes = 7 * b * l * d * torch.tensor([], dtype=dtype).element_size()
    pairs = l * (l + 1) // 2 if causal else l * l
    ops = 10 * b * pairs * d
    return (*_bound(nbytes, ops, dtype), nbytes, ops)


def ln_matmul_bound(r, d, o, dtype):
    """(bound_ms, bound_by, bytes, ops) for one K5 call: x, W and the
    output once in the compute dtype, g, b and the bias once in float32;
    2·R·D·O operations."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (r * d + o * d + r * o) * isz + (2 * d + o) * 4
    ops = 2 * r * d * o
    return (*_bound(nbytes, ops, dtype), nbytes, ops)


def mlp_block_bound(r, d, hd, dtype):
    """(bound_ms, bound_by, bytes, ops) for one K6 call: x, W1, W2 and the
    output once in the compute dtype, g, b, b1 and b2 once in float32;
    4·R·D·HD operations (the two products)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * r * d + 2 * d * hd) * isz + (3 * d + hd) * 4
    ops = 4 * r * d * hd
    return (*_bound(nbytes, ops, dtype), nbytes, ops)


def _within(got, want, tol):
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    return ok and bool(torch.isfinite(got).all()), diff.max().item()


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build(kernel_build, modules) -> float:
    """Every kernel of the port, one nvcc each, all started together."""
    t0 = time.perf_counter()
    kernel_build.build_all()
    for module in modules:
        module.build()            # binds the libraries just built
    seconds = time.perf_counter() - t0
    print(f"[build] K1-K6 ({', '.join(kernel_build.SOURCES)}) ready in "
          f"{seconds:.2f} s")
    for source in kernel_build.SOURCES:
        for line in kernel_build.build_logs.get(source, "").splitlines():
            if any(k in line.lower() for k in ("registers", "spill",
                                               "compiling", "warning")):
                print(f"[build]   {source}: {line.strip()}")
    return seconds


def kernel_row(fa, label, b, l, d3, heads, causal, dtype, gen) -> dict:
    """K1 against its plain version at one geometry, and its time beside
    the plain version's, F.scaled_dot_product_attention's (a yardstick
    only) and its bound."""
    x = torch.randn(b, l, d3, device="cuda", generator=gen).to(dtype)
    got = fa.fused_attention_qkv(x, heads, causal)
    want = fa.fused_attention_qkv_reference(x, heads, causal)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    atol, rtol = KERNEL_TOL[dtype]
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    err = diff.max().item()
    check(ok and torch.isfinite(got).all().item(),
          f"K1 vs plain at {label} {dtype}: max err {err}")
    d = d3 // 3
    q, k, v = (t.view(b, l, heads, d // heads).transpose(1, 2)
               for t in x.split(d, dim=-1))
    ms = time_ms(lambda: fa.fused_attention_qkv(x, heads, causal))
    plain_ms = time_ms(
        lambda: fa.fused_attention_qkv_reference(x, heads, causal), iters=5)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=causal))
    bound_ms, bound_by, nbytes, ops = attention_bound(b, l, d, causal, dtype)
    row = dict(label=label, shape=[b, l, d3], heads=heads, causal=causal,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               ms=ms, plain_ms=plain_ms, library_ms=library_ms,
               bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops,
               tflops=ops / ms / 1e9, x_bound=ms / bound_ms,
               x_library=ms / library_ms)
    print(f"[kernel] {label:28s} {row['dtype']:8s} [{b},{l},{d3}] "
          f"h={heads} causal={int(causal)} err={err:.3g} "
          f"K1={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms "
          f"bound={bound_ms:.4f} ms ({bound_by}) "
          f"x{row['x_bound']:.1f} bound x{row['x_library']:.2f} sdpa "
          f"{row['tflops']:.1f} TFLOP/s")
    return row


def phase_kernel(fa):
    """K1 against its plain version, and times, at every geometry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    return [kernel_row(fa, label, b, l, d3, heads, causal, dtype, gen)
            for label, b, l, d3, heads, causal in GEOMETRIES
            for dtype in (torch.float32, torch.bfloat16)]


def _held(what: str, got, want, tol) -> float:
    ok, err = _within(got, want, tol)
    check(ok, f"{what}: max err {err} (tolerance {tol})")
    return err


def _same_bits(what: str, first, again) -> None:
    """A second launch on the same inputs gave the same bits."""
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{what} repeated: results differ")


def _same_stats(what: str, mean, rstd, k5_stats) -> None:
    """K3's statistics are the bits of K5's first pass (bf16): one order of
    sums, shared through ln_tile.cuh."""
    check(torch.equal(mean.reshape(-1), k5_stats[:, 0])
          and torch.equal(rstd.reshape(-1), k5_stats[:, 1]),
          f"K3 statistics vs K5's at {what}: bits differ")


def phase_host_floor(K) -> dict:
    """Host us per call, early in the process (little state, few Python
    objects): the K3 and K4 wrappers and F.layer_norm at the text head
    views in bfloat16, and the parts of a wrapper's launch path: the two
    ways to fetch the current stream (the wrappers take the raw getter)
    and the allocation of K3's statistics."""
    index = torch.cuda.current_device()
    gen = torch.Generator(device="cuda").manual_seed(32)
    _, b, l, d = LN_GEOMETRIES[2]
    x = torch.randn(b, l, d, device="cuda", generator=gen).bfloat16()
    g = torch.randn(b, l, d, device="cuda", generator=gen).bfloat16()
    s, sh = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    s_c, sh_c = s.bfloat16(), sh.bfloat16()
    _, mean, rstd = K.ln.layer_norm_fwd(x, s, sh)
    out = {"K3 wrapper": host_us(lambda: K.ln.layer_norm_fwd(x, s, sh),
                                 n=2000),
           "K4 wrapper": host_us(
               lambda: K.ln.layer_norm_bwd(x, s, mean, rstd, g), n=2000),
           "F.layer_norm": host_us(lambda: F.layer_norm(x, (d,), s_c, sh_c),
                                   n=2000),
           "torch.cuda.current_stream().cuda_stream": host_us(
               lambda: torch.cuda.current_stream().cuda_stream, n=2000),
           "torch._C._cuda_getCurrentRawStream": host_us(
               lambda: torch._C._cuda_getCurrentRawStream(index), n=2000),
           "torch.empty of K3's statistics": host_us(
               lambda: torch.empty((2, b, l, 1), dtype=torch.float32,
                                   device="cuda"), n=2000)}
    print(f"[host-floor] [{b},{l},{d}] bfloat16, host us per call: "
          + "; ".join(f"{k} {v:.2f}" for k, v in out.items()))
    return out


def phase_ln_kernels(K):
    """K3-K6 against their plain versions at the training step's
    LayerNorm geometries, float32 and bfloat16, and timed beside their
    plain versions, the stock composition (yardstick only) and bounds."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(30)
    f32 = torch.float32
    rows = []

    def rand(*shape, scale=1.0, shift=0.0, dtype=f32):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale
                + shift).to(dtype)

    def add(kernel, label, dtype, shape, errs, fn, plain, library, nbytes,
            ops, op_dtype, iters=20, **extra):
        ms = time_ms(fn, iters=iters)
        plain_ms = time_ms(plain, iters=max(iters // 4, 3))
        library_ms = time_ms(library, iters=iters)
        bound_ms, bound_by = _bound(nbytes, ops, op_dtype)
        prev_ms = (PREV_LN_BF16_MS.get((kernel, label))
                   if dtype == torch.bfloat16 and extra.get("act") in (
                       None, "gelu_tanh") else None)
        row = dict(kernel=kernel, label=label, shape=list(shape),
                   dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=max(errs.values()), errs=errs, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                   ops=ops, x_bound=ms / bound_ms,
                   x_library=ms / library_ms, prev_ms=prev_ms, **extra)
        split = ""
        if kernel in ("K3", "K4"):
            # device time apart from the host's: the wall time of
            # back-to-back calls is the larger of the two
            dev, dev_by = device_ms(fn)
            lib_dev, lib_dev_by = device_ms(library)
            row.update(device_ms=dev, device_ms_by=dev_by,
                       device_events_ms=events_device_ms(fn),
                       host_us=host_us(fn), library_device_ms=lib_dev,
                       library_device_ms_by=lib_dev_by,
                       library_host_us=host_us(library))
            row.update(x_bound_device=row["device_ms"] / bound_ms,
                       x_library_device=(row["device_ms"]
                                         / row["library_device_ms"]))
            split = (f" | device {row['device_ms']:.4f} ms ({dev_by}; "
                     f"events {row['device_events_ms']:.4f} ms) "
                     f"(x{row['x_bound_device']:.2f} bound, "
                     f"x{row['x_library_device']:.2f} stock device "
                     f"{row['library_device_ms']:.4f} ms) host "
                     f"{row['host_us']:.1f} us (stock "
                     f"{row['library_host_us']:.1f} us)")
        rows.append(row)
        print(f"[ln-kernels] {kernel} {label:18s} {row['dtype']:8s} "
              f"{list(shape)} {extra.get('act', '')} err "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
              + f" | {kernel}={ms:.4f} ms wall plain={plain_ms:.4f} ms "
              f"stock={library_ms:.4f} ms bound={bound_ms:.4f} ms "
              f"({bound_by}, x{row['x_bound']:.1f}, "
              f"x{row['x_library']:.2f} stock)" + split
              + (f" before the redesign {prev_ms:.4f} ms "
                 f"(x{ms / prev_ms:.3f})" if prev_ms else ""))

    for label, b, l, d in LN_GEOMETRIES:
        r, o, hd = b * l, 3 * d, 4 * d
        for dtype in (f32, torch.bfloat16):
            isz = torch.tensor([], dtype=dtype).element_size()
            tol = LN_TOL[dtype]
            x = rand(b, l, d, scale=2.0, shift=0.5, dtype=dtype)
            s, sh = rand(d, shift=1.0), rand(d)
            s_c, sh_c = s.to(dtype), sh.to(dtype)

            # K3: forward, with the float32 statistics
            y, mean, rstd = K.ln.layer_norm_fwd(x, s, sh)
            yr, mr, rr = K.ln.layer_norm_fwd_reference(x, s, sh)
            torch.cuda.synchronize()
            errs = {"y": _held(f"K3 y {label} {dtype}", y, yr, tol),
                    "mean": _held(f"K3 mean {label} {dtype}", mean, mr,
                                  STATS_TOL),
                    "rstd": _held(f"K3 rstd {label} {dtype}", rstd, rr,
                                  STATS_TOL)}
            _same_bits(f"K3 at {label} {dtype}", (y, mean, rstd),
                       K.ln.layer_norm_fwd(x, s, sh))
            add("K3", label, dtype, x.shape, errs,
                lambda: K.ln.layer_norm_fwd(x, s, sh),
                lambda: K.ln.layer_norm_fwd_reference(x, s, sh),
                lambda: F.layer_norm(x, (d,), s_c, sh_c),
                2 * r * d * isz + 2 * d * 4 + 2 * r * 4, 7 * r * d, f32)

            # K4: backward from the saved statistics
            g = rand(b, l, d, dtype=dtype)
            dx, ds, db = K.ln.layer_norm_bwd(x, s, mr, rr, g)
            dxr, dsr, dbr = K.ln.layer_norm_bwd_reference(x, s, mr, rr, g)
            torch.cuda.synchronize()
            errs = {"dx": _held(f"K4 dx {label} {dtype}", dx, dxr, tol),
                    "dscale": _held(f"K4 dscale {label} {dtype}", ds, dsr,
                                    PARAM_GRAD_TOL),
                    "dbias": _held(f"K4 dbias {label} {dtype}", db, dbr,
                                   PARAM_GRAD_TOL)}
            # K4's column sums have one fixed order: the same bits again
            _same_bits(f"K4 at {label} {dtype}", (dx, ds, db),
                       K.ln.layer_norm_bwd(x, s, mr, rr, g))
            xl = x.detach().requires_grad_(True)
            wl = s_c.detach().requires_grad_(True)
            bl = sh_c.detach().requires_grad_(True)
            yl = F.layer_norm(xl, (d,), wl, bl)
            add("K4", label, dtype, x.shape, errs,
                lambda: K.ln.layer_norm_bwd(x, s, mr, rr, g),
                lambda: K.ln.layer_norm_bwd_reference(x, s, mr, rr, g),
                lambda: torch.autograd.grad(yl, (xl, wl, bl), g,
                                            retain_graph=True),
                3 * r * d * isz + 2 * r * 4 + 3 * d * 4, 12 * r * d, f32)
            del y, yr, dx, dxr, xl, wl, bl, yl, g

            # K5: LayerNorm -> packed QKV projection
            x2 = x.view(r, d)
            w = rand(o, d, scale=d ** -0.5, dtype=dtype)
            bias = rand(o).to(dtype).float()
            out, k5_stats = K.lm.ln_matmul_fwd(x2, s, sh, w, bias,
                                               return_stats=True)
            want = K.lm.ln_matmul_reference(x2, s, sh, w, bias)
            torch.cuda.synchronize()
            errs = {"out": _held(f"K5 {label} {dtype}", out, want, tol)}
            if dtype == torch.bfloat16:
                _same_stats(f"{label} {dtype}", mean, rstd, k5_stats)
            # no atomics and a fixed order of sums: the same bits every time
            check(torch.equal(out, K.lm.ln_matmul_fwd(x2, s, sh, w, bias)),
                  f"K5 repeated at {label} {dtype}: results differ")
            bias_c = bias.to(dtype)
            _, _, nbytes, ops = ln_matmul_bound(r, d, o, dtype)
            add("K5", label, dtype, (r, d, o), errs,
                lambda: K.lm.ln_matmul_fwd(x2, s, sh, w, bias),
                lambda: K.lm.ln_matmul_reference(x2, s, sh, w, bias),
                lambda: F.linear(F.layer_norm(x2, (d,), s_c, sh_c), w,
                                 bias_c),
                nbytes, ops, dtype, iters=5 if dtype == f32 else 20)
            del out, want, w, k5_stats, mean, rstd

            # K6: LayerNorm -> c_fc -> act -> c_proj
            w1 = rand(hd, d, scale=d ** -0.5, dtype=dtype)
            w2 = rand(d, hd, scale=hd ** -0.5, dtype=dtype)
            b1, b2 = rand(hd, scale=0.1), rand(d, scale=0.1)
            b1_c, b2_c = b1.to(dtype), b2.to(dtype)
            acts = ["gelu_tanh"] + [a for a, geo in MLP_EXTRA_ACTS
                                    if geo == label and dtype != f32]
            for act in acts:
                out = K.mb.mlp_block_fwd(x2, s, sh, w1, b1, w2, b2, 1e-5, act)
                want = K.mb.mlp_block_reference(x2, s, sh, w1, b1, w2, b2,
                                                1e-5, act)
                torch.cuda.synchronize()
                errs = {"out": _held(f"K6 {act} {label} {dtype}", out, want,
                                     tol)}
                check(torch.equal(out, K.mb.mlp_block_fwd(
                    x2, s, sh, w1, b1, w2, b2, 1e-5, act)),
                    f"K6 {act} repeated at {label} {dtype}: results differ")
                stock_act = {
                    "gelu": F.gelu,
                    "gelu_tanh": lambda h: F.gelu(h, approximate="tanh"),
                    "quick_gelu": lambda h: h * torch.sigmoid(1.702 * h)}[act]
                _, _, nbytes, ops = mlp_block_bound(r, d, hd, dtype)
                add("K6", label, dtype, (r, d, hd), errs,
                    lambda: K.mb.mlp_block_fwd(x2, s, sh, w1, b1, w2, b2,
                                               1e-5, act),
                    lambda: K.mb.mlp_block_reference(x2, s, sh, w1, b1, w2,
                                                     b2, 1e-5, act),
                    lambda: F.linear(stock_act(F.linear(
                        F.layer_norm(x2, (d,), s_c, sh_c), w1, b1_c)), w2,
                        b2_c),
                    nbytes, ops, dtype, iters=3 if dtype == f32 else 10,
                    act=act)
                del out, want
            del x, x2, w1, w2
    torch.cuda.empty_cache()
    return rows


def _ln_rows_held(K, what, x, s, sh, g, tol, k5_stats=None) -> dict:
    """K3 and K4 on rows ``x`` [R, D] against their plain versions, the
    same bits on a repeat, and (given K5's bf16 statistics of the same
    rows) K3's statistics equal to K5's."""
    y, mean, rstd = K.ln.layer_norm_fwd(x, s, sh)
    _same_bits(f"K3 at {what}", (y, mean, rstd),
               K.ln.layer_norm_fwd(x, s, sh))
    yr, mr, rr = K.ln.layer_norm_fwd_reference(x, s, sh)
    err = {"K3": max(_held(f"K3 y at {what}", y, yr, tol),
                     _held(f"K3 mean at {what}", mean, mr, STATS_TOL),
                     _held(f"K3 rstd at {what}", rstd, rr, STATS_TOL))}
    if k5_stats is not None:
        _same_stats(what, mean, rstd, k5_stats)
    got = K.ln.layer_norm_bwd(x, s, mr, rr, g)
    _same_bits(f"K4 at {what}", got, K.ln.layer_norm_bwd(x, s, mr, rr, g))
    want = K.ln.layer_norm_bwd_reference(x, s, mr, rr, g)
    err["K4"] = max(_held(f"K4 dx at {what}", got[0], want[0], tol),
                    _held(f"K4 dscale at {what}", got[1], want[1],
                          PARAM_GRAD_TOL),
                    _held(f"K4 dbias at {what}", got[2], want[2],
                          PARAM_GRAD_TOL))
    return err


def phase_ln_ragged(K):
    """K3-K6 against their plain versions at row counts that end inside,
    on or one past their row tiles, at both widths and in both dtypes, with
    the same bits on a repeat (and K3's bf16 statistics equal to K5's);
    then K3 and K4 at the wider widths of LN_WIDE."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = {}

    def rand(*shape, scale=1.0, shift=0.0, dt=torch.float32):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale + shift).to(dt)

    for d in (768, 512):
        for r in LN_RAGGED_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                tol = LN_TOL[dtype]
                what = f"R={r} D={d} {str(dtype).replace('torch.', '')}"
                x = rand(r, d, scale=2.0, shift=0.5, dt=dtype)
                s, sh = rand(d, shift=1.0), rand(d)
                w = rand(3 * d, d, scale=d ** -0.5, dt=dtype)
                bias = rand(3 * d).to(dtype).float()
                got, k5_stats = K.lm.ln_matmul_fwd(x, s, sh, w, bias,
                                                   return_stats=True)
                check(torch.equal(got, K.lm.ln_matmul_fwd(x, s, sh, w, bias)),
                      f"K5 repeated at {what}: results differ")
                k5 = _held(f"K5 vs plain at {what}", got,
                           K.lm.ln_matmul_reference(x, s, sh, w, bias), tol)
                w1 = rand(4 * d, d, scale=d ** -0.5, dt=dtype)
                w2 = rand(d, 4 * d, scale=(4 * d) ** -0.5, dt=dtype)
                b1, b2 = rand(4 * d, scale=0.1), rand(d, scale=0.1)
                args = (x, s, sh, w1, b1, w2, b2, 1e-5, "gelu_tanh")
                got = K.mb.mlp_block_fwd(*args)
                check(torch.equal(got, K.mb.mlp_block_fwd(*args)),
                      f"K6 repeated at {what}: results differ")
                k6 = _held(f"K6 vs plain at {what}", got,
                           K.mb.mlp_block_reference(*args), tol)
                errs[what] = {"K5": k5, "K6": k6, **_ln_rows_held(
                    K, what, x, s, sh, rand(r, d, dt=dtype), tol,
                    k5_stats if dtype == torch.bfloat16 else None)}
    for d, rows in LN_WIDE:
        for r in rows:
            for dtype in (torch.float32, torch.bfloat16):
                what = f"R={r} D={d} {str(dtype).replace('torch.', '')}"
                x = rand(r, d, scale=2.0, shift=0.5, dt=dtype)
                errs[what] = _ln_rows_held(
                    K, what, x, rand(d, shift=1.0), rand(d),
                    rand(r, d, dt=dtype), LN_TOL[dtype])
    print("[ln-ragged] max abs err " + " ".join(
        f"{k}: " + "/".join(f"{n} {v:.3g}" for n, v in e.items())
        for k, e in errs.items()))
    return errs


def _captions(n: int, length: int, seed: int) -> np.ndarray:
    """SOT, random ids, EOT at a position spread over 8..40, zero padding."""
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, length), np.int64)
    eot = rng.integers(8, 41, n)
    toks[:, 0] = 49406
    for i, e in enumerate(eot):
        toks[i, 1:e] = rng.integers(1, 49000, e - 1)
        toks[i, e] = 49407
    return toks


def phase_serving(fa, rows):
    """Full-width ViT-B-16 COSMOS zero-shot retrieval in bfloat16; ``rows``
    are the kernel phase's measurements."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training.evaluate import make_encoders
    from cosmos_tpu_torch.training.retrieval import evaluate_retrieval
    from cosmos_tpu_torch.training.zero_shot import (
        supports_eot_truncation, truncate_to_eot)

    n_img, per_img, batch = 512, 5, 256
    model = create_model("ViT-B-16", "bf16", device="cuda", seed=0, **COSMOS)
    check(supports_eot_truncation(model), "EOT truncation gate")
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(n_img, 224, 224, 3, device="cuda", generator=gen)
    captions = _captions(n_img * per_img, 77, seed=2)
    data = SimpleNamespace(
        captions=captions, caption_ids=np.arange(n_img * per_img),
        img2txt={i: list(range(per_img * i, per_img * (i + 1)))
                 for i in range(n_img)},
        txt2img={c: [c // per_img] for c in range(n_img * per_img)})
    loader = [(images[s:s + batch], np.arange(s, s + batch))
              for s in range(0, n_img, batch)]
    enc_img, enc_txt, _ = make_encoders(model)
    enc_img(images[:batch])                       # warm-up: cuBLAS, allocator
    enc_txt(truncate_to_eot(captions[:batch]))
    torch.cuda.synchronize()

    fa.launches = 0
    t0 = time.perf_counter()
    metrics = evaluate_retrieval(enc_img, enc_txt, data, loader,
                                 batch_size=batch, eot_truncate=True)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    launches = fa.launches
    n_calls = len(loader) + -(-len(captions) // batch)
    print(f"[serve] evaluate_retrieval over {n_img} images / "
          f"{len(captions)} captions: {eval_s:.3f} s, K1 launches "
          f"{launches} (expected {12 * n_calls}: 12 per tower call)")
    check(launches == 12 * n_calls, "K1 launches per tower call")
    for k in ("text_to_image_R@1", "text_to_image_R@5", "text_to_image_R@10",
              "image_to_text_R@1", "image_to_text_R@5", "image_to_text_R@10"):
        check(0.0 <= metrics[k] <= 1.0, f"{k} = {metrics[k]}")
    print("[serve] " + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))

    txt_batches = [torch.as_tensor(truncate_to_eot(captions[s:s + batch]),
                                   device="cuda")
                   for s in range(0, len(captions), batch)]
    text_len = sorted({t.shape[1] for t in txt_batches})
    img_ms = time_ms(lambda: enc_img(images[:batch]), iters=5)
    txt_ms = time_ms(lambda: [enc_txt(t) for t in txt_batches], iters=3)
    feats = enc_img(images[:batch])
    check(feats.shape == (batch, 512) and torch.isfinite(feats).all().item(),
          "image features finite")
    # share of each tower call spent in K1: its 12 launches at the time the
    # kernel phase measured for the same geometry, over the call's time
    check(text_len == [48], f"serving text lengths {text_len}")
    k1_ms = {r["label"]: r["ms"] for r in rows if r["dtype"] == "bfloat16"}
    k1_share = {
        "image": 12 * k1_ms[SERVING_GEOMETRIES["image"]] / img_ms,
        "text": (12 * k1_ms[SERVING_GEOMETRIES["text"]] * len(txt_batches)
                 / txt_ms)}
    out = dict(metrics=metrics, eval_s=eval_s, launches=launches,
               tower_calls=n_calls, images_per_s=batch / img_ms * 1e3,
               captions_per_s=len(captions) / txt_ms * 1e3,
               image_call_ms=img_ms, text_call_ms=txt_ms / len(txt_batches),
               text_lengths=text_len, k1_share=k1_share,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[serve] encode_image {out['images_per_s']:.1f} images/s "
          f"(batch {batch}, bf16); encode_text "
          f"{out['captions_per_s']:.1f} captions/s (truncated lengths "
          f"{text_len}); peak memory {out['peak_mem_gb']:.2f} GB")
    print(f"[serve] per call: encode_image {img_ms:.3f} ms, encode_text "
          f"{out['text_call_ms']:.3f} ms; K1 share image "
          f"{k1_share['image']:.3f} text {k1_share['text']:.3f}")
    del model, images
    torch.cuda.empty_cache()
    return out


def phase_card_vs_cpu(fa):
    """The same float32 weights on the card (K1) and on the CPU (plain)."""
    from cosmos_tpu_torch import create_model

    b = 4
    cpu_model = create_model("ViT-B-16", "fp32", device="cpu", seed=3,
                             **COSMOS)
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    rng = np.random.default_rng(4)
    inputs = dict(
        global_images=torch.from_numpy(
            rng.standard_normal((2 * b, 224, 224, 3)).astype(np.float32)),
        texts=torch.from_numpy(_captions(2 * b, 77, seed=5)),
        local_images=torch.from_numpy(
            rng.standard_normal((6 * b, 96, 96, 3)).astype(np.float32)))

    def run(model, device):
        x = {k: v.to(device) for k, v in inputs.items()}
        with torch.inference_mode():
            img = model.encode_image(x["global_images"][:b], True)
            txt = model.encode_text(x["texts"][:b], True)
            fwd = model(**x, batch_size=b)
        return {"image_features": img["image_features"],
                "image_tokens": img["image_tokens"],
                "text_features": txt["text_features"],
                **{f"cosmos.{k}": v for k, v in fwd.items()}}

    want = run(cpu_model, "cpu")
    fa.launches = 0
    got = run(gpu_model, "cuda")
    torch.cuda.synchronize()
    # encode_image + encode_text + (globals, locals, captions) forward
    check(fa.launches == 12 * 5, f"K1 launches on the card run: {fa.launches}")
    errs = {}
    for k, w in want.items():
        g = got[k].cpu()
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"{k} shape/finite")
        errs[k] = (g - w).abs().max().item()
        # float32 on both sides, TF32 off: summation order across 12 layers
        check(torch.allclose(g, w, atol=1e-4, rtol=1e-3),
              f"card vs CPU {k}: max err {errs[k]}")
    print("[card-vs-cpu] max abs err " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    return errs


def kernel_bwd_row(fa, label, b, l, d3, heads, causal, dtype, gen) -> dict:
    """K2 against its plain version at one geometry, the same bits on a
    repeat, and its time beside the plain version's, K1's, the backward of
    F.scaled_dot_product_attention (a yardstick only) and its bound."""
    d = d3 // 3
    x = torch.randn(b, l, d3, device="cuda", generator=gen).to(dtype)
    g = torch.randn(b, l, d, device="cuda", generator=gen).to(dtype)
    got = fa.fused_attention_qkv_backward(x, g, heads, causal)
    again = fa.fused_attention_qkv_backward(x, g, heads, causal)
    want = fa.fused_attention_qkv_backward_reference(x, g, heads, causal)
    torch.cuda.synchronize()
    ok, err = _within(got, want, KERNEL_BWD_TOL[dtype])
    check(ok, f"K2 vs plain at {label} {dtype}: max err {err}")
    # no atomics and a fixed order of sums: the same bits every time
    check(torch.equal(got, again),
          f"K2 repeated at {label} {dtype}: results differ")
    del again
    ms = time_ms(lambda: fa.fused_attention_qkv_backward(x, g, heads, causal))
    plain_ms = time_ms(lambda: fa.fused_attention_qkv_backward_reference(
        x, g, heads, causal), iters=5)
    fwd_ms = time_ms(lambda: fa.fused_attention_qkv(x, heads, causal))
    q, k, v = (t.view(b, l, heads, d // heads).transpose(1, 2)
               .detach().requires_grad_(True)
               for t in x.split(d, dim=-1))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    g_heads = g.view(b, l, heads, d // heads).transpose(1, 2)
    library_ms = time_ms(lambda: torch.autograd.grad(
        o, (q, k, v), g_heads, retain_graph=True))
    bound_ms, bound_by, nbytes, ops = attention_bwd_bound(
        b, l, d, causal, dtype)
    row = dict(label=label, shape=[b, l, d3], heads=heads,
               causal=causal, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=err, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=bound_ms,
               bound_by=bound_by, bytes=nbytes, ops=ops,
               tflops=ops / ms / 1e9,
               x_bound=ms / bound_ms, x_library=ms / library_ms,
               k1_ms=fwd_ms)
    print(f"[kernel-bwd] {label:20s} {row['dtype']:8s} [{b},{l},{d3}] "
          f"h={heads} causal={int(causal)} err={err:.3g} "
          f"K2={ms:.4f} ms "
          f"plain={plain_ms:.4f} ms sdpa-bwd={library_ms:.4f} ms "
          f"bound={bound_ms:.4f} ms ({bound_by}) "
          f"x{row['x_bound']:.1f} bound x{row['x_library']:.2f} sdpa "
          f"{row['tflops']:.1f} TFLOP/s K1={fwd_ms:.4f} ms")
    return row


def phase_kernel_bwd(fa):
    """K2 against its plain version and timed, K1 timed, at the training
    geometries; the autograd Function on the card against the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = [kernel_bwd_row(fa, label, b, l, d3, heads, causal, dtype, gen)
            for label, b, l, d3, heads, causal in TRAIN_GEOMETRIES
            for dtype in (torch.float32, torch.bfloat16)]

    # the autograd Function: K1 then K2 on the card, the plain versions on
    # the CPU, same float32 input and output gradient
    errs = {}
    for label, b, l, d3, heads, causal in (TRAIN_GEOMETRIES[0],
                                           TRAIN_GEOMETRIES[3]):
        rng = np.random.default_rng(11)
        x = torch.from_numpy(rng.standard_normal((4, l, d3)).astype(np.float32))
        w = torch.from_numpy(
            rng.standard_normal((4, l, d3 // 3)).astype(np.float32))
        grads = {}
        before = (fa.launches, fa.launches_bwd)
        for dev in ("cpu", "cuda"):
            xd = x.to(dev).detach().requires_grad_(True)
            out = fa.fused_attention_qkv(xd, heads, causal)
            check(out.grad_fn is not None, f"no grad_fn on {dev}")
            (out * w.to(dev)).sum().backward()
            grads[dev] = xd.grad.cpu()
        check((fa.launches, fa.launches_bwd) == (before[0] + 1, before[1] + 1),
              "the Function launched K1 and K2 once each on the card")
        ok, err = _within(grads["cuda"], grads["cpu"], (1e-4, 1e-4))
        check(ok, f"autograd Function card vs CPU at {label}: max err {err}")
        errs[label] = err
    print("[kernel-bwd] autograd Function card vs CPU max abs err " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    return rows, errs


def phase_ragged(fa):
    """K1 and K2 against their plain versions at lengths that end inside,
    on, or one past a 64-row tile, and K2's repeat to the bit."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    errs = {}
    for b, l, d3, heads, causal in RAGGED_GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, l, d3, device="cuda", generator=gen).to(dtype)
            g = torch.randn(b, l, d3 // 3, device="cuda", generator=gen).to(dtype)
            what = f"[{b},{l},{d3}] causal={int(causal)} {dtype}"
            k1 = _held(f"K1 vs plain at {what}",
                       fa.fused_attention_qkv(x, heads, causal),
                       fa.fused_attention_qkv_reference(x, heads, causal),
                       KERNEL_TOL[dtype])
            got = fa.fused_attention_qkv_backward(x, g, heads, causal)
            check(torch.equal(got, fa.fused_attention_qkv_backward(
                x, g, heads, causal)), f"K2 repeated at {what}: results differ")
            k2 = _held(f"K2 vs plain at {what}", got,
                       fa.fused_attention_qkv_backward_reference(
                           x, g, heads, causal), KERNEL_BWD_TOL[dtype])
            errs[what] = {"K1": k1, "K2": k2}
    print("[ragged] K1/K2 max abs err " + " ".join(
        f"{k}: {v['K1']:.3g}/{v['K2']:.3g}" for k, v in errs.items()))
    return errs


def _train_texts(rng, size):
    """Synthetic captions with the textcrop length profile of
    bench.py:237-257: views 0-1 are long (EOT at 58..76), views 2+ single
    sentences (EOT at 8..24); ids below the EOT id."""
    k_, b_, length = size
    eots = np.where((np.arange(k_) < 2)[:, None],
                    rng.integers(58, length, size=(k_, b_)),
                    rng.integers(8, 25, size=(k_, b_)))
    body = rng.integers(1, 49406, size=size)
    pos = np.arange(length)
    toks = np.where(pos < eots[..., None], np.where(pos == 0, 49406, body), 0)
    np.put_along_axis(toks, eots[..., None], 49407, axis=-1)
    return toks.astype(np.int64)


def _train_batch(b, seed, device):
    rng = np.random.default_rng(seed)
    batch = {
        "global_images": rng.integers(0, 256, (2, b, 224, 224, 3), np.uint8),
        "local_images": rng.integers(0, 256, (6, b, 96, 96, 3), np.uint8),
        "texts": _train_texts(rng, (8, b, 77)),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _train_setup(model, lr, dtype):
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training.train import TrainStepConfig

    opt = create_optimizer(model, lr, beta1=0.9, beta2=0.98, eps=1e-8,
                           weight_decay=0.5)
    cfg = TrainStepConfig(cosmos=True, local_loss=True, momentum_teacher=0.999,
                          fix_momentum=True, lr_schedule=lr, input_dtype=dtype)
    return make_train_step(model, opt, cfg), create_train_state(model, opt)


# kernel-name fragments -> the layer that launched the kernel
KERNEL_CLASSES = (
    ("K1", ("fused_attention_fwd_kernel",)),
    ("K2", ("attention_bwd_rows_kernel", "attention_bwd_cols_kernel")),
    ("K3", ("layer_norm_fwd_",)),
    ("K4", ("layer_norm_bwd_",)),
    ("K5", ("ln_matmul_kernel",)),
    ("K6", ("mlp_block_kernel",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "cublas", "wgmma",
                "sm90_")),
    ("optimizer and EMA", ("multi_tensor_apply", "foreach")),
)


def _profile_steps(step, state, batch, n: int = 2):
    """Device time by kernel over ``n`` training steps (torch.profiler),
    and the device's busy share of the window: the kernels of one stream
    do not overlap, so their summed time is the busy time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3 / n
    kernels = {e.key: e.self_device_time_total / 1e3 / n
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0}
    classes = {name: 0.0 for name, _ in KERNEL_CLASSES}
    classes["other (elementwise, reductions, copies)"] = 0.0
    for key, ms in kernels.items():
        low = key.lower()
        name = next((c for c, frags in KERNEL_CLASSES
                     if any(f.lower() in low for f in frags)),
                    "other (elementwise, reductions, copies)")
        classes[name] += ms
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return dict(window_ms_per_step=window_ms, device_ms_per_step=busy,
                busy_share=busy / window_ms if kernels else None,
                by_class_ms=classes, top_kernels_ms=dict(top),
                n_kernel_names=len(kernels))


# the data-parallel phase (16): (a) the trainer at world 1 on NCCL under
# torchrun against the same trainer in this process; (b) the step at world 2
DP_RANK_FLAG = "--dp-rank"
DP_STEPS = 4            # steps an epoch in 16(a)
DP_WORLD = 2
DP_BATCH = 32           # rows a rank in 16(b)
DP_STEPS_B = 3
# 16(b)'s AdamW: eps 1e-3 keeps the first update a smooth function of the
# gradient, so the updated weights hold the gradients' agreement
DP_LR, DP_EPS = 1e-4, 1e-3
# 16(b) in float32, TF32 off: two ranks' halves against the whole batch are
# the same arithmetic in another summation order
DP_LOSS_RTOL = 1e-5
DP_GRAD_RTOL = 1e-4
DP_WEIGHT_ATOL = 1e-5


def _dp_trainer_argv(data, logs):
    """Phase 12's flags for 16(a): one loader thread (--workers 0), so that
    two runs read the same batches in the same order, DP_STEPS steps an
    epoch, the val eval only, one checkpoint kept."""
    argv = _drop_flags(_trainer_argv(data, logs, 0),
                       values=("--data-root-dir", "--steps-per-epoch"))
    return argv + ["--steps-per-epoch", str(DP_STEPS),
                   "--delete-previous-checkpoint"]


@contextlib.contextmanager
def _timed_means(record):
    """CUDA events around every call of the step's cross-rank mean
    (``distributed.all_reduce_mean_``): (start, end, bytes) in ``record``."""
    from cosmos_tpu_torch.parallel import distributed

    mean = distributed.all_reduce_mean_

    def timed(tensors):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mean(tensors)
        end.record()
        record.append((start, end,
                       sum(t.numel() * t.element_size() for t in tensors)))

    distributed.all_reduce_mean_ = timed
    try:
        yield
    finally:
        distributed.all_reduce_mean_ = mean


def _dp_trainer_runs(K, argv):
    """main([...]) for one epoch, then --resume latest into a second, with
    the K1/K2 launches of every step and eval, the logged step metrics,
    the step's ms (CUDA events) and the ms of the cross-rank mean in it."""
    from cosmos_tpu_torch.training import main as trainer

    record = {"steps": [], "evals": [], "profiles": {}}
    means = []
    zero_launches(K)
    with _instrumented_trainer(K, record, profiled=()), _timed_means(means):
        runs = [trainer.main(argv + ["--epochs", "1"]),
                trainer.main(argv + ["--epochs", "2", "--resume", "latest"])]
    torch.cuda.synchronize()
    stats = [s for r in runs for s in r["train_epoch_stats"]]
    timing = ("samples_per_s", "data_t")
    return dict(
        epochs=[s["epoch"] for s in stats],
        logged=[{k: v for k, v in line.items() if k not in timing}
                for s in stats for line in s["logged"]],
        steps=record["steps"], evals=record["evals"],
        step_ms=[s["step_ms"] for s in stats],
        mean_ms=[a.elapsed_time(b) for a, b, _ in means],
        mean_bytes=means[0][2] if means else 0)


def _kernel_modules():
    from cosmos_tpu_torch.ops import fused_attention as fa
    from cosmos_tpu_torch.ops.experimental import layer_norm as ln
    from cosmos_tpu_torch.ops.experimental import ln_matmul as lm
    from cosmos_tpu_torch.ops.experimental import mlp_block as mb

    return SimpleNamespace(fa=fa, ln=ln, lm=lm, mb=mb)


def dp_rank(out: str, argv) -> int:
    """16(a)'s rank, started by torchrun: _dp_trainer_runs under the world
    torchrun made, its record written to ``out`` as JSON."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = _dp_trainer_runs(_kernel_modules(), argv)
    Path(out).write_text(json.dumps(record))
    return 0


def _checkpoint_diffs(a: str, b: str) -> dict:
    """Tensor name -> max abs difference, for every tensor of the student,
    the teacher and the optimizer state that differs between two
    checkpoint files (empty when they hold the same bits)."""
    ca, cb = (torch.load(p, map_location="cpu", weights_only=True)
              for p in (a, b))
    diffs = {}
    for which in ("student", "teacher"):
        for k, v in ca[which].items():
            if not torch.equal(v, cb[which][k]):
                diffs[f"{which} {k}"] = (v - cb[which][k]).abs().max().item()
    for i, st in ca["optimizer"]["state"].items():
        for k, v in st.items():
            w = cb["optimizer"]["state"][i][k]
            if not torch.equal(v, w):
                diffs[f"optimizer {i} {k}"] = (v - w).abs().max().item()
    for key in ("epoch", "step", "num_updates"):
        if ca[key] != cb[key]:
            diffs[key] = abs(ca[key] - cb[key])
    return diffs


def _phase_dp_world1(K, data: str, tmp: str) -> dict:
    """16(a): the trainer at world 1 on NCCL (torchrun --standalone
    --nproc-per-node 1, this script's --dp-rank) against the same trainer
    in this process without a process group."""
    import shutil

    one_logs, rank_logs = f"{tmp}/dp_one", f"{tmp}/dp_world1"
    t0 = time.perf_counter()
    one = _dp_trainer_runs(K, _dp_trainer_argv(data, one_logs))
    one_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    out = f"{tmp}/dp_rank.json"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", str(ROOT / "chip_smoke.py"),
           DP_RANK_FLAG, out, *_dp_trainer_argv(data, rank_logs)]
    # torchrun sets OMP_NUM_THREADS=1 where it is unset; the rank gets this
    # process's thread count, so that the two runs differ by the world alone
    import os

    threads = torch.get_num_threads()
    env = dict(os.environ, OMP_NUM_THREADS=str(threads))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    rank_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun world 1 exited "
          f"{proc.returncode}:\n{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    rank = json.loads(Path(out).read_text())

    per_step = step_launches(None, 12, TRAINER_BATCH, bucketed=False)
    want = {k: (v if k in ("K1", "K2") else 0) for k, v in per_step.items()}
    steps = 2 * DP_STEPS
    for tag, rec in (("one process", one), ("world 1", rank)):
        check(rec["epochs"] == [0, 1], f"16(a) {tag}: epochs {rec['epochs']}")
        check(len(rec["steps"]) == steps and all(
            got == want for got in rec["steps"]),
            f"16(a) {tag}: launches {rec['steps']}, expected {want} a step")
        check(len(rec["evals"]) == 2 and all(
            e["K1"] > 0 and all(v == 0 for k, v in e.items() if k != "K1")
            for e in rec["evals"]), f"16(a) {tag}: evals {rec['evals']}")
        check(len(rec["logged"]) == steps and all(
            np.isfinite(line["loss"]) for line in rec["logged"]),
            f"16(a) {tag}: losses")
    same_metrics = rank["logged"] == one["logged"]
    ckpt = "trainer/checkpoints/epoch_2.pt"
    diffs = _checkpoint_diffs(f"{one_logs}/{ckpt}", f"{rank_logs}/{ckpt}")
    shutil.rmtree(one_logs)
    shutil.rmtree(rank_logs)
    check(same_metrics, "16(a): world 1's logged metrics differ from the "
          "one-process run's:\n" + "\n".join(
              f"{a} | {b}" for a, b in zip(one["logged"], rank["logged"])
              if a != b))
    check(not diffs, f"16(a): world 1's epoch_2.pt differs from the "
          f"one-process run's in {len(diffs)} tensors, e.g. "
          f"{dict(list(diffs.items())[:8])}")

    def steady(rec):
        return [ms for epoch in rec["step_ms"] for ms in epoch[1:]]

    mean_ms = rank["mean_ms"]
    res = dict(
        launches_per_step=want,
        launches={k: 2 * v * steps for k, v in want.items()},
        eval_k1=sum(e["K1"] for r in (one, rank) for e in r["evals"]),
        losses=[line["loss"] for line in rank["logged"]],
        same_bits=True,
        step_ms_one=steady(one), step_ms_world1=steady(rank),
        step_ms_one_mean=float(np.mean(steady(one))),
        step_ms_world1_mean=float(np.mean(steady(rank))),
        mean_ms=mean_ms, mean_ms_median=float(np.median(mean_ms)),
        mean_bytes=rank["mean_bytes"], threads=threads, one_s=one_s,
        torchrun_s=rank_s)
    print(f"[dp] (a) world 1 on NCCL under torchrun: the logged metrics of "
          f"{steps} steps and epoch_2.pt (student, teacher, optimizer) are "
          f"the one-process run's bits; ms a step (CUDA events, steps 2+ of "
          f"each epoch) world 1 {res['step_ms_world1_mean']:.3f}, one "
          f"process {res['step_ms_one_mean']:.3f}; the step's cross-rank "
          f"mean of {rank['mean_bytes'] / 1e9:.3f} GB median "
          f"{res['mean_ms_median']:.3f} ms (max {max(mean_ms):.3f}); "
          f"K1/K2 a step {want['K1']}/{want['K2']}; runs {one_s:.1f} s and "
          f"{rank_s:.1f} s (torchrun, OMP_NUM_THREADS={threads})")
    return res


def _dp_step_setup(model, siglip: bool):
    """16(b)'s step: the trainer's COSMOS (or SigLIP) step in float32 with
    DP_LR and DP_EPS."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import TrainStepConfig

    lr = const_lr(DP_LR, 0, 100)
    opt = create_optimizer(model, lr, beta1=0.9, beta2=0.98, eps=DP_EPS,
                           weight_decay=0.5)
    mode = (dict(cosmos=False, siglip=True) if siglip
            else dict(cosmos=True, local_loss=True))
    cfg = TrainStepConfig(momentum_teacher=0.999, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True, **mode)
    return make_train_step(model, opt, cfg), create_train_state(model, opt)


def _dp_model(siglip: bool, device):
    from cosmos_tpu_torch import create_model

    kw = (dict(act_approx=True, init_logit_scale=float(np.log(10.0)),
               init_logit_bias=-10.0) if siglip else TRAIN_RECIPE)
    return create_model("ViT-B-16", "fp32", device=device, seed=7, **kw)


def _dp_batch(rank=None):
    """16(b)'s batch of DP_WORLD * DP_BATCH rows on the CPU, or ``rank``'s
    contiguous block of it."""
    batch = _train_batch(DP_WORLD * DP_BATCH, seed=41, device="cpu")
    if rank is None:
        return batch
    return {k: v[:, rank * DP_BATCH:(rank + 1) * DP_BATCH]
            for k, v in batch.items()}


def _state_digest(state) -> str:
    import hashlib

    h = hashlib.sha256()
    for module in (state.student, state.teacher):
        for k, v in module.state_dict().items():
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _dp_step_rank(rank: int, spec: dict) -> None:
    """16(b)'s rank: DP_STEPS_B steps of each mode on its block of the
    batch under a world of DP_WORLD, the first held to the world-1
    reference; then, under gloo, a send/recv of a CUDA tensor."""
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                      LOCAL_RANK=str(rank if spec["backend"] == "nccl" else 0),
                      MASTER_ADDR="localhost", MASTER_PORT=str(spec["port"]))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from cosmos_tpu_torch.losses.contrastive import _exchange
    from cosmos_tpu_torch.parallel import distributed

    distributed.init_distributed(None, backend=spec["backend"])
    out = {"device": str(torch.device("cuda", torch.cuda.current_device()))}
    try:
        for mode in spec["modes"]:
            model = _dp_model(mode == "siglip", None)
            step, state = _dp_step_setup(model, mode == "siglip")
            batch = {k: v.cuda() for k, v in _dp_batch(rank).items()}
            means, events, metrics = [], [], []
            with _timed_means(means):
                for i in range(DP_STEPS_B):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    m = step(state, batch)
                    end.record()
                    events.append((start, end))
                    metrics.append({k: float(v) for k, v in m.items()})
                    if i == 0 and rank == 0:
                        first = dict(
                            grads={n: p.grad.detach().cpu()
                                   for n, p in model.named_parameters()},
                            student={k: v.cpu() for k, v in
                                     state.student.state_dict().items()},
                            teacher={k: v.cpu() for k, v in
                                     state.teacher.state_dict().items()})
            torch.cuda.synchronize()
            res = dict(metrics=metrics, digest=_state_digest(state),
                       step_ms=[a.elapsed_time(b) for a, b in events],
                       mean_ms=[a.elapsed_time(b) for a, b, _ in means],
                       mean_bytes=means[0][2])
            if rank == 0:
                ref = torch.load(spec["ref"][mode], map_location="cpu",
                                 weights_only=True)
                res["errs"] = dict(
                    loss=abs(metrics[0]["loss"] - ref["loss"]),
                    loss_ref=ref["loss"],
                    grads={n: ((g - ref["grads"][n]).abs().max().item(),
                               ref["grads"][n].abs().max().item())
                           for n, g in first["grads"].items()},
                    **{which: max((v - ref[which][k]).abs().max().item()
                                  for k, v in first[which].items())
                       for which in ("student", "teacher")})
            out[mode] = res
            del model, step, state, batch
            torch.cuda.empty_cache()
        if spec["backend"] == "gloo":
            # the ring's send/recv, on CUDA tensors, under gloo; last, as a
            # refusal leaves the process group unusable
            try:
                _exchange([torch.ones(4, device="cuda")],
                          [(rank + 1) % DP_WORLD], [(rank - 1) % DP_WORLD])
                out["p2p"] = "accepted"
            except RuntimeError as e:
                out["p2p"] = f"refused: {str(e).splitlines()[0][:200]}"
    finally:
        torch.save(out, f"{spec['out']}.{rank}")
        distributed.destroy()


def _dp_reference(mode: str, path: str) -> float:
    """The world-1 step of 16(b) on all DP_WORLD * DP_BATCH rows in this
    process: its loss, gradients and updated student and teacher, saved to
    ``path`` on the CPU.  Returns its ms (CUDA events)."""
    model = _dp_model(mode == "siglip", "cuda")
    step, state = _dp_step_setup(model, mode == "siglip")
    batch = {k: v.cuda() for k, v in _dp_batch().items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    m = step(state, batch)
    end.record()
    torch.save(dict(
        loss=float(m["loss"]),
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()},
        student={k: v.cpu() for k, v in state.student.state_dict().items()},
        teacher={k: v.cpu() for k, v in state.teacher.state_dict().items()}),
        path)
    ms = start.elapsed_time(end)
    del model, step, state, batch, m
    torch.cuda.empty_cache()
    return ms


def _phase_dp_world2(tmp: str) -> dict:
    """16(b): make_train_step at world DP_WORLD, one rank a card under NCCL
    where the machine has the cards, else both ranks on this card under
    gloo; COSMOS, then SigLIP's ring where the backend passes CUDA tensors
    point to point."""
    import socket

    import torch.multiprocessing as mp

    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= DP_WORLD else "gloo"
    modes = ["cosmos"] + (["siglip"] if backend == "nccl" else [])
    ref = {m: f"{tmp}/dp_ref_{m}.pt" for m in modes}
    ref_ms = {m: _dp_reference(m, ref[m]) for m in modes}
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    spec = dict(backend=backend, modes=modes, ref=ref, port=port,
                out=f"{tmp}/dp_world2")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_dp_step_rank, args=(spec,), nprocs=DP_WORLD,
                             join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + 300
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline, "16(b): the ranks outlasted "
                  "300 s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    wall_s = time.perf_counter() - t0
    ranks = [torch.load(f"{spec['out']}.{r}", weights_only=False)
             for r in range(DP_WORLD)]
    res = dict(backend=backend, cards=cards, devices=[r["device"]
                                                      for r in ranks],
               ref_ms=ref_ms, wall_s=wall_s, runs={})
    for mode in modes:
        r0, r1 = ranks[0][mode], ranks[1][mode]
        e = r0["errs"]
        check(r0["metrics"] == r1["metrics"],
              f"16(b) {mode}: the ranks' averaged metrics differ")
        check(r0["digest"] == r1["digest"], f"16(b) {mode}: the ranks hold "
              f"other bits after {DP_STEPS_B} steps")
        check(e["loss"] <= DP_LOSS_RTOL * abs(e["loss_ref"]),
              f"16(b) {mode}: loss {r0['metrics'][0]['loss']} at world "
              f"{DP_WORLD}, {e['loss_ref']} at world 1")
        worst = max(err / max(top, 1e-30) for err, top in e["grads"].values())
        bad = {n: v for n, v in e["grads"].items()
               if v[0] > DP_GRAD_RTOL * v[1] + 1e-12}
        check(not bad, f"16(b) {mode}: gradients off the world-1 step: "
              f"{dict(list(bad.items())[:6])}")
        for which in ("student", "teacher"):
            check(e[which] <= DP_WEIGHT_ATOL, f"16(b) {mode}: updated "
                  f"{which} max err {e[which]}")
        res["runs"][mode] = dict(
            loss=r0["metrics"][0]["loss"], loss_world1=e["loss_ref"],
            loss_err=e["loss"], grad_rel_err_max=worst,
            student_err=e["student"], teacher_err=e["teacher"],
            step_ms=[r0["step_ms"], r1["step_ms"]],
            mean_ms=[r0["mean_ms"], r1["mean_ms"]],
            mean_bytes=r0["mean_bytes"], same_bits_after=DP_STEPS_B)
        print(f"[dp] (b) {mode} at world {DP_WORLD} ({backend}, ranks on "
              f"{res['devices']}), {DP_BATCH} rows a rank against world 1 on "
              f"{DP_WORLD * DP_BATCH}: loss {r0['metrics'][0]['loss']:.7f} vs "
              f"{e['loss_ref']:.7f} (err {e['loss']:.3g}), gradients max "
              f"rel err {worst:.3g}, updated student {e['student']:.3g}, "
              f"teacher {e['teacher']:.3g}; the same bits on both ranks after "
              f"{DP_STEPS_B} steps; ms a step {r0['step_ms']}, the mean of "
              f"{r0['mean_bytes'] / 1e9:.3f} GB {r0['mean_ms']} ms "
              f"(world 1 step {ref_ms[mode]:.1f} ms)")
    if backend == "gloo":
        res["siglip"] = (f"world {DP_WORLD}: not run on the card (one card: "
                         f"NCCL takes one rank a card, and gloo's send/recv "
                         f"of a CUDA tensor was {ranks[0]['p2p']}); the CPU "
                         "tests carry the ring")
        print(f"[dp] (b) siglip {res['siglip']}")
    return res


def phase_data_parallel(K, data: str, tmp: str) -> dict:
    """Phase 16: (a) the trainer at world 1 on NCCL against one process;
    (b) the step at world DP_WORLD against world 1."""
    t_phase = time.perf_counter()
    world1 = _phase_dp_world1(K, data, tmp)
    world2 = _phase_dp_world2(tmp)
    out = dict(world1=world1, world2=world2,
               phase_s=time.perf_counter() - t_phase)
    print(f"[dp] phase {out['phase_s']:.1f} s")
    return out


def _counters(K):
    """(module, attribute) of each kernel's launch count."""
    return {"K1": (K.fa, "launches"), "K2": (K.fa, "launches_bwd"),
            "K3": (K.ln, "launches"), "K4": (K.ln, "launches_bwd"),
            "K5": (K.lm, "launches"), "K6": (K.mb, "launches")}


def zero_launches(K) -> None:
    for module, attr in _counters(K).values():
        setattr(module, attr, 0)


def read_launches(K) -> dict:
    return {k: getattr(m, a) for k, (m, a) in _counters(K).items()}


def step_launches(setting, layers: int, b: int, bucketed: bool = True
                  ) -> dict:
    """Launches of K1-K6 in one training step of the recipe at per-card
    batch ``b`` with ``layers`` blocks per tower, under ``setting`` (None:
    the default path; or one of LN_SETTINGS), derived from the step's
    tower calls: the student's globals, locals, caption head views and
    the text bucket's short three quarters and long quarter of the other
    6b views (one call of all 8b caption views when not ``bucketed``; all
    with a gradient), the teacher's globals and head views (without), and
    the student's two cross poolers (ln_q and ln_k each, batch b).  A
    LayerNorm takes K3/K4 only where ``supported`` holds: every width here
    is a multiple of 128, so where the batch is even."""
    n = 6 * b
    short = n * 3 // 4
    text = ([("text", 2 * b, True), ("text", short, True),
             ("text", n - short, True)] if bucketed
            else [("text", 8 * b, True)])
    calls = [("vision", 2 * b, True), ("vision", 6 * b, True), *text,
             ("vision", 2 * b, False), ("text", 2 * b, False)]
    fuse = setting == "fuse_ln"
    k3 = setting in ("FUSED_LN", "fuse_ln")
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    for tower, batch, grad in calls:
        out["K1"] += layers
        out["K2"] += layers * grad
        if fuse:
            out["K5"] += layers
            out["K6"] += layers
        # ln_pre and ln_post, or ln_final; the blocks' ln_1 and ln_2 unless
        # they are fused into K5 and K6
        lns = (2 if tower == "vision" else 1) + (0 if fuse else 2 * layers)
        if setting and batch % 2 == 0:
            out["K3"] += lns * k3
            out["K4"] += lns * grad
    if setting and b % 2 == 0:
        out["K3"] += 4 * k3
        out["K4"] += 4
    return out


def _train_steps(K, model, warmup: int, timed: int, expected: dict,
                 tag: str, profile_steps: int):
    """``warmup`` + ``timed`` steps of the recipe at batch 64 on one fixed
    synthetic batch; checks finite, falling losses, the clamps, every
    student gradient and ``expected`` launches of K1-K6 per step; then a
    profile of ``profile_steps`` steps."""
    from cosmos_tpu_torch.training.scheduler import cosine_lr
    from cosmos_tpu_torch.training.train import LN100

    b = 64
    step, state = _train_setup(model, cosine_lr(5e-4, 2000, 100000),
                               torch.bfloat16)
    batch = _train_batch(b, seed=20, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_launches(K)
    metrics = [step(state, batch) for _ in range(warmup)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    metrics += [step(state, batch) for _ in range(timed)]
    end.record()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_launches(K)
    n = warmup + timed
    step_ms = start.elapsed_time(end) / timed
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    losses = [m["loss"].item() for m in metrics]
    print(f"[{tag}] losses {' '.join(f'{x:.5f}' for x in losses)}")
    check(all(np.isfinite(losses)), f"finite losses {losses}")
    check(losses[-1] < losses[0], f"loss falls over {n} steps: {losses}")
    for name in ("logit_scale", "distill_logit_scale"):
        for module in (state.student, state.teacher):
            v = getattr(module, name).item()
            check(0.0 <= v <= LN100, f"{name} = {v} outside [0, ln 100]")
    want = {k: v * n for k, v in expected.items()}
    print(f"[{tag}] launches over {n} steps {launches} (expected {want}: "
          f"{expected} per step)")
    check(launches == want, f"{tag}: K1-K6 launches per training step")
    missing = [p for p, t in state.student.named_parameters() if t.grad is None]
    check(not missing, f"student parameters without a gradient: {missing}")
    profile = _profile_steps(step, state, batch, profile_steps)
    if profile["busy_share"] is None:
        print(f"[{tag}] profiler: no device time recorded (busy share not "
              "measured)")
    else:
        print(f"[{tag}] profiler, per step: window "
              f"{profile['window_ms_per_step']:.3f} ms, device busy "
              f"{profile['device_ms_per_step']:.3f} ms (share "
              f"{profile['busy_share']:.3f}); " + "; ".join(
                  f"{k} {v:.3f} ms" for k, v in profile["by_class_ms"].items()))
        for k, v in profile["top_kernels_ms"].items():
            print(f"[{tag}]   {v:8.3f} ms  {k[:110]}")
    out = dict(batch=b, steps=n, timed_steps=timed, step_ms=step_ms,
               samples_per_s=b / step_ms * 1e3, wall_s=wall_s,
               losses=losses, launches=launches, launches_per_step=expected,
               peak_mem_gb=peak_gb,
               logit_scale=state.student.logit_scale.item(),
               lr_last=metrics[-1]["lr"], profile=profile,
               busy_share_of_step=(profile["device_ms_per_step"] / step_ms
                                   if profile["busy_share"] is not None
                                   else None))
    print(f"[{tag}] ViT-B-16 COSMOS bf16 batch {b}: {step_ms:.3f} ms/step, "
          f"{out['samples_per_s']:.1f} samples/s, peak memory {peak_gb:.2f} GB")
    del state, step, batch
    return out


def phase_train(K, bwd_rows):
    """Full-width ViT-B-16 COSMOS training in bfloat16 at a per-card batch
    of 64, the default path; ``bwd_rows`` are the K2 phase's
    measurements."""
    from cosmos_tpu_torch import create_model

    model = create_model("ViT-B-16", "bf16", device="cuda", seed=0,
                         **TRAIN_RECIPE)
    out = _train_steps(K, model, 3, 10, step_launches(None, 12, 64),
                       "train", 2)
    last = out["losses"][-1]
    print(f"[train] 13th loss {last:.5f}; before the tensor-core K1/K2 "
          f"{PREV_LOSS_13:.5f} (difference {last - PREV_LOSS_13:.3g}, "
          f"tolerance {LOSS_13_TOL})")
    check(abs(last - PREV_LOSS_13) <= LOSS_13_TOL,
          f"13th loss {last} vs {PREV_LOSS_13}")
    out["k1_launches"] = out["launches"]["K1"]
    out["k2_launches"] = out["launches"]["K2"]
    by = {r["label"]: r for r in bwd_rows if r["dtype"] == "bfloat16"}
    k1_ms = sum(c * by[g]["k1_ms"] for calls in (STUDENT_CALLS, TEACHER_CALLS)
                for g, c in calls.items())
    k2_ms = sum(c * by[g]["ms"] for g, c in STUDENT_CALLS.items())
    step_ms = out["step_ms"]
    out.update(k1_ms_per_step=k1_ms, k2_ms_per_step=k2_ms,
               k1_share=k1_ms / step_ms, k2_share=k2_ms / step_ms)
    print(f"[train] per step: K1 {k1_ms:.3f} ms (share {out['k1_share']:.3f}), "
          f"K2 {k2_ms:.3f} ms (share {out['k2_share']:.3f}), from per-call "
          f"times x launches; profiled device time over the unprofiled "
          f"step: {out['busy_share_of_step']}")
    del model
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def ln_setting(setting):
    """Turn on the toggles of one fused-LayerNorm setting (None: none);
    yields whether the model is built with fuse_ln."""
    from cosmos_tpu_torch.models import layers

    layers.FUSED_LN = setting in ("FUSED_LN", "fuse_ln")
    layers.HYBRID_LN = setting == "HYBRID_LN"
    try:
        yield setting == "fuse_ln"
    finally:
        layers.FUSED_LN = layers.HYBRID_LN = False


def phase_train_ln(K, default):
    """Phase 7's training under each fused-LayerNorm setting, 3 + 5 steps;
    ``default`` is phase 7's result."""
    from cosmos_tpu_torch import create_model

    out = {}
    for setting in LN_SETTINGS:
        tag = f"train-{setting}"
        with ln_setting(setting) as fuse:
            model = create_model("ViT-B-16", "bf16", device="cuda", seed=0,
                                 fuse_ln=fuse, **TRAIN_RECIPE)
            run = _train_steps(K, model, 3, 5, step_launches(setting, 12, 64),
                               tag, 1)
        del model
        torch.cuda.empty_cache()
        run["step_vs_default"] = run["step_ms"] / default["step_ms"]
        if setting == "fuse_ln":
            last = run["losses"][-1]
            print(f"[{tag}] 8th loss {last:.5f}; before the K5/K6 redesign "
                  f"{PREV_LOSS_FUSE_LN_8:.5f} (difference "
                  f"{last - PREV_LOSS_FUSE_LN_8:.3g}, tolerance "
                  f"{LOSS_13_TOL})")
            check(abs(last - PREV_LOSS_FUSE_LN_8) <= LOSS_13_TOL,
                  f"fuse_ln 8th loss {last} vs {PREV_LOSS_FUSE_LN_8}")
        print(f"[{tag}] {run['step_ms']:.3f} ms/step, "
              f"{run['samples_per_s']:.1f} samples/s, peak "
              f"{run['peak_mem_gb']:.2f} GB; default path (phase 7) "
              f"{default['step_ms']:.3f} ms/step, "
              f"{default['samples_per_s']:.1f} samples/s, peak "
              f"{default['peak_mem_gb']:.2f} GB; ratio "
              f"{run['step_vs_default']:.3f}")
        out[setting] = run
    return out


def phase_train_card_vs_cpu(K, setting=None):
    """One training step of the recipe, 2 layers per tower, batch 2, float32,
    on the card (the kernels) and on the CPU (plain versions), same
    weights, under one fused-LayerNorm setting (None: the default path)."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training.scheduler import const_lr

    tag = "train-card-vs-cpu" + (f"-{setting}" if setting else "")
    expected = step_launches(setting, 2, 2)
    lr = 1e-4
    with ln_setting(setting) as fuse:
        cpu_model = create_model("ViT-B-16", "fp32", device="cpu", seed=7,
                                 vision_layers=2, text_layers=2, fuse_ln=fuse,
                                 **TRAIN_RECIPE)
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        init = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        batch = _train_batch(2, seed=21, device="cpu")
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            step, state = _train_setup(model, const_lr(lr, 0, 100),
                                       torch.float32)
            zero_launches(K)
            m = step(state, {k: v.to(dev) for k, v in batch.items()})
            if dev == "cuda":
                torch.cuda.synchronize()
                got = read_launches(K)
                check(got == expected, f"{tag}: launches {got}, expected "
                      f"{expected}")
            missing = [n for n, p in model.named_parameters()
                       if p.grad is None]
            check(not missing,
                  f"{dev}: parameters without a gradient {missing}")
            runs[dev] = dict(
                loss=m["loss"].item(),
                grads={n: p.grad.detach().cpu()
                       for n, p in model.named_parameters()},
                student={k: v.cpu()
                         for k, v in state.student.state_dict().items()},
                teacher={k: v.cpu()
                         for k, v in state.teacher.state_dict().items()})
    cpu, gpu = runs["cpu"], runs["cuda"]
    errs = {"loss": abs(gpu["loss"] - cpu["loss"])}
    check(errs["loss"] <= 1e-4 * abs(cpu["loss"]),
          f"loss card {gpu['loss']} vs CPU {cpu['loss']}")
    # float32 on both sides, TF32 off: summation order through 2 layers
    for name in ("visual.conv1.weight",
                 "visual.transformer.resblocks.0.attn.in_proj_weight",
                 "transformer.resblocks.0.attn.in_proj_weight", "logit_scale"):
        g, w = gpu["grads"][name], cpu["grads"][name]
        errs[f"grad {name}"] = (g - w).abs().max().item()
        check(errs[f"grad {name}"] <= 1e-3 * w.abs().max().item() + 1e-8,
              f"grad {name}: max err {errs[f'grad {name}']}")
    # the first AdamW step moves every parameter by about lr times the sign
    # of its gradient; a gradient that is zero in exact arithmetic (the key
    # bias of a self-attention) can take either sign, so the updated
    # parameters are held to 2 lr
    for which in ("student", "teacher"):
        err = max((gpu[which][k] - cpu[which][k]).abs().max().item()
                  for k in cpu[which])
        errs[which] = err
        check(err <= 2 * lr, f"updated {which} card vs CPU: max err {err}")
    moved = max((cpu["student"][k] - init[k]).abs().max().item() for k in init)
    check(moved > 0.5 * lr, "the step moved the student")
    print(f"[{tag}] max abs err " + " ".join(
        f"{k}={v:.3g}" for k, v in errs.items()))
    return errs


# the trainer phase (12): train_cc3m.sh's recipe through the port's
# entry point on local webdataset shards; see phase_trainer
TRAINER_BATCH = 64
TRAINER_STEPS = 4
TRAINER_SHARD_SAMPLES = 96
# steps of the trainer phase taken under the profiler: the first after an
# epoch boundary (epoch 1's first) and the one after it
TRAINER_PROFILED_STEPS = (TRAINER_STEPS, TRAINER_STEPS + 1)


def _trainer_argv(data, logs, workers, *extra):
    """scripts/train_cc3m.sh's flags with the paths and the cut-down
    counts of the smoke run."""
    return [
        "--logs-dir", logs, "--name", "trainer",
        "--model", "ViT-B-16", "--dataset-type", "webdataset",
        "--lr", "5e-4", "--warmup", "2000",
        "--train-data",
        f"{data}/train-{{0000..{max(8, workers) - 1:04d}}}.tar",
        "--train-num-samples", "768",
        "--val-data", f"{data}/val-0000.tar", "--val-num-samples", "128",
        "--batch-size", str(TRAINER_BATCH), "--precision", "amp",
        "--workers", str(workers), "--save-frequency", "1",
        "--log-every-n-steps", "1", "--wd", "0.5", "--beta1", "0.9",
        "--beta2", "0.98", "--eps", "1e-8", "--use-imagecrop-aug",
        "--global-crops-number", "2", "--local-crops-number", "6",
        "--crop-scale", "0.4", "--caption-sampling-mode", "textcrop",
        "--num-sampled-captions", "8", "--momentum-teacher", "0.999",
        "--fix-momentum", "--output-all", "--attentional-pool", "--cosmos",
        "--steps-per-epoch", str(TRAINER_STEPS),
        "--data-root-dir", f"{data}/eval", *extra]


def _profile_step(step, state, batch):
    """One step under torch.profiler, synchronised before and after:
    the window on the host clock, the device's busy time (kernels of one
    stream do not overlap), the kernels and the host calls (CUDA runtime
    calls included) that took most time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    device = {e.key: e.self_device_time_total / 1e3 for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0}
    host = {e.key: e.self_cpu_time_total / 1e3 for e in events
            if e.self_cpu_time_total > 0}
    busy = sum(device.values())
    top = lambda d: dict(sorted(d.items(), key=lambda kv: -kv[1])[:6])
    return m, dict(window_ms=window_ms, device_busy_ms=busy,
                   busy_share=busy / window_ms if device else None,
                   top_device_ms=top(device), top_host_ms=top(host))


@contextlib.contextmanager
def _gc_pauses(record):
    """Record the host-clock length (ms) of each collection of Python's
    oldest generation in the block: a pause of the host that a training
    step meets as device idle."""
    import gc

    started = {}

    def callback(phase, info):
        if info["generation"] != 2:
            return
        if phase == "start":
            started["t"] = time.perf_counter()
        elif "t" in started:
            record.append((time.perf_counter() - started.pop("t")) * 1e3)

    gc.callbacks.append(callback)
    try:
        yield
    finally:
        gc.callbacks.remove(callback)


@contextlib.contextmanager
def _instrumented_trainer(K, record, profiled=TRAINER_PROFILED_STEPS,
                          inspect=None):
    """Wrap the trainer's step and evaluation (main() imports both at call
    time) to count K1/K2 launches per step and per eval, and to check that
    every batch reaches the step on the card.  The steps whose index is in
    ``profiled`` run under the profiler; ``inspect(state, batch)`` is
    called before every step."""
    from cosmos_tpu_torch.training import evaluate as ev
    from cosmos_tpu_torch.training import train as tr

    make_step, evaluate = tr.make_train_step, ev.evaluate

    def counted_make_step(*a, **kw):
        step = make_step(*a, **kw)

        def counted(state, batch):
            check(all(t.is_cuda for t in batch.values()),
                  "the prefetcher handed the step a host tensor")
            if inspect is not None:
                inspect(state, batch)
            before = read_launches(K)
            if len(record["steps"]) in profiled:
                m, prof = _profile_step(step, state, batch)
                record["profiles"][len(record["steps"])] = prof
            else:
                m = step(state, batch)
            after = read_launches(K)
            record["steps"].append({k: after[k] - before[k] for k in after})
            return m
        return counted

    def counted_evaluate(*a, **kw):
        before = read_launches(K)
        out = evaluate(*a, **kw)
        after = read_launches(K)
        record["evals"].append({k: after[k] - before[k] for k in after})
        return out

    tr.make_train_step, ev.evaluate = counted_make_step, counted_evaluate
    try:
        with _as_main_module("cosmos_tpu_torch.training.main"):
            yield
    finally:
        tr.make_train_step, ev.evaluate = make_step, evaluate


@contextlib.contextmanager
def _as_main_module(name: str):
    """Make ``name`` the ``__main__`` module for the block.  The loader's
    worker processes re-import ``__main__``: as under ``python -m
    cosmos_tpu_torch.training.main``, they then import that module, which
    imports no torch, and not this script, which imports torch at its top."""
    import importlib

    saved = sys.modules["__main__"]
    sys.modules["__main__"] = importlib.import_module(name)
    try:
        yield
    finally:
        sys.modules["__main__"] = saved


def _loader_alone(argv, batches: int = 20):
    """The trainer's WdsTrainLoader on its own: time to the first batch,
    then samples/s over ``batches`` more, no step."""
    from cosmos_tpu_torch.models.factory import get_tokenizer
    from cosmos_tpu_torch.training.data_pipeline import get_data
    from cosmos_tpu_torch.training.params import parse_args

    args = parse_args(argv)
    loader = get_data(args, get_tokenizer("ViT-B-16"))["train"].dataloader
    try:
        with _as_main_module("cosmos_tpu_torch.training.main"):
            t0 = time.perf_counter()
            it = iter(loader)
            next(it)
        t1 = time.perf_counter()
        for _ in range(batches):
            next(it)
        seconds = time.perf_counter() - t1
    finally:
        loader.shutdown()
    return dict(first_batch_s=t1 - t0, batches=batches,
                samples_per_s=batches * TRAINER_BATCH / seconds)


def phase_trainer(K, tmp: str):
    """python -m cosmos_tpu_torch.training.main at full width: ViT-B-16
    COSMOS, train_cc3m.sh's recipe (amp, exact GELU, no text bucket,
    multi-crop 2 + 6, textcrop with 8 captions, momentum 0.999 fixed),
    batch 64, on webdataset shards of synthetic JPEGs made from a seed;
    2 epochs of 4 steps with val and COCO retrieval evals of student and
    teacher and a checkpoint each, then --resume latest for a third.
    The shards go to ``tmp``/data, where phase 15 reads them too."""
    import os
    import shutil

    from cosmos_tpu_torch.data.synthetic import write_coco, write_shards
    from cosmos_tpu_torch.models.convert import load_checkpoint
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.training import main as trainer
    from cosmos_tpu_torch.training.scheduler import get_lr_scheduler
    from cosmos_tpu_torch.training.train import LN100

    cpus = os.cpu_count() or 1
    workers = max(1, min(8, cpus - 1))
    t_phase = time.perf_counter()
    data, logs = f"{tmp}/data", f"{tmp}/logs"
    t0 = time.perf_counter()
    write_shards(data + "/train-{i:04d}.tar", max(8, workers),
                 TRAINER_SHARD_SAMPLES, seed=0)
    write_shards(data + "/val-{i:04d}.tar", 1, 128, seed=1)
    write_coco(data + "/eval/coco", 64, seed=2)
    data_s = time.perf_counter() - t0
    print(f"[trainer] {max(8, workers)} train shards of "
          f"{TRAINER_SHARD_SAMPLES} JPEGs (256-640 px), 1 val shard of "
          f"128, COCO layout of 64 images x 5 captions in {data_s:.1f} s; "
          f"{workers} workers, os.cpu_count() {cpus}")
    argv = _trainer_argv(data, logs, workers)
    record = {"steps": [], "evals": [], "profiles": {}, "gc_ms": []}
    zero_launches(K)
    t0 = time.perf_counter()
    with _instrumented_trainer(K, record), _gc_pauses(record["gc_ms"]):
        run1 = trainer.main(argv + ["--epochs", "2"])
        run2 = trainer.main(argv + ["--epochs", "3", "--resume", "latest"])
    wall_s = time.perf_counter() - t0
    launches = read_launches(K)
    loader = _loader_alone(argv + ["--epochs", "3"])
    ckpt_dir = f"{logs}/trainer/checkpoints"
    model = create_model("ViT-B-16", "amp", device="cuda", cosmos=True,
                         output_all=True, attentional_pool=True)
    for epoch in (1, 2, 3):
        for which in ("student", "teacher"):
            sd = load_checkpoint(f"{ckpt_dir}/epoch_{epoch}.pt", which)
            model.load_state_dict(sd, strict=True)
            for name in ("logit_scale", "distill_logit_scale"):
                v = float(sd[name])
                check(0.0 <= v <= LN100,
                      f"epoch {epoch} {which} {name} = {v}")
    del model
    torch.cuda.empty_cache()
    shutil.rmtree(logs)   # 7 GB of checkpoints; the shards stay for phase 15

    epochs = run1["train_epoch_stats"] + run2["train_epoch_stats"]
    check([s["epoch"] for s in epochs] == [0, 1, 2],
          f"epochs run {[s['epoch'] for s in epochs]}: the resumed run "
          "starts at epoch 2")
    logged = [line for s in epochs for line in s["logged"]]
    losses = [line["loss"] for line in logged]
    print(f"[trainer] losses {' '.join(f'{x:.5f}' for x in losses)}")
    check(len(losses) == 3 * TRAINER_STEPS and all(np.isfinite(losses)),
          f"a finite loss at every step: {losses}")
    for line in logged:
        check(0.0 < line["logit_scale"] <= 100.0 + 1e-3,
              f"exp(logit_scale) {line['logit_scale']} outside (0, 100]")
    lr = get_lr_scheduler("cosine", 5e-4, 2000, 3 * TRAINER_STEPS)
    first = epochs[2]["logged"][0]["lr"]
    check(first == lr(2 * TRAINER_STEPS),
          f"resumed lr {first} vs the schedule at update "
          f"{2 * TRAINER_STEPS}: {lr(2 * TRAINER_STEPS)}")
    per_step = step_launches(None, 12, TRAINER_BATCH, bucketed=False)
    want = {k: (v if k in ("K1", "K2") else 0) for k, v in per_step.items()}
    for i, got in enumerate(record["steps"]):
        check(got == want, f"step {i}: launches {got}, expected {want}")
    check(len(record["steps"]) == 3 * TRAINER_STEPS, "steps counted")
    for got in record["evals"]:
        check(got["K1"] > 0 and all(got[k] == 0 for k in got if k != "K1"),
              f"an eval launches K1 only: {got}")
    check(len(record["evals"]) == 3, "one eval per epoch")
    for prefix in ("", "ema_"):
        for key in ("clip_val_loss", "coco_image_to_text_R@1",
                    "coco_text_to_image_R@10", "image_to_text_R@5"):
            v = run2.get(prefix + key)
            check(v is not None and np.isfinite(v), f"{prefix}{key}: {v}")
            check(0.0 <= v <= (100.0 if "loss" in key else 1.0),
                  f"{prefix}{key} = {v}")
        for key in ("coco_image_to_text_mean_rank",
                    "coco_text_to_image_median_rank"):
            v = run2[prefix + key]
            check(1.0 <= v <= 320.0, f"{prefix}{key} = {v}")

    # steady state: each epoch's steps after its first, but for the
    # profiled ones
    def steady(e, i):
        return i > 0 and e * TRAINER_STEPS + i not in TRAINER_PROFILED_STEPS

    step_ms = [ms for e, s in enumerate(epochs)
               for i, ms in enumerate(s["step_ms"]) if steady(e, i)]
    samples_s = [line["samples_per_s"] for e, s in enumerate(epochs)
                 for line in s["logged"] if steady(e, line["step"])]
    out = dict(
        data_dir=data,
        workers=workers, cpu_count=cpus, data_write_s=data_s, wall_s=wall_s,
        launches=launches, launches_per_step=want,
        eval_launches=record["evals"], losses=losses,
        resumed_first_lr=first,
        epochs=[{k: s[k] for k in ("epoch", "wall_s", "data_wait_s",
                                   "data_wait_share", "samples_per_s",
                                   "step_ms", "eval_s")} for s in epochs],
        step_ms_mean=float(np.mean(step_ms)),
        window_samples_per_s_mean=float(np.mean(samples_s)),
        data_wait_share=(sum(s["data_wait_s"] for s in epochs)
                         / sum(s["wall_s"] for s in epochs)),
        loader_alone=dict(loader, workers=workers,
                          samples_per_s_per_worker=loader["samples_per_s"]
                          / workers),
        eval_s=[s["eval_s"] for s in epochs],
        profiled_steps=record["profiles"],
        gc_gen2_ms=record["gc_ms"],
        metrics={k: v for k, v in run2.items()
                 if isinstance(v, (int, float))},
        phase_s=time.perf_counter() - t_phase)
    print(f"[trainer] ms per step (CUDA events around the step calls, data "
          f"wait apart; steps 2+ of each epoch, not the profiled ones) "
          f"{out['step_ms_mean']:.3f}; "
          f"samples/s (train_one_epoch's windows) "
          f"{out['window_samples_per_s_mean']:.1f}; data-wait share "
          f"{out['data_wait_share']:.3f} ("
          + ", ".join(f"epoch {s['epoch']} {s['data_wait_share']:.3f}"
                      for s in epochs) + ")")
    print(f"[trainer] loader alone: {loader['samples_per_s']:.1f} samples/s "
          f"({out['loader_alone']['samples_per_s_per_worker']:.1f} per "
          f"worker, {workers} workers, os.cpu_count() {cpus}), first batch "
          f"after {loader['first_batch_s']:.2f} s")
    print(f"[trainer] evals (val + COCO retrieval, student and teacher) "
          + ", ".join(f"{s:.2f} s" for s in out["eval_s"])
          + f"; K1 launches per eval {[e['K1'] for e in record['evals']]}")
    for i, prof in record["profiles"].items():
        busy = ("not measured (no device time recorded)"
                if prof["busy_share"] is None
                else f"{prof['device_busy_ms']:.3f} ms busy (share "
                     f"{prof['busy_share']:.3f})")
        print(f"[trainer] step {i} profiled: window "
              f"{prof['window_ms']:.3f} ms, device {busy}; top device "
              + "; ".join(f"{k[:60]} {v:.2f}"
                          for k, v in prof["top_device_ms"].items())
              + "; top host " + "; ".join(
                  f"{k[:40]} {v:.2f}" for k, v in prof["top_host_ms"].items()))
    gc_ms = record["gc_ms"]
    print(f"[trainer] Python gen-2 collections during the two runs: "
          f"{len(gc_ms)}, {sum(gc_ms):.1f} ms in all, longest "
          f"{max(gc_ms, default=0.0):.1f} ms")
    print(f"[trainer] launches {launches}; per step {want}; resumed lr "
          f"{first:.6g}; phase {out['phase_s']:.1f} s")
    return out


# the eval phases (13, 14): ViT-B-16 COSMOS from one random checkpoint,
# the classification eval through the trainer's entry point and the
# segmentation eval through its own
EVAL_MODEL_SEED = 7
CLS_IMAGENET_CLASSES = 1000
CLS_CIFAR_IMAGES = 2000
CLS_BATCH = 256
# ImageNet classes held card against CPU
CLS_CARD_VS_CPU_CLASSES = 8
# float32 on both sides, TF32 off: summation order through 12 layers; the
# classifier's columns and the segmentor's logits are cosines
EVAL_CARD_VS_CPU_TOL = (1e-4, 0.0)
SEG_VOC_SIZES = [(500, 375)] * 16
# ADE20K: 4 of 16 images with a short side below 336, which SegDataset
# enlarges, so that the final logits shrink to the label's shape
SEG_ADE_SIZES = [(640, 480), (512, 683), (600, 400)] * 4 + [
    (400, 300), (300, 250), (500, 320), (256, 256)]
SEG_PAMR_IMAGES = 2
# the K1 geometry of one chunk of 8 segmentation windows in float32
SEG_K1_GEOMETRY = ("segmentation windows", 8, 197, 3 * 768, 12, False)


def _eval_checkpoint(path: str) -> str:
    """A bare state dict of ViT-B-16 COSMOS with random weights from
    EVAL_MODEL_SEED (the trainer and seg_eval load it as student and as
    teacher)."""
    from cosmos_tpu_torch.models.factory import create_model

    model = create_model("ViT-B-16", "fp32", device="cpu",
                         seed=EVAL_MODEL_SEED, **COSMOS)
    torch.save(model.state_dict(), path)
    return path


@contextlib.contextmanager
def _counted_evals(K, record):
    """Wrap the zero-shot evals' and the segmentor's device calls (each
    module looks them up at call time) to record, per text, image and
    vision call, the rows and the launches of K1-K6, and the wall time of
    each classifier build, classification pass and segmentor prediction
    (each ends on the host, so its wall time holds the device's)."""
    from cosmos_tpu_torch.segmentation.segmentor import CLIPSegmentor
    from cosmos_tpu_torch.training import zero_shot as zs

    build, run = zs.build_zero_shot_classifier, zs.run_classification_eval
    forward, predict = CLIPSegmentor._forward_feature, CLIPSegmentor.predict

    def counted(kind, fn):
        def call(x):
            before = read_launches(K)
            out = fn(x)
            after = read_launches(K)
            record[kind].append(dict(rows=len(x), **{
                k: after[k] - before[k] for k in after}))
            return out
        return call

    def timed_build(encode_text_fn, tokenizer, classnames, templates,
                    *a, **kw):
        t0 = time.perf_counter()
        out = build(counted("text_calls", encode_text_fn), tokenizer,
                    classnames, templates, *a, **kw)
        torch.cuda.synchronize()
        record["builds"].append(dict(
            classes=len(classnames), prompts=len(classnames) * len(templates),
            s=time.perf_counter() - t0))
        return out

    def timed_run(encode_image_fn, classifier, dataloader):
        t0 = time.perf_counter()
        n0 = sum(c["rows"] for c in record["image_calls"])
        out = run(counted("image_calls", encode_image_fn), classifier,
                  dataloader)
        record["passes"].append(dict(
            images=sum(c["rows"] for c in record["image_calls"]) - n0,
            s=time.perf_counter() - t0))
        return out

    def counted_forward(self, images):
        return counted("vision_calls", lambda x: forward(self, x))(images)

    def timed_predict(self, image_u8, ori_shape=None):
        t0 = time.perf_counter()
        w0 = sum(c["rows"] for c in record["vision_calls"])
        out = predict(self, image_u8, ori_shape)
        record["predictions"].append(dict(
            windows=sum(c["rows"] for c in record["vision_calls"]) - w0,
            s=time.perf_counter() - t0, csa=self.use_csa))
        return out

    zs.build_zero_shot_classifier = timed_build
    zs.run_classification_eval = timed_run
    CLIPSegmentor._forward_feature = counted_forward
    CLIPSegmentor.predict = timed_predict
    try:
        yield
    finally:
        zs.build_zero_shot_classifier = build
        zs.run_classification_eval = run
        CLIPSegmentor._forward_feature = forward
        CLIPSegmentor.predict = predict


@contextlib.contextmanager
def _timed_benchmarks(seg_eval, record):
    """Record the wall time of each seg_eval.evaluate_benchmark call
    (segmentor build, then the loop over the benchmark's images)."""
    evaluate = seg_eval.evaluate_benchmark

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = evaluate(*a, **kw)
        record["benchmarks"].append(time.perf_counter() - t0)
        return out

    seg_eval.evaluate_benchmark = timed
    try:
        yield
    finally:
        seg_eval.evaluate_benchmark = evaluate


def _eval_record():
    return {"text_calls": [], "image_calls": [], "vision_calls": [],
            "builds": [], "passes": [], "predictions": [],
            "benchmarks": []}


def _k1_only(calls, per_call, what):
    """Every call launched ``per_call`` K1 and none of K2-K6."""
    for i, c in enumerate(calls):
        check(c["K1"] == per_call and all(c[k] == 0 for k in c
                                           if k not in ("K1", "rows")),
              f"{what} call {i}: launches {c}, expected K1 {per_call} only")


def phase_classification(K, ckpt: str):
    """python -m cosmos_tpu_torch.training.main --eval-mode classification
    at full width: ViT-B-16 COSMOS in bfloat16 (amp) from a random
    checkpoint, student and teacher, on an ImageNet val layout of 1000
    classes x 1 seeded JPEG (256-500 px) and a CIFAR-10 test batch of 2000
    seeded images; then the ImageNet classifier's columns of 8 classes,
    card against CPU, on the same float32 weights."""
    import tempfile

    from cosmos_tpu_torch.data.synthetic import (write_cifar10,
                                                 write_image_folder)
    from cosmos_tpu_torch.models.factory import create_model, get_tokenizer
    from cosmos_tpu_torch.training import main as trainer
    from cosmos_tpu_torch.training import zero_shot as zs
    from cosmos_tpu_torch.training.evaluate import make_encoders

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cosmos_cls_") as tmp:
        t0 = time.perf_counter()
        write_image_folder(f"{tmp}/imagenet/val", CLS_IMAGENET_CLASSES, 1,
                           seed=10)
        write_cifar10(f"{tmp}/classification/cifar10", CLS_CIFAR_IMAGES,
                      seed=11)
        data_s = time.perf_counter() - t0
        argv = ["--model", "ViT-B-16", "--pretrained", ckpt,
                "--cosmos", "--output-all", "--attentional-pool",
                "--add-zero-attn", "--precision", "amp",
                "--eval-mode", "classification",
                "--imagenet-val", f"{tmp}/imagenet/val",
                "--classification-data-dir", f"{tmp}/classification",
                "--zeroshot-eval-datasets", "cifar10",
                "--batch-size", str(CLS_BATCH), "--logs-dir", f"{tmp}/logs",
                "--name", "classification"]
        record = _eval_record()
        zero_launches(K)
        t0 = time.perf_counter()
        with _counted_evals(K, record):
            metrics = trainer.main(argv)
        wall_s = time.perf_counter() - t0
        launches = read_launches(K)

    _k1_only(record["text_calls"], 12, "text")
    _k1_only(record["image_calls"], 12, "image")
    calls = len(record["text_calls"]) + len(record["image_calls"])
    check(launches["K1"] == 12 * calls
          and all(launches[k] == 0 for k in launches if k != "K1"),
          f"the run's launches {launches} vs 12 K1 a call x {calls} calls")
    # student and teacher: one ImageNet (1000 x 80 prompts) and one CIFAR-10
    # (10 x 18) classifier each
    meta = zs.load_imagenet_metadata()
    n_prompts = len(meta["classnames"]) * len(meta["templates"])
    imagenet = [b for b in record["builds"]
                if b["classes"] == len(meta["classnames"])]
    check(len(imagenet) == 2
          and all(b["prompts"] == n_prompts for b in imagenet)
          and len(record["builds"]) == 4, f"builds {record['builds']}")
    images = [p["images"] for p in record["passes"]]
    check(images == [CLS_IMAGENET_CLASSES, CLS_CIFAR_IMAGES] * 2,
          f"images per pass {images}")
    keys = [f"{p}{n}-zeroshot-val-top{k}" for p in ("", "ema_")
            for n in ("imagenet", "cifar10") for k in (1, 5)]
    for key in keys:
        v = metrics.get(key)
        check(v is not None and 0.0 <= v <= 1.0, f"{key} = {v}")
    check(not any("retrieval" in k or "R@" in k for k in metrics),
          "--eval-mode classification ran no retrieval")

    # card against CPU: the ImageNet classifier of 8 classes, float32
    torch.backends.cuda.matmul.allow_tf32 = False
    classnames = meta["classnames"][:CLS_CARD_VS_CPU_CLASSES]
    templates = meta["templates"]
    columns = {}
    for device in ("cuda", "cpu"):
        model = create_model("ViT-B-16", "fp32", device=device, **COSMOS)
        model.load_state_dict(torch.load(ckpt, map_location=device,
                                         weights_only=True), strict=True)
        columns[device] = zs.build_zero_shot_classifier(
            make_encoders(model)[2], get_tokenizer("ViT-B-16"), classnames,
            templates, eot_truncate=True).cpu()
        del model
    torch.cuda.empty_cache()
    err = _held("ImageNet classifier, card vs CPU (float32, 8 classes)",
                columns["cuda"], columns["cpu"], EVAL_CARD_VS_CPU_TOL)

    builds = {"imagenet": imagenet, "cifar10": [
        b for b in record["builds"] if b not in imagenet]}
    prompts_s = [b["prompts"] / b["s"] for b in imagenet]
    passes = {"imagenet": record["passes"][0::2],
              "cifar10": record["passes"][1::2]}
    images_s = {k: [p["images"] / p["s"] for p in v]
                for k, v in passes.items()}
    out = dict(
        data_write_s=data_s, wall_s=wall_s, launches=launches,
        text_calls=len(record["text_calls"]),
        image_calls=len(record["image_calls"]),
        k1_per_text_call=12, k1_per_image_call=12,
        classifier_build_s={k: [b["s"] for b in v] for k, v in
                            builds.items()},
        imagenet_prompts_per_s=prompts_s, images_per_s=images_s,
        metrics={k: metrics[k] for k in keys},
        classifier_card_vs_cpu_max_abs_err=err,
        phase_s=time.perf_counter() - t_phase)
    print(f"[classification] {CLS_IMAGENET_CLASSES} ImageNet-layout JPEGs "
          f"(256-500 px) and a CIFAR-10 batch of {CLS_CIFAR_IMAGES} in "
          f"{data_s:.1f} s; trainer --eval-mode classification {wall_s:.1f} s "
          f"(student and teacher, amp)")
    print(f"[classification] ImageNet classifier ({n_prompts} prompts) "
          "built in "
          + ", ".join(f"{b['s']:.2f} s ({r:.0f} prompts/s)"
                      for b, r in zip(imagenet, prompts_s))
          + "; images/s ImageNet "
          + ", ".join(f"{r:.1f}" for r in images_s["imagenet"])
          + ", CIFAR-10 " + ", ".join(f"{r:.1f}" for r in images_s["cifar10"])
          + " (host decode and transform included)")
    print(f"[classification] launches {launches}: 12 K1 in each of "
          f"{out['text_calls']} text and {out['image_calls']} image calls; "
          + " ".join(f"{k} {metrics[k]:.4f}" for k in keys))
    print(f"[classification] classifier card vs CPU (float32, "
          f"{CLS_CARD_VS_CPU_CLASSES} classes): max abs err {err:.3g}; "
          f"phase {out['phase_s']:.1f} s")
    return out


def phase_segmentation(K, ckpt: str):
    """python -m cosmos_tpu_torch.training.seg_eval at full width, float32
    (its default): ViT-B-16 COSMOS teacher weights from a random
    checkpoint on a voc20 layout (16 seeded 500x375 images, labels 0-20
    and 255) and an ade20k layout (16 images, 4 with a short side below
    336), with CSA and without, then PAMR (10 steps) on 2 voc20 images;
    then one image's segmentor logits, card against CPU, and K1 in float32
    at a chunk of 8 windows."""
    import tempfile

    from cosmos_tpu_torch.data.synthetic import write_segmentation
    from cosmos_tpu_torch.models.factory import create_model, get_tokenizer
    from cosmos_tpu_torch.segmentation import (SEG_BENCHMARKS, CLIPSegmentor,
                                               SegDataset,
                                               load_seg_classnames)
    from cosmos_tpu_torch.training import seg_eval

    t_phase = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory(prefix="cosmos_seg_") as tmp:
        t0 = time.perf_counter()
        write_segmentation(tmp, "voc", SEG_VOC_SIZES, n_labels=21, seed=20)
        write_segmentation(tmp, "ade20k", SEG_ADE_SIZES, n_labels=151,
                           seed=21)
        data_s = time.perf_counter() - t0
        base = ["--model", "ViT-B-16", "--pretrained", ckpt,
                "--seg-data-root", tmp]
        for name, extra in (
                ("csa", ["--benchmarks", "voc20,ade20k", "--use-csa"]),
                ("plain", ["--benchmarks", "voc20,ade20k"]),
                ("csa + pamr 10", ["--benchmarks", "voc20", "--use-csa",
                                   "--pamr-steps", "10", "--limit",
                                   str(SEG_PAMR_IMAGES)])):
            record = _eval_record()
            zero_launches(K)
            t0 = time.perf_counter()
            with _counted_evals(K, record), _timed_benchmarks(
                    seg_eval, record):
                results = seg_eval.main(base + extra)
            runs[name] = dict(results=results, record=record,
                              launches=read_launches(K),
                              wall_s=time.perf_counter() - t0)
        bench = SEG_BENCHMARKS["voc20"]
        image, label = SegDataset(bench, data_root=tmp)[0]

    for name, run in runs.items():
        record, launches = run["record"], run["launches"]
        per_vision = 11 if "csa" in name else 12
        _k1_only(record["text_calls"], 12, f"{name} text")
        _k1_only(record["vision_calls"], per_vision, f"{name} vision")
        calls = len(record["text_calls"]), len(record["vision_calls"])
        check(launches["K1"] == 12 * calls[0] + per_vision * calls[1]
              and all(launches[k] == 0 for k in launches if k != "K1"),
              f"{name}: launches {launches} vs {calls} text/vision calls")
        check(all(c["rows"] <= 8 for c in record["vision_calls"]),
              f"{name}: a vision call of more than 8 windows")
        want_images = (SEG_PAMR_IMAGES if "pamr" in name
                       else len(SEG_VOC_SIZES) + len(SEG_ADE_SIZES))
        check(len(record["predictions"]) == want_images,
              f"{name}: {len(record['predictions'])} images predicted")
        for bench_name, m in run["results"].items():
            for key in ("mIoU", "aAcc", "mAcc"):
                check(np.isfinite(m[key]) and 0.0 <= m[key] <= 100.0,
                      f"{name} {bench_name} {key} = {m[key]}")
        check(set(run["results"]) == ({"voc20"} if "pamr" in name
                                      else {"voc20", "ade20k"}),
              f"{name}: benchmarks {sorted(run['results'])}")
        seconds = sum(p["s"] for p in record["predictions"])
        windows = sum(p["windows"] for p in record["predictions"])
        # the benchmark loops: the dataset's decode and resize, predict and
        # the IoU update, each benchmark's query features left out
        loop_s = sum(record["benchmarks"]) - sum(b["s"] for b in
                                                 record["builds"])
        run.update(images=len(record["predictions"]), windows=windows,
                   predict_s=seconds, loop_s=loop_s,
                   images_per_s=len(record["predictions"]) / seconds,
                   windows_per_s=windows / seconds,
                   loop_images_per_s=len(record["predictions"]) / loop_s,
                   k1_per_vision_call=per_vision,
                   text_calls=calls[0], vision_calls=calls[1],
                   query_build_s=[b["s"] for b in record["builds"]])
        del run["record"]
        print(f"[segmentation] {name}: {run['images']} images "
              f"({windows} windows) in {seconds:.2f} s of predict: "
              f"{run['images_per_s']:.2f} images/s, "
              f"{run['windows_per_s']:.1f} windows/s "
              f"({run['loop_images_per_s']:.2f} images/s with the "
              f"dataset's decode and IoU, {loop_s:.2f} s); query features "
              + ", ".join(f"{s:.2f} s" for s in run["query_build_s"])
              + f"; launches {launches} ({per_vision} K1 in each of "
              f"{calls[1]} vision calls, 12 in each of {calls[0]} text "
              f"calls); wall {run['wall_s']:.1f} s; "
              + "; ".join(f"{b} mIoU {m['mIoU']:.3f} aAcc {m['aAcc']:.3f}"
                          for b, m in run["results"].items()))

    # card against CPU: one voc20 image's logits through the segmentor
    # with CSA, float32, 4 of voc20's class lines
    torch.backends.cuda.matmul.allow_tf32 = False
    logits = {}
    for device in ("cuda", "cpu"):
        model = create_model("ViT-B-16", "fp32", device=device, **COSMOS)
        model.load_state_dict(torch.load(ckpt, map_location=device,
                                         weights_only=True), strict=True)
        seg = CLIPSegmentor(model, get_tokenizer("ViT-B-16"),
                            load_seg_classnames("voc20")[:4], use_csa=True)
        logits[device] = seg.seg_logits(image, label.shape[:2]).cpu()
        del model, seg
    torch.cuda.empty_cache()
    err = _held("segmentor logits, card vs CPU (float32, CSA)",
                logits["cuda"], logits["cpu"], EVAL_CARD_VS_CPU_TOL)
    print(f"[segmentation] {data_s:.1f} s to write the layouts; one image's "
          f"logits {tuple(logits['cuda'].shape)} card vs CPU: max abs err "
          f"{err:.3g}")

    label_, b, l, d3, heads, causal = SEG_K1_GEOMETRY
    row = kernel_row(K.fa, label_, b, l, d3, heads, causal, torch.float32,
                     torch.Generator(device="cuda").manual_seed(1))
    out = dict(data_write_s=data_s, runs=runs,
               logits_card_vs_cpu_max_abs_err=err, k1_f32_row=row,
               phase_s=time.perf_counter() - t_phase)
    print(f"[segmentation] phase {out['phase_s']:.1f} s")
    return out


# phase 15: the trainer's options and modes (the rest of the one-card
# training step): the kernels at the patch-dropped lengths, each mode and
# option card against CPU, and five full-width trainer runs
# (label, B, L, 3D, heads, causal): patch dropout at p = 0.5 keeps 98 of
# the globals' 196 patches and 18 of the 96px locals' 36, behind the class
# token, at a per-card batch of 64
DROP_GEOMETRIES = [
    ("vision globals, patch dropout 0.5", 128, 99, 3 * 768, 12, False),
    ("vision 96px locals, patch dropout 0.5", 384, 19, 3 * 768, 12, False),
]
OPTIONS_STEPS = 4
# JAX's remat policies, one name of each family the port maps
REMAT_FAMILIES = ("", "dots_saveable", "dots_with_no_batch_dims_saveable",
                  "everything_saveable")
# a remat step against the same step without remat, on the card: the same
# kernels on the same inputs, so float rounding at most
REMAT_RTOL = 1e-5
LOCK = dict(lock_image=True, lock_text=True, unlocked_groups=2,
            text_unlocked_layers=1)
# (name, the run's flags, micro-batches a step, the remat policy (None: no
# remat), the blocks of each tower call of a micro-batch that get a
# gradient): the student's calls are
# the globals, the locals and one call of the 8 caption views (the trainer
# runs no text bucket); the teacher's (COSMOS) the globals and the first 2
# caption views, the distillation model's the student's three, none with
# a gradient
OPTION_RUNS = [
    ("clip", ["--accum-freq", "2", "--force-patch-dropout", "0.5",
              "--grad-checkpointing"], 2, "",
     # the exact accumulation's cache pass, then its gradient pass
     (0, 0, 0, 12, 12, 12)),
    ("cosmos-locked", ["--cosmos", "--lock-image",
                       "--lock-image-unlocked-groups", "2", "--lock-text",
                       "--lock-text-unlocked-layers", "1",
                       "--init-last-layer", "--grad-checkpointing",
                       "--remat-policy", "dots_with_no_batch_dims_saveable",
                       "--val-frequency", "1"], 1,
     "dots_with_no_batch_dims_saveable",
     # the last block of each student tower is trainable
     (1, 1, 1, 0, 0)),
    ("siglip", ["--siglip", "--accum-freq", "2"], 2, None, (12, 12, 12)),
    ("distill", ["--distill-model", "ViT-B-16"], 1, None,
     (12, 12, 12, 0, 0, 0)),
    ("cosmos-flash-off", ["--cosmos", "--flash-attention", "off"], 1, None,
     None),
]


def remat_recomputes(policy) -> bool:
    """Whether a remat policy (None: no remat) runs K1 again in the
    backward: the kernel is a registered operator whose output no policy
    but ``everything_saveable`` keeps, as JAX's policies treat the Pallas
    call (``models/transformer.py``)."""
    return policy is not None and policy != "everything_saveable"


def option_launches(accum: int, policy, calls, layers: int = 12) -> dict:
    """K1/K2 per step of a trainer run from its tower calls: every call
    launches K1 once a block; a block that gets a gradient launches K2 in
    the backward and, under a remat ``policy`` that recomputes it, K1
    again.  ``calls`` None: the plain attention path, no launch."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0)
    again = remat_recomputes(policy)
    for grad_blocks in calls or ():
        out["K1"] += accum * (layers + (grad_blocks if again else 0))
        out["K2"] += accum * grad_blocks
    return out


def _drop_flags(argv, values=(), switches=()):
    """``argv`` without the ``switches`` and the ``values`` flags (each with
    the value after it)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in values:
            skip = True
        elif a not in switches:
            out.append(a)
    return out


def _options_kernel_rows(fa):
    """15(a): K1 and K2 held to their plain versions, and timed, at the
    patch-dropped lengths in both dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = [kernel_row(fa, label, b, l, d3, heads, causal, dtype, gen)
            for label, b, l, d3, heads, causal in DROP_GEOMETRIES
            for dtype in (torch.float32, torch.bfloat16)]
    bwd = [kernel_bwd_row(fa, label, b, l, d3, heads, causal, dtype, gen)
           for label, b, l, d3, heads, causal in DROP_GEOMETRIES
           for dtype in (torch.float32, torch.bfloat16)]
    return rows, bwd


def _step_run(model, cfg_kw, batch, lr, frozen=None, dist=None):
    """One training step of ``model`` on its device: (loss, every
    gradient, the updated student and teacher, all on the CPU; the step's
    K1 and K2 launches)."""
    from cosmos_tpu_torch import create_optimizer, create_train_state
    from cosmos_tpu_torch.ops import fused_attention as fa
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import (TrainStepConfig, freeze,
                                                 make_train_step)

    dev = next(model.parameters()).device
    if frozen is not None:
        freeze(model, frozen)
    opt = create_optimizer(model, const_lr(lr, 0, 100), beta1=0.9,
                           beta2=0.98, eps=1e-8, weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.999, fix_momentum=True,
                          frozen=frozen, seed=3, **cfg_kw)
    step = make_train_step(model, opt, cfg, dist_model=dist)
    state = create_train_state(model, opt)
    before = (fa.launches, fa.launches_bwd)
    m = step(state, {k: v.to(dev) for k, v in batch.items()})
    return dict(
        K1=fa.launches - before[0], K2=fa.launches_bwd - before[1],
        loss=m["loss"].item(),
        grads={n: p.grad.detach().cpu() for n, p in model.named_parameters()
               if p.grad is not None},
        student={k: v.cpu() for k, v in state.student.state_dict().items()},
        teacher={k: v.cpu() for k, v in state.teacher.state_dict().items()})


def _grad_errs(got, want, rel, atol, what):
    """Max abs error of every gradient, each held to ``rel`` times its
    tensor's largest magnitude plus ``atol``."""
    check(got.keys() == want.keys(),
          f"{what}: gradients of {sorted(got.keys() ^ want.keys())} on one "
          "side only")
    worst = 0.0
    for name, w in want.items():
        err = (got[name] - w).abs().max().item()
        check(err <= rel * w.abs().max().item() + atol,
              f"{what}: grad {name} max err {err}")
        worst = max(worst, err)
    return worst


def _options_card_vs_cpu(lr: float = 1e-4):
    """15(b): one 2-layer float32 step at batch 2 of each mode and option,
    on the card and on the CPU from the same weights: the loss, every
    gradient and the updated student and teacher at phase 8's tolerance;
    and each remat policy on the card against no remat."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training.train import frozen_mask

    small = dict(vision_layers=2, text_layers=2, seed=7)
    plain = dict(act_approx=True)   # TRAIN_RECIPE's GELU, without COSMOS
    b1 = _train_batch(2, seed=31, device="cpu")
    b2 = _train_batch(2, seed=32, device="cpu")
    stacked = {k: torch.stack([b1[k], b2[k]]) for k in b1}
    cases = [
        ("clip accum 2, patch dropout 0.5",
         dict(plain, force_patch_dropout=0.5),
         dict(cosmos=False, accum_freq=2), stacked),
        ("siglip", dict(plain, init_logit_scale=float(np.log(10.0)),
                        init_logit_bias=-10.0),
         dict(cosmos=False, siglip=True), b1),
        ("distill", plain, dict(cosmos=False, distill=True), b1),
        ("cosmos LiT-locked", dict(TRAIN_RECIPE), dict(cosmos=True), b1),
    ] + [(f"cosmos remat {p or 'nothing_saveable'}",
          dict(TRAIN_RECIPE, grad_checkpointing=True, remat_policy=p),
          dict(cosmos=True), b1) for p in REMAT_FAMILIES]
    errs, card = {}, {}
    no_remat = None
    for name, model_kw, cfg_kw, batch in cases:
        cpu_model = create_model("ViT-B-16", "fp32", device="cpu",
                                 **small, **model_kw)
        init = {k: v.clone() for k, v in cpu_model.state_dict().items()}
        gpu_model = copy.deepcopy(cpu_model).to("cuda")
        frozen = (frozen_mask(cpu_model, **LOCK)
                  if name == "cosmos LiT-locked" else None)
        dist = None
        if cfg_kw.get("distill"):
            dist = create_model("ViT-B-16", "fp32", device="cpu",
                                **dict(small, seed=8), **plain)
        runs = {}
        for dev, model in (("cpu", cpu_model), ("cuda", gpu_model)):
            runs[dev] = _step_run(
                model, cfg_kw, batch, lr, frozen,
                None if dist is None else copy.deepcopy(dist).to(dev))
        cpu, gpu = runs["cpu"], runs["cuda"]
        e = {"loss": abs(gpu["loss"] - cpu["loss"])}
        check(e["loss"] <= 1e-4 * abs(cpu["loss"]),
              f"{name}: loss card {gpu['loss']} vs CPU {cpu['loss']}")
        e["grads"] = _grad_errs(gpu["grads"], cpu["grads"], 1e-3, 1e-8, name)
        for which in ("student", "teacher"):
            e[which] = max((gpu[which][k] - cpu[which][k]).abs().max().item()
                           for k in cpu[which])
            check(e[which] <= 2 * lr,
                  f"{name}: updated {which} card vs CPU max err {e[which]}")
        if frozen is not None:
            check(all(torch.equal(gpu["student"][k], init[k])
                      for k in frozen if frozen[k]),
                  f"{name}: a frozen parameter moved")
            check(not any(frozen[k] for k in gpu["grads"]),
                  f"{name}: a frozen parameter got a gradient")
        if name.startswith("cosmos remat"):
            if no_remat is None:
                base = create_model("ViT-B-16", "fp32", device="cpu",
                                    **small, **TRAIN_RECIPE).to("cuda")
                no_remat = _step_run(base, cfg_kw, batch, lr)
            e["vs no remat"] = _grad_errs(gpu["grads"], no_remat["grads"],
                                          REMAT_RTOL, 0.0, name)
            check(abs(gpu["loss"] - no_remat["loss"])
                  <= REMAT_RTOL * abs(no_remat["loss"]),
                  f"{name}: loss {gpu['loss']} vs {no_remat['loss']} "
                  "without remat")
            # K1 again for each block that gets a gradient (one K2 each),
            # but under everything_saveable
            again = remat_recomputes(name.removeprefix("cosmos remat "))
            check(gpu["K2"] == no_remat["K2"] and gpu["K1"] - no_remat["K1"]
                  == (gpu["K2"] if again else 0),
                  f"{name}: K1/K2 {gpu['K1']}/{gpu['K2']} against "
                  f"{no_remat['K1']}/{no_remat['K2']} without remat")
            e["K1"], e["K2"] = gpu["K1"], gpu["K2"]
        errs[name] = e
        print(f"[options-card-vs-cpu] {name}: loss {gpu['loss']:.6f}, max "
              "abs err " + " ".join(f"{k}={v:.3g}" for k, v in e.items()))
    return errs


def phase_trainer_options(K, card: str, trainer_record, tmp: str):
    """Phase 15: the trainer's options and modes.  (a) K1 and K2 at the
    patch-dropped lengths; (b) each mode and option card against CPU;
    (c) python -m cosmos_tpu_torch.training.main at full width for each of
    OPTION_RUNS: ViT-B-16, amp, batch 64, phase 12's shards and flags, 1
    epoch of OPTIONS_STEPS steps, one COCO retrieval eval (after the
    LiT-locked run); the exact K1/K2 launches of every step, finite losses,
    the clamp, frozen parameters unchanged, the re-drawn last blocks, the
    samples of a step; ms per step (CUDA events), samples/s, peak memory."""
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.training import main as trainer

    t_phase = time.perf_counter()
    rows, bwd_rows = _options_kernel_rows(K.fa)
    card_vs_cpu = _options_card_vs_cpu()

    data = trainer_record["data_dir"]
    workers = trainer_record["workers"]
    dist_pt = f"{tmp}/distill_vit_b_16.pt"
    torch.save(create_model("ViT-B-16", "fp32", device="cpu",
                            seed=11).state_dict(), dist_pt)
    base = _drop_flags(
        _trainer_argv(data, f"{tmp}/option_logs", workers),
        values=("--val-data", "--val-num-samples", "--steps-per-epoch"),
        switches=("--cosmos",))
    base += ["--epochs", "1", "--steps-per-epoch", str(OPTIONS_STEPS),
             "--val-frequency", "0"]
    runs = {}
    zero_launches(K)
    for name, flags, accum, policy, calls in OPTION_RUNS:
        if name == "distill":
            flags = flags + ["--distill-pretrained", dist_pt]
        record = {"steps": [], "evals": [], "profiles": {}}
        seen = {"samples": []}

        def inspect(state, batch, seen=seen):
            g = batch["global_images"]
            seen["samples"].append(g.shape[0] * g.shape[2] if accum > 1
                                   else g.shape[1])
            if "state" in seen:
                return
            seen["state"] = state
            seen["frozen"] = {n: p.detach().clone() for n, p in
                              state.student.named_parameters()
                              if not p.requires_grad}
            last = "visual.transformer.resblocks.11.attn.in_proj_weight"
            first = "visual.transformer.resblocks.0.attn.in_proj_weight"
            s, t = state.student.state_dict(), state.teacher.state_dict()
            seen["last_differs"] = not torch.equal(s[last], t[last])
            seen["first_equal"] = torch.equal(s[first], t[first])

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _instrumented_trainer(K, record, profiled=(), inspect=inspect):
            metrics = trainer.main(base + ["--name", name] + flags)
        wall_s = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = option_launches(accum, policy, calls)
        stats = metrics["train_epoch_stats"][0]
        logged = stats["logged"]
        losses = [line["loss"] for line in logged]
        check(len(record["steps"]) == OPTIONS_STEPS, f"{name}: steps run")
        for i, got in enumerate(record["steps"]):
            check(got == want, f"{name} step {i}: launches {got}, "
                  f"expected {want}")
        check(len(losses) == OPTIONS_STEPS and all(np.isfinite(losses)),
              f"{name}: a finite loss at every step {losses}")
        for line in logged:
            check(0.0 < line["logit_scale"] <= 100.0 + 1e-3,
                  f"{name}: exp(logit_scale) {line['logit_scale']}")
        check(seen["samples"] == [TRAINER_BATCH * accum] * OPTIONS_STEPS,
              f"{name}: samples a step {seen['samples']}")
        student = seen["state"].student
        params = dict(student.named_parameters())
        moved = [n for n, v in seen["frozen"].items()
                 if not torch.equal(v, params[n])]
        check(not moved, f"{name}: frozen parameters moved: {moved[:4]}")
        if name == "cosmos-locked":
            check(len(seen["frozen"]) > 0, "the locked run froze nothing")
            check(seen["last_differs"] and seen["first_equal"],
                  "--init-last-layer: the student's and teacher's last "
                  "blocks are redrawn apart, the first stays the copy")
            check(len(record["evals"]) == 1 and record["evals"][0]["K1"] > 0
                  and all(v == 0 for k, v in record["evals"][0].items()
                          if k != "K1"), f"one eval, K1 only: "
                  f"{record['evals']}")
            for prefix in ("", "ema_"):
                v = metrics.get(prefix + "coco_image_to_text_R@1")
                check(v is not None and 0.0 <= v <= 1.0,
                      f"{prefix}coco_image_to_text_R@1 = {v}")
        else:
            check(not record["evals"], f"{name}: no eval")
        step_ms = float(np.mean(stats["step_ms"][1:]))
        samples = TRAINER_BATCH * accum
        windows = [line["samples_per_s"] for line in logged
                   if line["step"] > 0]
        runs[name] = dict(
            flags=flags, accum_freq=accum, launches_per_step=want,
            launches={k: v * OPTIONS_STEPS for k, v in want.items()},
            losses=losses, step_ms=stats["step_ms"],
            step_ms_mean=step_ms, samples_per_step=samples,
            samples_per_s=samples / step_ms * 1e3,
            window_samples_per_s=windows, peak_mem_gb=peak_gb,
            frozen_tensors=len(seen["frozen"]), wall_s=wall_s,
            evals=record["evals"])
        del seen, student, params
        torch.cuda.empty_cache()
        print(f"[options] {name}: {step_ms:.3f} ms/step (CUDA events, steps "
              f"2+), {samples / step_ms * 1e3:.1f} samples/s ({samples} a "
              f"step), peak memory {peak_gb:.2f} GB; losses "
              + " ".join(f"{x:.5f}" for x in losses)
              + f"; K1/K2 per step {want['K1']}/{want['K2']}; wall "
              f"{wall_s:.1f} s")
    launches = read_launches(K)
    want_all = {k: sum(r["launches_per_step"][k] for r in runs.values())
                * OPTIONS_STEPS for k in launches}
    evals_k1 = sum(e["K1"] for r in runs.values() for e in r["evals"])
    want_all["K1"] += evals_k1
    check(launches == want_all, f"phase 15 launches {launches}, expected "
          f"{want_all}")
    print(f"[options] {card}: beside phase 12's step "
          f"{trainer_record['step_ms_mean']:.3f} ms (COSMOS, no option); "
          f"launches {launches}; phase {time.perf_counter() - t_phase:.1f} s")
    return dict(kernel_rows=rows, kernel_bwd_rows=bwd_rows,
                card_vs_cpu=card_vs_cpu, runs=runs, launches=launches,
                eval_k1=evals_k1, phase_s=time.perf_counter() - t_phase)


# phase 17: the trainer's last flags (a CSV of image rows, --remote-sync,
# --profile-steps, --trace) and the FLOPs/params profiler
CSV_ROWS = 256                  # one pass an epoch: TRAINER_STEPS x 64
CSV_SIZES = (256, 400)          # the seeded JPEGs' width and height
LAST_FLAGS_EPOCHS = 2
LAST_PROFILE_STEPS = 2
SYNC_EVERY_S = 2
TRACE_F32_BATCH = 8
# the loaded programs against the live model on the same inputs, the same
# kernels on both sides, so rounding at most: float32 unit-norm features
# 1e-5; amp (bfloat16 compute, features rounded to bfloat16) two bfloat16
# ulps of a unit-norm component, 2**-7, since a matmul algorithm that
# another process picks may move one rounding inside a tower
TRACE_TOL = {"fp32": 1e-5, "amp": 2.0 ** -7}
# plain ViT-B-16 at batch 1, worked out from its shapes (tests/
# test_torch_profiler.py works them out again)
PROFILER_ROW = {"mparams": 149.62, "image_mparams": 86.19,
                "text_mparams": 63.43, "gflops": 41.09, "image_gflops": 35.13,
                "text_gflops": 5.96}
# host us per call of the K3 and K4 wrappers before they were registered
# operators (PERF.md, kernel table: PR 6's final run, phase 9, the vision
# globals in bfloat16)
HOST_US_BEFORE = {"K3": 37.3, "K4": 48.6}

_TRACED_CHILD = r"""
import json, sys, torch
# float32 as the parent computes it: no TF32 in matmuls or convolutions
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
sys.path.insert(0, sys.argv[1])
from cosmos_tpu_torch.models.trace import load_traced
from cosmos_tpu_torch.ops import fused_attention as fa
out = {}
for case, path in json.loads(sys.argv[2]).items():
    encoders = load_traced(path)
    inputs = torch.load(path + "/inputs.pt")
    feats, launches = {}, {}
    for name, x in inputs.items():
        before = fa.launches
        feats[name] = encoders[name](x.cuda()).cpu()
        torch.cuda.synchronize()
        launches[name] = fa.launches - before
    torch.save(feats, path + "/features.pt")
    out[case] = launches
print(json.dumps(out))
"""


def _trace_kernels(path: str) -> dict:
    """Kernel events of a Chrome trace by kernel (K1, K2's two passes)."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    count = lambda frag: sum(frag in n for n in names)
    return {"kernels": len(names), "K1": count("fused_attention_fwd_kernel"),
            "K2 rows": count("attention_bwd_rows_kernel"),
            "K2 cols": count("attention_bwd_cols_kernel")}


def _last_flags_run(K, argv, record, seen):
    """One main([...]) run with the step counted and, before the first
    step, a copy of the student (the weights --trace exported)."""
    from cosmos_tpu_torch.training import main as trainer

    def inspect(state, batch):
        if "initial" not in seen:
            seen["initial"] = copy.deepcopy(state.student).eval()

    zero_launches(K)
    t0 = time.perf_counter()
    with _instrumented_trainer(K, record, profiled=(), inspect=inspect):
        metrics = trainer.main(argv)
    return metrics, read_launches(K), time.perf_counter() - t0


def _traced_live(model, batch, seed):
    """Seeded images and tokens of ``batch`` rows (on the CPU) and the live
    model's normalised features on them (no gradient)."""
    gen = torch.Generator().manual_seed(seed)
    size = model.cfg.vision_cfg.image_size
    inputs = {"encode_image": torch.rand(batch, size, size, 3, generator=gen),
              "encode_text": torch.from_numpy(_captions(batch, 77, seed))}
    with torch.no_grad():
        live = {"encode_image": model.encode_image(
                    inputs["encode_image"].cuda(), True)["image_features"],
                "encode_text": model.encode_text(
                    inputs["encode_text"].cuda(), True)["text_features"]}
    return inputs, {k: v.float().cpu() for k, v in live.items()}


def _registration_host_us(K, rounds: int = 3) -> dict:
    """Host us per call (200 enqueued) of K1, K3 and K4 through their
    operators (the wrapper, and the autograd Function under grad), beside
    the CUDA implementation called without the dispatcher and the ctypes
    call alone, at K1's serving geometry and K3/K4's vision globals in
    bfloat16: ``rounds`` rounds of every route in turn, the median of each
    route and every round's figure."""
    fa, ln = K.fa, K.ln
    gen = torch.Generator(device="cuda").manual_seed(17)
    _, b, l, d3, heads, causal = GEOMETRIES[0]
    qkv = torch.randn(b, l, d3, device="cuda", generator=gen).bfloat16()
    qkv_grad = qkv.clone().requires_grad_(True)
    out = torch.empty(b, l, d3 // 3, device="cuda", dtype=torch.bfloat16)
    index = torch.cuda.current_device()
    k1_call = lambda: fa._function()(
        qkv.data_ptr(), out.data_ptr(), b, l, heads, d3 // 3 // heads, 1,
        int(causal), torch._C._cuda_getCurrentRawStream(index))
    _, rb, rl, d = LN_GEOMETRIES[0]
    x = torch.randn(rb, rl, d, device="cuda", generator=gen).bfloat16()
    g = torch.randn(rb, rl, d, device="cuda", generator=gen).bfloat16()
    s, sh = torch.ones(d, device="cuda"), torch.zeros(d, device="cuda")
    x_grad = x.clone().requires_grad_(True)
    y, mean, rstd = ln.layer_norm_fwd(x, s, sh)
    r = rb * rl
    stats = torch.empty(2, r, device="cuda")
    fwd_geo = ln.launch_geometry(r, d, x.dtype)
    bwd_geo = ln.launch_geometry(r, d, x.dtype, True)
    dx = torch.empty_like(x)
    work = torch.empty(2 * d * (1 + bwd_geo.blocks), device="cuda")
    dev = x.device
    routes = {
        "K1": {"operator": lambda: fa.fused_attention_qkv(qkv, heads,
                                                           causal),
               "without the dispatcher": lambda: fa._fwd_cuda(qkv, heads,
                                                              causal),
               "ctypes call alone": k1_call,
               "autograd Function under grad": lambda:
                   fa.fused_attention_qkv(qkv_grad, heads, causal)},
        "K3": {"operator": lambda: ln.layer_norm_fwd(x, s, sh),
               "without the dispatcher": lambda: ln._fwd_cuda(x, s, sh,
                                                              1e-5),
               "ctypes call alone": lambda: ln.call_on(
                   dev, ln._function(), ln._FWD_ARGS.pack, x.data_ptr(),
                   s.data_ptr(), sh.data_ptr(), y.data_ptr(),
                   stats.data_ptr(), stats.data_ptr() + 4 * r, r, d, 1e-5,
                   1, fwd_geo.rows_per_block, fwd_geo.blocks),
               "autograd Function under grad": lambda:
                   ln.fused_layer_norm(x_grad, s, sh)},
        "K4": {"operator": lambda: ln.layer_norm_bwd(x, s, mean, rstd, g),
               "without the dispatcher": lambda: ln._bwd_cuda(
                   x, s, mean, rstd, g),
               "ctypes call alone": lambda: ln.call_on(
                   dev, ln._function_bwd(), ln._BWD_ARGS.pack, x.data_ptr(),
                   g.data_ptr(), s.data_ptr(), mean.data_ptr(),
                   rstd.data_ptr(), dx.data_ptr(), work.data_ptr() + 8 * d,
                   work.data_ptr(), r, d, 1, *bwd_geo)}}
    taken = {k: {name: [] for name in row} for k, row in routes.items()}
    for _ in range(rounds):
        for k, row in routes.items():
            for name, fn in row.items():
                if name.startswith("autograd"):
                    taken[k][name].append(host_us(fn))
                else:
                    with torch.no_grad():
                        taken[k][name].append(host_us(fn))
    rows = {k: {name: float(np.median(v)) for name, v in row.items()}
            for k, row in taken.items()}
    for k, before in HOST_US_BEFORE.items():
        rows[k]["before registration (PERF.md, PR 6)"] = before
    for k, row in rows.items():
        print(f"[last-flags] {k} host us per call (median of {rounds} "
              "rounds): " + "; ".join(f"{name} {v:.2f}"
                                      for name, v in row.items()))
    return dict(median=rows, rounds=taken)


def phase_last_flags(K, card: str, default_step_ms: float, tmp: str):
    """Phase 17: python -m cosmos_tpu_torch.training.main at full width
    (ViT-B-16 COSMOS, train_cc3m.sh's flags, batch 64) on a CSV of seeded
    JPEG rows under --dataset-type auto, with --profile-steps 2, --trace,
    --remote-sync <tmp>/remote --remote-sync-protocol fsspec and
    --save-most-recent, 2 epochs of 4 steps; the exported encoders loaded
    and run in a fresh process against the live model; the profiler's
    rows of plain and COSMOS ViT-B-16 with K1 running; the host cost of a
    call through the registered operators."""
    import os

    from cosmos_tpu_torch.data.synthetic import write_csv
    from cosmos_tpu_torch.models.factory import create_model, get_tokenizer
    from cosmos_tpu_torch.models.trace import save_traced, trace_model
    from cosmos_tpu_torch.training import profiler
    from cosmos_tpu_torch.training.data_pipeline import get_data
    from cosmos_tpu_torch.training.params import parse_args

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    csv_path = write_csv(f"{tmp}/csv", CSV_ROWS, seed=17, fmt="jpg",
                         sep=",", size_range=CSV_SIZES)
    data_s = time.perf_counter() - t0
    logs, remote = f"{tmp}/logs", f"{tmp}/remote"
    base = _drop_flags(
        _trainer_argv(tmp, logs, 1),
        values=("--val-data", "--val-num-samples", "--steps-per-epoch",
                "--dataset-type", "--train-data", "--train-num-samples",
                "--data-root-dir", "--workers", "--name"))
    argv = base + [
        "--dataset-type", "auto", "--train-data", csv_path,
        "--csv-separator", ",", "--workers", "0",
        "--steps-per-epoch", str(TRAINER_STEPS), "--val-frequency", "0"]
    run_argv = argv + [
        "--name", "last-flags", "--epochs", str(LAST_FLAGS_EPOCHS),
        "--profile-steps", str(LAST_PROFILE_STEPS), "--trace",
        "--remote-sync", remote, "--remote-sync-protocol", "fsspec",
        "--remote-sync-frequency", str(SYNC_EVERY_S), "--save-most-recent"]
    record = {"steps": [], "evals": [], "profiles": {}}
    seen = {}
    metrics, launches, wall_s = _last_flags_run(K, run_argv, record, seen)
    run_dir = Path(logs) / "last-flags"

    # the steps and their launches; the export, on fake tensors, none
    stats = metrics["train_epoch_stats"]
    losses = [line["loss"] for s in stats for line in s["logged"]]
    steps = LAST_FLAGS_EPOCHS * TRAINER_STEPS
    check(len(losses) == steps and all(np.isfinite(losses)),
          f"a finite loss at every step: {losses}")
    per_step = step_launches(None, 12, TRAINER_BATCH, bucketed=False)
    want = {k: (v if k in ("K1", "K2") else 0) for k, v in per_step.items()}
    check(len(record["steps"]) == steps, "steps counted")
    for i, got in enumerate(record["steps"]):
        check(got == want, f"step {i}: launches {got}, expected {want}")
    check(launches == {k: steps * v for k, v in want.items()},
          f"launches of the run {launches}: the steps' only (the export "
          "launches none)")

    # the remote holds each epoch's checkpoint, byte for byte, and no
    # epoch_latest
    ckpts = run_dir / "checkpoints"
    local = sorted(p.name for p in ckpts.iterdir())
    synced = sorted(p.name for p in Path(remote).iterdir())
    check("epoch_latest.pt" in local, f"--save-most-recent: {local}")
    for e in range(1, LAST_FLAGS_EPOCHS + 1):
        name = f"epoch_{e}.pt"
        check(name in synced and filecmp.cmp(ckpts / name,
                                             Path(remote) / name,
                                             shallow=False),
              f"{name} synced byte for byte: remote holds {synced}")
    check(synced == [f"epoch_{e}.pt"
                     for e in range(1, LAST_FLAGS_EPOCHS + 1)],
          f"the remote holds {synced}: no epoch_latest and no checkpoint "
          "in writing (*.tmp)")

    # the profile: the first steps' K1 and K2 kernels, re-captured once
    # where CUPTI gave a trace without them
    trace_path = run_dir / "profile" / "rank0.trace.json"
    trace = _trace_kernels(str(trace_path))
    recaptured = False
    if not (trace["K1"] and trace["K2 rows"]):
        print(f"[last-flags] the profile holds {trace}: re-captured once")
        recaptured = True
        again = argv + ["--name", "last-flags-profile", "--epochs", "1",
                        "--profile-steps", str(LAST_PROFILE_STEPS)]
        _last_flags_run(K, again, {"steps": [], "evals": [],
                                   "profiles": {}}, {})
        trace = _trace_kernels(
            f"{logs}/last-flags-profile/profile/rank0.trace.json")
    check(trace["K1"] > 0 and trace["K2 rows"] > 0 and trace["K2 cols"] > 0,
          f"K1 and K2 kernel events in the profile: {trace}")
    trace["derived"] = {"K1": LAST_PROFILE_STEPS * want["K1"],
                        "K2": LAST_PROFILE_STEPS * want["K2"]}

    # the exported encoders (amp, batch 64, the initial weights) and a
    # float32 export, in a fresh process
    t0 = time.perf_counter()
    f32 = create_model("ViT-B-16", "fp32", device="cuda", seed=17,
                       **COSMOS)
    save_traced(trace_model(f32, batch_size=TRACE_F32_BATCH),
                f"{tmp}/traced_fp32")
    export_f32_s = time.perf_counter() - t0
    cases = {"amp": (seen["initial"], TRAINER_BATCH,
                     str(run_dir / "traced")),
             "fp32": (f32, TRACE_F32_BATCH, f"{tmp}/traced_fp32")}
    live = {}
    for case, (model, batch, path) in cases.items():
        inputs, live[case] = _traced_live(model, batch, seed=5)
        torch.save(inputs, f"{path}/inputs.pt")
    del f32, seen["initial"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", _TRACED_CHILD, str(ROOT),
         json.dumps({c: p for c, (_, _, p) in cases.items()})],
        capture_output=True, text=True, timeout=300)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"the .pt2 process failed:\n{proc.stderr}")
    child_launches = json.loads(proc.stdout.strip().splitlines()[-1])
    traced = {}
    for case, (_, _, path) in cases.items():
        feats = torch.load(f"{path}/features.pt")
        for name in ("encode_image", "encode_text"):
            err = (feats[name].float() - live[case][name]).abs().max().item()
            check(child_launches[case][name] == 12,
                  f"{case} {name}: {child_launches[case][name]} K1 "
                  "launches in the loaded program, expected 12")
            check(err <= TRACE_TOL[case],
                  f"{case} {name}: loaded against live max err {err}")
            traced[f"{case} {name}"] = dict(
                max_abs_err=err, tol=TRACE_TOL[case],
                k1_launches=child_launches[case][name])
    print("[last-flags] exported encoders in a fresh process, against the "
          "live model (bound: 1e-5 float32, 2**-7 amp): "
          + "; ".join(f"{k} max err {v['max_abs_err']:.3g}, K1 "
                      f"{v['k1_launches']}" for k, v in traced.items())
          + f"; process {child_s:.1f} s")

    # the profiler on the card: K1 runs during the count
    rows, profiler_k1 = {}, {}
    for label, extra_flags in (("plain", []), ("cosmos", [
            "--cosmos", "--output-all", "--attentional-pool"])):
        before = K.fa.launches
        (row,) = profiler.main(["--model", "ViT-B-16", *extra_flags])
        profiler_k1[label] = K.fa.launches - before
        rows[label] = row
        check(profiler_k1[label] == 24,
              f"profiler {label}: {profiler_k1[label]} K1 launches, "
              "expected 12 a tower call")
    for k, v in PROFILER_ROW.items():
        check(rows["plain"][k] == v,
              f"profiler plain ViT-B-16 {k} {rows['plain'][k]}, expected {v}")

    host = _registration_host_us(K)

    # the CSV loader alone (inline decode) and the step
    args = parse_args(argv + ["--epochs", "1"])
    loader = get_data(args, get_tokenizer("ViT-B-16"))["train"].dataloader
    it = iter(loader)
    next(it)
    t0 = time.perf_counter()
    for _ in range(2):
        next(it)
    loader_sps = 2 * TRAINER_BATCH / (time.perf_counter() - t0)
    step_ms = [ms for e, s in enumerate(stats)
               for i, ms in enumerate(s["step_ms"])
               if i > 0 and e * TRAINER_STEPS + i >= LAST_PROFILE_STEPS]
    out = dict(
        csv_rows=CSV_ROWS, data_write_s=data_s, wall_s=wall_s,
        losses=losses, launches=launches, launches_per_step=want,
        remote=synced, profile_trace=trace,
        profile_recaptured=recaptured, traced=traced,
        traced_k1_launches=child_launches, export_f32_s=export_f32_s,
        profiler_rows=rows, profiler_k1=profiler_k1, host_us=host,
        step_ms=step_ms, step_ms_mean=float(np.mean(step_ms)),
        default_step_ms=default_step_ms,
        csv_loader_samples_per_s=loader_sps,
        phase_s=time.perf_counter() - t_phase)
    print(f"[last-flags] {card}: ms per step {out['step_ms_mean']:.3f} "
          f"(CUDA events, the unprofiled steps 2+ of each epoch; phase 7's "
          f"default step {default_step_ms:.3f}); CSV loader alone "
          f"{loader_sps:.1f} samples/s (inline decode); losses "
          + " ".join(f"{x:.5f}" for x in losses))
    print(f"[last-flags] remote {synced}; profile "
          f"{trace}{' (re-captured)' if recaptured else ''}; profiler "
          f"plain {rows['plain']}; cosmos {rows['cosmos']}; K1 during the "
          f"counts {profiler_k1}; launches {launches}; phase "
          f"{out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == [DP_RANK_FLAG]:
        return dp_rank(sys.argv[2], sys.argv[3:])
    from cosmos_tpu_torch.ops import build as kernel_build

    K = _kernel_modules()
    fa, ln, lm, mb = K.fa, K.ln, K.lm, K.mb
    t0 = time.perf_counter()
    card = phase_card()
    build_s = phase_build(kernel_build, (fa, ln, lm, mb))
    host_floor = phase_host_floor(K)
    rows = phase_kernel(fa)
    serving = phase_serving(fa, rows)
    card_vs_cpu = phase_card_vs_cpu(fa)
    bwd_rows, function_errs = phase_kernel_bwd(fa)
    ragged = phase_ragged(fa)
    train = phase_train(K, bwd_rows)
    train_card_vs_cpu = phase_train_card_vs_cpu(K)
    ln_rows = phase_ln_kernels(K)
    ln_ragged = phase_ln_ragged(K)
    train_ln = phase_train_ln(K, train)
    train_ln_card_vs_cpu = {s: phase_train_card_vs_cpu(K, s)
                            for s in LN_SETTINGS}
    with tempfile.TemporaryDirectory(prefix="cosmos_trainer_") as work:
        trainer = phase_trainer(K, work)
        with tempfile.TemporaryDirectory(prefix="cosmos_evals_") as tmp:
            ckpt = _eval_checkpoint(f"{tmp}/vit_b_16_cosmos.pt")
            classification = phase_classification(K, ckpt)
            segmentation = phase_segmentation(K, ckpt)
        options = phase_trainer_options(K, card, trainer, work)
        data_parallel = phase_data_parallel(K, trainer["data_dir"], work)
    with tempfile.TemporaryDirectory(prefix="cosmos_last_flags_") as tmp:
        last = phase_last_flags(K, card, train["step_ms"], tmp)
    seg_k1 = sum(r["launches"]["K1"] for r in segmentation["runs"].values())
    dp_k1 = (data_parallel["world1"]["launches"]["K1"]
             + data_parallel["world1"]["eval_k1"])
    # phase 17: the CSV trainer's steps, the exported encoders (in their
    # own process) and the profiler's counts
    last_k1 = {"last flags trainer": last["launches"]["K1"],
               "exported encoders": sum(
                   n for case in last["traced_k1_launches"].values()
                   for n in case.values()),
               "profiler": sum(last["profiler_k1"].values())}

    def pick(table, geometry, **match):
        label, dtype = geometry
        return next(r for r in table if (r["label"], r["dtype"]) == (
            label, str(dtype).replace("torch.", ""))
            and all(r.get(k) == v for k, v in match.items()))

    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "dtype")
    attention_keys = keys + ("x_bound", "x_library")
    k1_row, k2_row = pick(rows, MAIN_GEOMETRY), pick(bwd_rows, TRAIN_MAIN)
    kernels = [{
        "name": "fused_attention_qkv_fwd",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_fwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:101",
        # the main paths' runs: serving (phase 4), training (phases 7, 10),
        # the trainer (phase 12: its steps and evals), the classification
        # and segmentation evals (phases 13, 14), the trainer's options and
        # modes (phase 15: its steps and eval), the trainer in one process
        # and at world 1 under torchrun (phase 16(a): steps and evals), the
        # CSV trainer, the exported encoders and the profiler (phase 17)
        "launches": serving["launches"] + train["k1_launches"] + sum(
            r["launches"]["K1"] for r in train_ln.values())
        + trainer["launches"]["K1"] + classification["launches"]["K1"]
        + seg_k1 + options["launches"]["K1"] + dp_k1
        + sum(last_k1.values()),
        "launches_by_path": {"serving": serving["launches"],
                             "training": train["k1_launches"],
                             **{f"training {s}": r["launches"]["K1"]
                                for s, r in train_ln.items()},
                             "trainer": trainer["launches"]["K1"],
                             "classification":
                                 classification["launches"]["K1"],
                             "segmentation": seg_k1,
                             "trainer options": options["launches"]["K1"],
                             "data parallel": dp_k1, **last_k1},
        **{k: k1_row[k] for k in attention_keys},
    }, {
        "name": "fused_attention_qkv_bwd",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_bwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:190",
        "launches": train["k2_launches"] + sum(
            r["launches"]["K2"] for r in train_ln.values())
        + trainer["launches"]["K2"] + options["launches"]["K2"]
        + data_parallel["world1"]["launches"]["K2"]
        + last["launches"]["K2"],
        "launches_by_path": {"training": train["k2_launches"],
                             **{f"training {s}": r["launches"]["K2"]
                                for s, r in train_ln.items()},
                             "trainer": trainer["launches"]["K2"],
                             "trainer options": options["launches"]["K2"],
                             "data parallel":
                                 data_parallel["world1"]["launches"]["K2"],
                             "last flags trainer": last["launches"]["K2"]},
        **{k: k2_row[k] for k in attention_keys},
    }]
    for key, name, source, replaces, match in (
            ("K3", "layer_norm_fwd", "layer_norm_fwd.cu",
             "cosmos_tpu/ops/experimental/layer_norm.py:40", {}),
            ("K4", "layer_norm_bwd", "layer_norm_bwd.cu",
             "cosmos_tpu/ops/experimental/layer_norm.py:57", {}),
            ("K5", "ln_matmul_fwd", "ln_matmul.cu",
             "cosmos_tpu/ops/experimental/ln_matmul.py:59", {}),
            ("K6", "mlp_block_fwd", "mlp_block.cu",
             "cosmos_tpu/ops/experimental/mlp_block.py:70",
             {"act": "gelu_tanh"})):
        row = pick(ln_rows, LN_MAIN, kernel=key, **match)
        by_path = {f"training {s}": r["launches"][key]
                   for s, r in train_ln.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cosmos_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            **{k: row[k] for k in keys + ("x_bound", "x_library")},
            **{k: row[k] for k in ("device_ms", "device_ms_by",
                                   "device_events_ms", "host_us",
                                   "library_device_ms", "library_host_us")
               if k in row}})
        check(kernels[-1]["launches"] > 0, f"{key} never launched")
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, kernel_rows=rows,
                  serving=serving, card_vs_cpu=card_vs_cpu,
                  kernel_bwd_rows=bwd_rows, function_card_vs_cpu=function_errs,
                  ragged=ragged,
                  train=train, train_card_vs_cpu=train_card_vs_cpu,
                  ln_kernel_rows=ln_rows, ln_ragged=ln_ragged,
                  host_floor=host_floor,
                  train_ln=train_ln,
                  train_ln_card_vs_cpu=train_ln_card_vs_cpu,
                  trainer=trainer, classification=classification,
                  segmentation=segmentation, trainer_options=options,
                  data_parallel=data_parallel, last_flags=last,
                  total_s=time.perf_counter() - t0, kernels=kernels)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(f"[done] {record['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
