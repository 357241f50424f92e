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
     shards and flags, 1 epoch of 2 steps) for plain CLIP (--accum-freq 2
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
     flags and shards, one loader thread, 1 epoch of 2 steps and then
     --resume latest into a second, beside the same two runs in this
     process without a process group; checks that the logged metrics of
     every step and epoch_2.pt (student, teacher, optimizer state) are the
     same bits, the exact K1/K2 launches of every step (phase 12's), K1
     only in the evals; prints ms per step of both and the ms of the step's
     cross-rank mean of the gradients; (b) takes 3 steps of make_train_step
     (COSMOS, float32, full width, GLOO_LAYERS blocks a tower) at world
     2, 32 rows a rank,
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
     7's and the CSV loader's samples/s;
 18. the timm-family towers and ModifiedResNet, random weights from seeds
     at full width and depth: K1 and K2 held to their plain versions at
     the text geometries the towers add (D 640 with 10 heads, a head group
     of 2; D 768 with 12); (a) serving for EVA02-B-16, EVA02-L-14,
     convnext_base_w, convnext_large_d and MobileCLIP-S1/S2/B in bfloat16,
     encode_image at batch 64 and the config's image size, encode_text at
     batch 256 and length 77: images/s, captions/s, peak memory and the
     exact K1 launches of each call (12 a text call, 16 for
     convnext_large_d; 12 a MobileCLIP-B image call, 0 for the other image
     towers); (b) the same float32 weights on the card and on the CPU at
     batch 2, the normalised features within 1e-4, for the seven configs
     and OpenAI's RN50 geometry (registered at run time); (c) main([...])
     with phase 12's shards and flags in plain CLIP mode, no local crops,
     on EVA02-B-16 and MobileCLIP-B: an epoch of 4 steps with val and COCO
     retrieval evals and a checkpoint, then --resume latest for a second,
     the exact K1/K2 launches of every step (12/12 and 24/24), ms per step
     and peak memory; and one convnext_base_w step through
     make_train_step at batch 64 (K1/K2 12/12).

 19. beyond data parallelism: (a) the COSMOS step under FSDP at world 1 on
     NCCL (a process group of this one rank) against the plain step from
     the same weights and batch, 3 steps at 2 layers in float32 (losses
     within 1e-6 relative) and 7 at full width in bfloat16 at batch 64
     (within phase 7's 1e-3), the exact K1/K2 launches of every step,
     median ms a step and peak memory of both; then main([...]) with phase
     16(a)'s flags and --fsdp, an epoch with the val eval and a gathered
     checkpoint, and --resume latest into a second; (b)-(c) two ranks on
     this card under gloo over CUDA tensors, after a probe of the
     collectives gloo takes on them (a part whose collectives it refuses
     is left out and printed with gloo's error): (b) on a (1, 2) mesh the
     tensor-parallel encoders of ViT-B-16 COSMOS (full width, GLOO_LAYERS
     blocks a tower) in float32 against the unsharded ones (1e-4), K1 on
     every block, and one TP step against the
     plain step (16(b)'s tolerances); (c) 2 steps on a 2-slice mesh
     (--num-slices 2 --gather-scope global) against the flat world-2
     step.
 20. weights in: K1 held to its plain version and timed at ViT-L-14's
     geometry [64, 257, 3072] (16 heads) in both dtypes; (a) ViT-L-14 from
     an OpenAI-layout TorchScript archive of float16 weights from a seed,
     through load_openai_model (QuickGELU, the file's weights in float32),
     served in bfloat16 (64 images at 224 px, 256 captions at 77: 24 K1
     launches an image call, 12 a text call) and 2 images / 4 captions
     card against CPU in float32 (1e-4); (b) the trainer's eval-only
     retrieval of ViT-B-16 COSMOS from the cosmos_cc3m tag, its file phase
     12's last checkpoint in a COSMOS_TPU_CACHE directory, at
     --force-image-size 336 (K1 at L 442), with the position table's
     difference from a float64 numpy bicubic resize (1e-6); (c)
     MobileCLIP-S2 from random weights under Apple's train-form names
     (written here), through the datacompdr tag and the fusing converter,
     with the registry's identity mean/std and bilinear resize, served and
     compared as in (a); (d) int8_matmul at [64*197, 768] x [768, 3072]
     bit for bit against the CPU's exact product, and ViT-B-16 COSMOS
     served from int8-quantized, dequantized weights (relative error
     against the float weights, card against CPU).
 21. CoCa at coca_ViT-B-32's full width (ViT-B-32 at width 768, 256 pooler
     queries, text and decoder at 512), random weights from a seed: K1 and
     K2 held to their plain versions and timed at its vision geometry
     [64, 50, 2304] (12 heads) in both dtypes, and K1's gate checked there;
     (a) encode_image at batch 64 and encode_text at 256 x 76 in bfloat16
     (12 K1 launches an image call, none a text call: the CLS text tower
     is masked, so plain, as in JAX) and evaluate_retrieval over 512
     images and 2560 captions; (b) 2 images and 4 captions card against
     CPU in float32, the features and the decoder's logits within 1e-5;
     (c) greedy, top-k, top-p and 6-beam generation on 16 images at 30
     tokens in bfloat16 (tokens/s, 12 K1 a call), and float32 greedy
     tokens of 2 images on the CPU with the card's logits along them
     (1e-5) and the share of equal tokens; (d) the CoCa step at batch 64
     in bfloat16 on one fixed uint8 batch, 3 + 10 steps with CUDA events
     a step (median, mean, samples/s, peak memory), exactly 12 K1 and 12
     K2 a step and a falling loss, then a 2-layer float32 step at batch 2
     against the CPU (1e-4 relative); (e) main([...]) with --model
     coca_ViT-B-32 on phase 12's shards (one crop, one caption), 2 epochs
     of 2 steps with the val and COCO retrieval evals and a checkpoint,
     then --resume latest for a third, K1 12 a vision-tower call and K2
     12 a step.
 22. the sharded modes complete: (a) K5 held to its plain version at the
     column shards tensor parallelism gives it ([R, 768] x [1152, 768],
     [576, 768], [R, 512] x [384, 512]; R = 1, 63, 65, 7392) in both
     dtypes with the same bits on a repeat, K5 at those shards and K6 at
     its hidden shard (D 768, HD 1536, b2 zeros) timed at R = 25216 in
     bf16 beside the plain version, the stock composition and the bound,
     and K5 at O = 2304 and 1536 holding the bits of the kernel before its
     width gate was widened (K5_PRE_BITS); (c) coca_ViT-B-32's step at
     batch 64 in bf16 under FSDP at world 1 on NCCL against the plain step
     (the same losses and student to the bit, 12/12 K1/K2 a step), then
     main([...]) with phase 21's flags and --fsdp, an epoch of 2 steps and
     a gathered checkpoint, then --resume latest into a second with the
     val eval; (b) on a (1, 2) mesh of two gloo ranks on this card,
     fuse_ln with FUSED_LN under tensor parallelism: ViT-B-16 COSMOS at
     full width (SLICE16_LAYERS blocks a tower) in bf16 on 4 rows, 1 + 2
     steps, the one-process step's
     K1-K6 launches a step on each rank (K5 and K6 on the rank's shards),
     the losses within FUSE_TP_LOSS_RTOL of the one-process step's, ms a
     step and peak memory a rank; and the 2-layer float32 step against
     the CPU (phase 8's tolerances); (d) on the same ranks coca_ViT-B-32's
     TP encoders in float32 against the unsharded features (1e-4; 12 K1 an
     image call, none a text call) and its 2-layer float32 step against
     the unsharded step (16(b)'s AdamW and tolerances).
 23. the last surface that needs no download.  Before phase 12: (a) the
     native data path (cosmos_tpu_torch/data/csrc/tario.cpp, threaded tar
     streaming and DCT-scaled libjpeg decode) built with g++, timed, with
     the compiler, headers and libjpeg named; every trainer from phase 12
     on reads through it.  Then: (e) K1 and K2 held to their plain
     versions, with the same bits on a repeat, and timed beside SDPA and
     the bound at ViT-B-16-SigLIP's geometries (vision [64, 196, 2304],
     no CLS token; text [256, 64, 2304] for K1 and [64, 64, 2304] for K2,
     no causal mask; 12 heads) in both dtypes; (b) 96 JPEGs of short side
     1024-1600 px: ms a sample of PIL's decode, the native decode at the
     loader's DCT scale and the multi-crop transform on each, and the
     native decode at 1/1 against PIL's bits; (c) the trainer's loader
     alone, native and PIL, on phase 12's shards and on (b)'s; (d)
     ViT-B-16-SigLIP from a big_vision npz of random float32 weights
     (written here) through create_model(pretrained=...), timed; served
     in bfloat16 (64 images, 256 captions at 64 tokens: 12 K1 a call
     each); 2 + 8 --siglip steps at batch 64 in bf16 (24/24 K1/K2 a step,
     median ms, peak memory); a 2-layer float32 model's features and
     --siglip step against the CPU.

With ``--dp-rank OUT <trainer flags>`` the script is phase 16(a)'s rank
and nothing else.  With ``--k5-against DIR`` it builds K5 from the
``ln_matmul.cu`` of the checkout in DIR (such as the parent commit, from
``git archive``) and compares it with this one's (``k5_against``), and
nothing else.  Any failed check raises, so the script exits non-zero.  The last lines are
the card's name and power limit, one JSON object with the kernel records,
and {"ok": true, "device": {...}}.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import filecmp
import json
import shutil
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
DP_STEPS = 2            # steps an epoch in 16(a)
DP_WORLD = 2
DP_BATCH = 32           # rows a rank in 16(b)
# blocks a tower of the models on gloo ranks and their references (16(b),
# 19(b)-(c)): cut from 12 to keep the script within its time limit
GLOO_LAYERS = 2
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

    def timed(tensors, group=None):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        mean(tensors, group=group)
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
    """16(b)'s and 19(b)-(c)'s model: ViT-B-16 at full width, GLOO_LAYERS
    blocks a tower."""
    from cosmos_tpu_torch import create_model

    kw = (dict(act_approx=True, init_logit_scale=float(np.log(10.0)),
               init_logit_bias=-10.0) if siglip else TRAIN_RECIPE)
    return create_model("ViT-B-16", "fp32", device=device, seed=7,
                        vision_layers=GLOO_LAYERS, text_layers=GLOO_LAYERS,
                        **kw)


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
    from cosmos_tpu_torch.models.checkpoint import read_checkpoint
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
            sd = read_checkpoint(f"{ckpt_dir}/epoch_{epoch}.pt", which)
            model.load_state_dict(sd, strict=True)
            for name in ("logit_scale", "distill_logit_scale"):
                v = float(sd[name])
                check(0.0 <= v <= LN100,
                      f"epoch {epoch} {which} {name} = {v}")
    del model
    torch.cuda.empty_cache()
    # the last epoch's checkpoint stays as phase 20's cached cosmos_cc3m
    # file; the other 5 GB of checkpoints go, the shards stay for phase 15
    cache = f"{tmp}/weights_cache"
    Path(cache).mkdir(exist_ok=True)
    shutil.move(f"{ckpt_dir}/epoch_3.pt", f"{cache}/cosmos_vitb16_cc3m.pt")
    shutil.rmtree(logs)

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
OPTIONS_STEPS = 2
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


# phase 18: the timm-family towers and ModifiedResNet at full width
TOWER_CONFIGS = ("EVA02-B-16", "EVA02-L-14", "convnext_base_w",
                 "convnext_large_d", "MobileCLIP-S1", "MobileCLIP-S2",
                 "MobileCLIP-B")
TOWER_IMAGE_BATCH, TOWER_TEXT_BATCH = 64, 256
TOWER_TIMED_CALLS = 5
TOWER_SEED = 18
# OpenAI's RN50 geometry (OpenCLIP's RN50.json), registered at run time
RN50_NAME = "RN50"
RN50_CONFIG = {"embed_dim": 1024,
               "vision_cfg": {"image_size": 224, "layers": [3, 4, 6, 3],
                              "width": 64},
               "text_cfg": {"context_length": 77, "vocab_size": 49408,
                            "width": 512, "heads": 8, "layers": 12}}
# float32 on both sides, TF32 off: the normalised features (|x| < 1)
TOWER_CPU_TOL = 1e-4
# the trainer runs of 18(c): phase 12's shards and flags, plain CLIP, no
# local crops, TRAINER_STEPS steps an epoch, then --resume latest for one
TOWER_TRAINER_MODELS = ("EVA02-B-16", "MobileCLIP-B")
# K1 at the text geometries the towers add (serving, batch 256, and the
# trainer's 2 caption views of 64) and K2 at their training geometry
TOWER_K1_GEOMETRIES = [
    ("text D640 H10 (convnext_base_w)", 256, 77, 3 * 640, 10, True),
    ("text D768 H12 (EVA02-L-14)", 256, 77, 3 * 768, 12, True),
]
TOWER_K2_GEOMETRIES = [
    ("text D640 H10 (convnext_base_w)", 128, 77, 3 * 640, 10, True),
]


def tower_call_launches(name: str) -> dict:
    """K1 launches per encode_text and per encode_image call of a tower
    config: one per self-attention block that takes the kernel route (the
    text blocks; a timm ViT trunk's blocks; no other tower's attention)."""
    from cosmos_tpu_torch.models.config import build_clip_cfg
    from cosmos_tpu_torch.models.timm_model import TIMM_VIT_CONFIGS

    cfg = build_clip_cfg(name)
    trunk = TIMM_VIT_CONFIGS.get(cfg.vision_cfg.timm_model_name or "", {})
    return {"text": cfg.text_cfg.layers, "image": trunk.get("layers", 0)}


def _counted(fn, calls):
    def run(*a):
        calls.append(1)
        return fn(*a)
    return run


def _tower_serving(K, name: str) -> dict:
    """18(a) and (b) for one config: float32 weights from the seed, the
    card against the CPU at batch 2, then the same weights in bfloat16 on
    the card: images/s at batch 64, captions/s at batch 256 and length 77,
    peak memory and the K1 launches of each call."""
    from cosmos_tpu_torch.models.factory import create_model

    t0 = time.perf_counter()
    cpu = create_model(name, "fp32", device="cpu", seed=TOWER_SEED)
    size = cpu.cfg.vision_cfg.image_size
    rng = np.random.default_rng(TOWER_SEED)
    x = torch.from_numpy(rng.standard_normal((2, size, size, 3))
                         .astype(np.float32))
    toks = torch.from_numpy(_captions(2, 77, seed=TOWER_SEED))

    def features(model, device):
        with torch.inference_mode():
            return (model.encode_image(x.to(device), True)["image_features"],
                    model.encode_text(toks.to(device), True)["text_features"])

    want = features(cpu, "cpu")
    card = copy.deepcopy(cpu).to("cuda")
    got = features(card, "cuda")
    errs = {}
    for what, g, w in zip(("image", "text"), got, want):
        g = g.cpu()
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"{name} {what} features shape/finite")
        errs[what] = (g - w).abs().max().item()
        check(errs[what] <= TOWER_CPU_TOL,
              f"{name} card vs CPU {what}: max err {errs[what]}")
    del card
    out = dict(card_vs_cpu=errs, tol=TOWER_CPU_TOL)
    if name == RN50_NAME:
        del cpu
        out["phase_s"] = time.perf_counter() - t0
        return out

    model = create_model(name, "bf16", device="meta")
    model.load_state_dict(cpu.state_dict(), assign=True)
    model = model.to("cuda").eval()
    del cpu
    per_call = tower_call_launches(name)
    gen = torch.Generator(device="cuda").manual_seed(TOWER_SEED)
    images = torch.randn(TOWER_IMAGE_BATCH, size, size, 3, device="cuda",
                         generator=gen)
    captions = torch.as_tensor(_captions(TOWER_TEXT_BATCH, 77,
                                         seed=TOWER_SEED), device="cuda")
    img_calls, txt_calls = [], []

    @torch.inference_mode()
    def enc_img():
        return model.encode_image(images, True)["image_features"]

    @torch.inference_mode()
    def enc_txt():
        return model.encode_text(captions, True)["text_features"]

    enc_img, enc_txt = _counted(enc_img, img_calls), _counted(enc_txt,
                                                              txt_calls)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launches = {}
    for what, fn in (("image", enc_img), ("text", enc_txt)):
        zero_launches(K)
        feats = fn()
        torch.cuda.synchronize()
        got = read_launches(K)
        check(got == {**dict.fromkeys(got, 0), "K1": per_call[what]},
              f"{name} encode_{what}: launches {got}, expected K1 "
              f"{per_call[what]} only")
        check(torch.isfinite(feats).all().item(), f"{name} {what} finite")
        launches[what] = got["K1"]
    zero_launches(K)
    img_ms = time_ms(enc_img, iters=TOWER_TIMED_CALLS)
    txt_ms = time_ms(enc_txt, iters=TOWER_TIMED_CALLS)
    timed = read_launches(K)
    check(timed["K1"] == per_call["image"] * (len(img_calls) - 1)
          + per_call["text"] * (len(txt_calls) - 1),
          f"{name}: K1 launches of the timed calls {timed}")
    out.update(
        k1_per_call=launches,
        k1_launches=per_call["image"] * len(img_calls)
        + per_call["text"] * len(txt_calls),
        image_size=size, image_call_ms=img_ms, text_call_ms=txt_ms,
        images_per_s=TOWER_IMAGE_BATCH / img_ms * 1e3,
        captions_per_s=TOWER_TEXT_BATCH / txt_ms * 1e3,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
        phase_s=time.perf_counter() - t0)
    del model, images
    torch.cuda.empty_cache()
    return out


def _tower_trainer(K, name: str, data: str, workers: int, logs: str
                   ) -> dict:
    """18(c): the trainer at full width on a tower config, plain CLIP in
    bfloat16 (amp) on phase 12's shards: an epoch of TRAINER_STEPS steps
    with val and COCO retrieval evals and a checkpoint, then --resume
    latest for a second; the exact K1/K2 launches of every step."""
    from cosmos_tpu_torch.training import main as trainer

    per_call = tower_call_launches(name)
    # the student's image and caption calls with a gradient, once a step
    want = {**dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0),
            "K1": per_call["image"] + per_call["text"],
            "K2": per_call["image"] + per_call["text"]}
    argv = _drop_flags(_trainer_argv(data, logs, workers),
                       values=("--model", "--local-crops-number", "--name"),
                       switches=("--cosmos", "--output-all",
                                 "--attentional-pool"))
    argv += ["--model", name, "--local-crops-number", "0", "--name", name]
    record = {"steps": [], "evals": [], "profiles": {}}
    zero_launches(K)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _instrumented_trainer(K, record, profiled=()):
        run1 = trainer.main(argv + ["--epochs", "1"])
        run2 = trainer.main(argv + ["--epochs", "2", "--resume", "latest"])
    wall_s = time.perf_counter() - t0
    launches = read_launches(K)
    epochs = run1["train_epoch_stats"] + run2["train_epoch_stats"]
    check([s["epoch"] for s in epochs] == [0, 1],
          f"{name}: epochs run {[s['epoch'] for s in epochs]}")
    losses = [line["loss"] for s in epochs for line in s["logged"]]
    check(len(losses) == 2 * TRAINER_STEPS and all(np.isfinite(losses)),
          f"{name}: a finite loss at every step: {losses}")
    check(len(record["steps"]) == 2 * TRAINER_STEPS, f"{name}: steps")
    for i, got in enumerate(record["steps"]):
        check(got == want, f"{name} step {i}: launches {got}, expected "
              f"{want}")
    check(len(record["evals"]) == 2, f"{name}: one eval an epoch")
    for got in record["evals"]:
        check(got["K1"] > 0 and all(got[k] == 0 for k in got if k != "K1"),
              f"{name}: an eval launches K1 only: {got}")
    for prefix in ("", "ema_"):
        for key in ("clip_val_loss", "coco_image_to_text_R@1",
                    "coco_text_to_image_R@10"):
            v = run2.get(prefix + key)
            check(v is not None and np.isfinite(v), f"{prefix}{key}: {v}")
    step_ms = [ms for s in epochs for ms in s["step_ms"][1:]]
    out = dict(launches=launches, launches_per_step=want,
               eval_launches=record["evals"], losses=losses,
               step_ms=step_ms, step_ms_mean=float(np.mean(step_ms)),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               eval_s=[s["eval_s"] for s in epochs], wall_s=wall_s,
               metrics={k: v for k, v in run2.items()
                        if isinstance(v, (int, float))})
    print(f"[towers] trainer {name}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; ms per step (CUDA "
          f"events, steps 2+ of each epoch) {out['step_ms_mean']:.3f}; "
          f"peak memory {out['peak_mem_gb']:.2f} GB; K1/K2 per step "
          f"{want['K1']}/{want['K2']}; evals "
          + ", ".join(f"{s:.2f} s" for s in out["eval_s"])
          + f"; wall {wall_s:.1f} s")
    shutil.rmtree(f"{logs}/{name}")
    return out


def _convnext_step(K) -> dict:
    """18(c): one plain-CLIP step of convnext_base_w through
    make_train_step at full width, batch 64, bfloat16: its text tower is
    D 640 with 10 heads, K1 and K2 at a head group of 2."""
    from cosmos_tpu_torch import (create_model, create_optimizer,
                                  create_train_state, make_train_step)
    from cosmos_tpu_torch.ops import fused_attention as fa
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import TrainStepConfig

    check(fa.supported(10, 640, 77, 2), "K1's gate refuses D 640 / H 10")
    b = TRAINER_BATCH
    model = create_model("convnext_base_w", "amp", device="cuda",
                         seed=TOWER_SEED).train()
    lr = const_lr(1e-4, 0, 10)
    opt = create_optimizer(model, lr)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt, TrainStepConfig(
        cosmos=False, lr_schedule=lr, input_dtype=torch.bfloat16))
    rng = np.random.default_rng(TOWER_SEED)
    batch = {"global_images": torch.from_numpy(rng.integers(
        0, 256, (2, b, 256, 256, 3), np.uint8)).cuda(),
        "texts": torch.from_numpy(_captions(2 * b, 77, seed=TOWER_SEED)
                                  .reshape(2, b, 77)).cuda()}
    torch.cuda.reset_peak_memory_stats()
    zero_launches(K)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    metrics = step(state, batch)
    end.record()
    end.synchronize()
    launches = read_launches(K)
    want = {**dict.fromkeys(launches, 0), "K1": 12, "K2": 12}
    check(launches == want, f"convnext_base_w step: launches {launches}, "
          f"expected {want}")
    loss = float(metrics["loss"])
    check(np.isfinite(loss), f"convnext_base_w step loss {loss}")
    out = dict(launches=launches, loss=loss,
               step_ms=start.elapsed_time(end),
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[towers] convnext_base_w make_train_step: loss {loss:.5f}, "
          f"first step {out['step_ms']:.1f} ms, peak memory "
          f"{out['peak_mem_gb']:.2f} GB, launches {launches}")
    del model, state, opt, step, batch
    torch.cuda.empty_cache()
    return out


def phase_towers(K, data: str, workers: int, tmp: str) -> dict:
    """Phase 18: the timm-family towers and ModifiedResNet at full width,
    random weights from seeds: (a) serving and (b) card against CPU for the
    seven shipped tower configs (and RN50 for (b)), K1/K2 held to their
    plain versions at the new text geometries, (c) the trainer on
    EVA02-B-16 and MobileCLIP-B and one convnext_base_w step."""
    from cosmos_tpu_torch.models import config as pconfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    path = Path(tmp) / f"{RN50_NAME}.json"
    path.write_text(json.dumps(RN50_CONFIG))
    pconfig.add_model_config(path)
    for name, want in (("EVA02-B-16", (0, 12)), ("EVA02-L-14", (0, 12)),
                       ("convnext_base_w", (0, 12)),
                       ("convnext_large_d", (0, 16)),
                       ("MobileCLIP-S1", (0, 12)), ("MobileCLIP-S2", (0, 12)),
                       ("MobileCLIP-B", (12, 12))):
        got = tower_call_launches(name)
        check((got["image"], got["text"]) == want,
              f"{name}: K1 per call {got}, expected {want}")
    gen = torch.Generator(device="cuda").manual_seed(TOWER_SEED)
    k1_rows = [kernel_row(K.fa, label, b, l, d3, heads, causal,
                          torch.bfloat16, gen)
               for label, b, l, d3, heads, causal in TOWER_K1_GEOMETRIES]
    k2_rows = [kernel_bwd_row(K.fa, label, b, l, d3, heads, causal,
                              torch.bfloat16, gen)
               for label, b, l, d3, heads, causal in TOWER_K2_GEOMETRIES]
    serving = {name: _tower_serving(K, name)
               for name in TOWER_CONFIGS + (RN50_NAME,)}
    for name, r in serving.items():
        line = (f"[towers] {name}: card vs CPU max abs err image "
                f"{r['card_vs_cpu']['image']:.3g} text "
                f"{r['card_vs_cpu']['text']:.3g} (tolerance {r['tol']})")
        if "images_per_s" in r:
            line += (f"; {r['images_per_s']:.1f} images/s (batch "
                     f"{TOWER_IMAGE_BATCH}, {r['image_size']} px), "
                     f"{r['captions_per_s']:.1f} captions/s (batch "
                     f"{TOWER_TEXT_BATCH}, L 77), peak "
                     f"{r['peak_mem_gb']:.2f} GB, K1 per call image "
                     f"{r['k1_per_call']['image']} text "
                     f"{r['k1_per_call']['text']}")
        print(line + f"; {r['phase_s']:.1f} s")
    trainer = {name: _tower_trainer(K, name, data, workers, f"{tmp}/logs")
               for name in TOWER_TRAINER_MODELS}
    step = _convnext_step(K)
    out = dict(
        k1_rows=k1_rows, k2_rows=k2_rows, serving=serving, trainer=trainer,
        convnext_step=step,
        k1_launches={
            "towers serving": sum(r.get("k1_launches", 0)
                                  for r in serving.values()),
            "towers trainer": sum(t["launches"]["K1"]
                                  for t in trainer.values()),
            "towers convnext step": step["launches"]["K1"]},
        k2_launches={
            "towers trainer": sum(t["launches"]["K2"]
                                  for t in trainer.values()),
            "towers convnext step": step["launches"]["K2"]},
        phase_s=time.perf_counter() - t_phase)
    print(f"[towers] phase {out['phase_s']:.1f} s")
    return out


# phase 19: beyond data parallelism.  (a) FSDP at world 1 on NCCL against
# the plain step and the trainer under --fsdp; (b) tensor parallelism on a
# (1, 2) mesh and (c) the multislice gather at world 2, both ranks on this
# card under gloo over CUDA tensors
BEYOND_SMALL_STEPS = 3       # 19(a)'s 2-layer float32 steps
BEYOND_STEPS = (2, 5)        # 19(a)'s full-width warm-up and timed steps
BEYOND_LOSS_RTOL = 1e-6      # 19(a) in float32
BEYOND_BF16_ATOL = 1e-3      # 19(a) in bfloat16: phase 7's tolerance
BEYOND_WORLD = 2
BEYOND_TP_BATCH = 16         # rows of 19(b)'s step, whole on both ranks
BEYOND_ENC = (16, 64)        # 19(b)'s images and captions
BEYOND_ENC_TOL = 1e-4        # 19(b)'s features against the unsharded
# gloo's collectives on CUDA tensors, probed and printed before 19(b)-(c):
# DTensor's redistributions (tensor parallelism, through
# _sync_functional_collectives) need the middle three, the losses' list
# gather (multislice) all_gather, all_reduce and broadcast; SigLIP's ring
# would need send/recv.  19(b)-(c) run whatever the probe prints, and fail
# where a collective they call is refused.
GLOO_PROBES = ("all_gather", "all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "broadcast", "send_recv")


def _gspmd_setup(model, lr, dtype, mesh=None, fsdp=False, eps=1e-8,
                 mode=None):
    """The recipe's step (phase 7's, without --local-loss, which the GSPMD
    step refuses; ``mode``: other TrainStepConfig flags, such as CoCa's,
    in place of ``cosmos=True``): make_train_step without ``mesh``, else
    make_train_step_gspmd over FSDP (``fsdp``) or tensor parallelism."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training import train as tr

    def make_opt(m):
        return create_optimizer(m, lr, beta1=0.9, beta2=0.98, eps=eps,
                                weight_decay=0.5)

    cfg = tr.TrainStepConfig(momentum_teacher=0.999, fix_momentum=True,
                             lr_schedule=lr, input_dtype=dtype,
                             log_grad_norm=True,
                             **(mode or dict(cosmos=True)))
    if mesh is None:
        opt = make_opt(model)
        return make_train_step(model, opt, cfg), create_train_state(model,
                                                                    opt)
    create = tr.create_train_state_fsdp if fsdp else \
        tr.create_train_state_gspmd
    state = create(model, make_opt, mesh)
    return tr.make_train_step_gspmd(model, state.optimizer, mesh, cfg), state


def _timed_steps(K, step, state, batch, warmup: int, timed: int) -> dict:
    """``warmup`` + ``timed`` steps on one batch: the losses, K1-K6
    launches of every step, ms a step (CUDA events) and this process's peak
    memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, launches, ms = [], [], []
    for i in range(warmup + timed):
        zero_launches(K)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch)
        end.record()
        losses.append(m["loss"].item())
        launches.append(read_launches(K))
        if i >= warmup:
            ms.append(start.elapsed_time(end))
    return dict(losses=losses, launches=launches, step_ms=ms,
                step_ms_median=float(np.median(ms)),
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def _fsdp_run(K, fsdp: bool, layers: int, dtype, b: int, warmup: int,
              timed: int) -> dict:
    """``warmup`` + ``timed`` steps of the recipe from seed 0's weights on
    one batch: plain, or under FSDP at world 1 on NCCL (a process group of
    this one rank); the losses, K1/K2 launches a step, step ms (CUDA
    events) and peak memory; under FSDP, the count of parameters FSDP
    shards, after a check that it leaves out exactly the leaves JAX's rule
    keeps replicated (``fsdp_placements``)."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.parallel import distributed
    from cosmos_tpu_torch.parallel.fsdp import (fsdp_placements,
                                                is_fsdp_managed)
    from cosmos_tpu_torch.parallel.mesh import create_mesh
    from cosmos_tpu_torch.training.scheduler import cosine_lr

    if fsdp:
        distributed.init_distributed(None, alone=True)
    try:
        model = create_model(
            "ViT-B-16", "fp32" if dtype == torch.float32 else "bf16",
            device="cuda", seed=0, vision_layers=layers, text_layers=layers,
            **TRAIN_RECIPE)
        lr = cosine_lr(5e-4, 2000, 100000)
        replicated = {n for n, d in fsdp_placements(model, 1).items()
                      if d is None}
        step, state = _gspmd_setup(
            model, lr, dtype, create_mesh(device_type="cuda") if fsdp
            else None, fsdp)
        managed = 0
        if fsdp:
            for which in (state.student, state.teacher):
                named = dict(which.named_parameters())
                kept = {n for n, p in named.items() if not is_fsdp_managed(p)}
                check(kept == replicated and len(named) > len(kept),
                      f"19(a): FSDP leaves {sorted(kept)} whole, JAX's rule "
                      f"{sorted(replicated)}")
                managed = len(named) - len(kept)
        batch = _train_batch(b, seed=20, device="cuda")
        out = dict(_timed_steps(K, step, state, batch, warmup, timed),
                   fsdp_managed=managed)
        del model, step, state, batch
    finally:
        if fsdp:
            distributed.destroy()
    torch.cuda.empty_cache()
    return out


def _beyond_fsdp(K, data: str, tmp: str) -> dict:
    """19(a): the FSDP step against the plain step at 2 layers in float32
    and at full width in bfloat16, then main([...]) under --fsdp: an epoch
    with the val eval and a checkpoint, and --resume latest into a
    second."""
    from cosmos_tpu_torch import create_model

    res = {}
    for tag, layers, dtype, b, warmup, timed, tol in (
            ("2-layer float32", 2, torch.float32, 2, 0, BEYOND_SMALL_STEPS,
             None),
            ("full width bfloat16", 12, torch.bfloat16, 64, *BEYOND_STEPS,
             BEYOND_BF16_ATOL)):
        plain = _fsdp_run(K, False, layers, dtype, b, warmup, timed)
        fsdp = _fsdp_run(K, True, layers, dtype, b, warmup, timed)
        want = step_launches(None, layers, b)
        want = {k: (v if k in ("K1", "K2") else 0) for k, v in want.items()}
        for name, run in (("plain", plain), ("fsdp", fsdp)):
            check(all(np.isfinite(run["losses"])), f"19(a) {tag} {name}: "
                  f"losses {run['losses']}")
            check(all(got == want for got in run["launches"]),
                  f"19(a) {tag} {name}: launches {run['launches']}, "
                  f"expected {want} a step")
        errs = [abs(f - p) for f, p in zip(fsdp["losses"], plain["losses"])]
        if tol is None:
            worst = max(e / abs(p) for e, p in zip(errs, plain["losses"]))
            check(worst <= BEYOND_LOSS_RTOL, f"19(a) {tag}: FSDP losses "
                  f"{fsdp['losses']} vs plain {plain['losses']}")
        else:
            worst = max(errs)
            check(worst <= tol, f"19(a) {tag}: FSDP losses "
                  f"{fsdp['losses']} vs plain {plain['losses']}")
        res[tag] = dict(plain=plain, fsdp=fsdp, loss_err=worst,
                        launches_per_step=want)
        print(f"[beyond] (a) {tag}, batch {b}: FSDP at world 1 (NCCL) "
              f"losses {' '.join(f'{x:.7g}' for x in fsdp['losses'])}, "
              f"plain {' '.join(f'{x:.7g}' for x in plain['losses'])} "
              f"(max {'rel ' if tol is None else ''}err {worst:.3g}); "
              f"{fsdp['fsdp_managed']} parameters sharded by FSDP; "
              f"K1/K2 a step {want['K1']}/{want['K2']} both; median ms a "
              f"step FSDP {fsdp['step_ms_median']:.3f}, plain "
              f"{plain['step_ms_median']:.3f}; peak memory FSDP "
              f"{fsdp['peak_mem_gb']:.2f} GB, plain "
              f"{plain['peak_mem_gb']:.2f} GB")
    logs = f"{tmp}/beyond_fsdp"
    t0 = time.perf_counter()
    rec = _dp_trainer_runs(K, _dp_trainer_argv(data, logs) + ["--fsdp"])
    trainer_s = time.perf_counter() - t0
    per_step = step_launches(None, 12, TRAINER_BATCH, bucketed=False)
    want = {k: (v if k in ("K1", "K2") else 0) for k, v in per_step.items()}
    check(rec["epochs"] == [0, 1], f"19(a) trainer: epochs {rec['epochs']}")
    check(len(rec["steps"]) == 2 * DP_STEPS and all(
        got == want for got in rec["steps"]),
        f"19(a) trainer: launches {rec['steps']}, expected {want} a step")
    check(len(rec["evals"]) == 2 and all(e["K1"] > 0 for e in rec["evals"]),
          f"19(a) trainer: evals {rec['evals']}")
    check(all(np.isfinite(line["loss"]) for line in rec["logged"]),
          "19(a) trainer: losses")
    # the gathered checkpoint has the one-process layout, whole tensors
    ckpt = torch.load(f"{logs}/trainer/checkpoints/epoch_2.pt",
                      map_location="cpu", weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in create_model(
        "ViT-B-16", device="meta", **TRAIN_RECIPE).state_dict().items()}
    for which in ("student", "teacher"):
        check({k: tuple(v.shape) for k, v in ckpt[which].items()} == shapes,
              f"19(a) trainer: the checkpoint's {which} is not whole")
    check(len(ckpt["optimizer"]["state"]) == len(shapes)
          and ckpt["num_updates"] == 2 * DP_STEPS,
          "19(a) trainer: the checkpoint's optimizer state")
    shutil.rmtree(logs)
    res["trainer"] = dict(
        launches_per_step=want,
        launches={k: v * len(rec["steps"]) for k, v in want.items()},
        eval_k1=sum(e["K1"] for e in rec["evals"]),
        losses=[line["loss"] for line in rec["logged"]],
        step_ms=rec["step_ms"], wall_s=trainer_s)
    print(f"[beyond] (a) main([...]) --fsdp at world 1: epochs 0-1 "
          f"(resumed), losses {res['trainer']['losses']}, K1/K2 a step "
          f"{want['K1']}/{want['K2']}, ms a step {rec['step_ms']}, the "
          f"gathered epoch_2.pt whole; {trainer_s:.1f} s")
    return res


def _beyond_env(rank: int, port: int) -> None:
    import os

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(BEYOND_WORLD),
                      LOCAL_RANK="0", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _gloo_probe_rank(rank: int, spec: dict) -> None:
    """One collective of GLOO_PROBES on a CUDA tensor: 'accepted' or
    gloo's error.  A probe may abort its process (gloo raises some errors
    from a transport thread), so each runs in processes of its own, with
    their standard error kept in a file."""
    import os

    import torch.distributed as dist

    from cosmos_tpu_torch.parallel import distributed

    import faulthandler

    err = os.open(f"{spec['out']}.{rank}.stderr",
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC)
    os.dup2(err, 2)
    faulthandler.enable()
    _beyond_env(rank, spec["port"])
    distributed.init_distributed(None, backend="gloo")
    name, result = spec["probe"], "accepted"
    x = torch.full((4,), float(rank + 1), device="cuda")
    try:
        if name == "all_gather":
            dist.all_gather([torch.empty_like(x)
                             for _ in range(BEYOND_WORLD)], x)
        elif name == "all_gather_into_tensor":
            dist.all_gather_into_tensor(x.new_empty(4 * BEYOND_WORLD), x)
        elif name == "all_reduce":
            dist.all_reduce(x)
        elif name == "reduce_scatter_tensor":
            dist.reduce_scatter_tensor(x.new_empty(4 // BEYOND_WORLD), x)
        elif name == "broadcast":
            dist.broadcast(x, 0)
        else:
            ops = [dist.P2POp(dist.isend, x, 1 - rank),
                   dist.P2POp(dist.irecv, torch.empty_like(x), 1 - rank)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        torch.cuda.synchronize()
    except (RuntimeError, ValueError) as e:
        result = f"refused: {str(e).splitlines()[0][:200]}"
    torch.save(result, f"{spec['out']}.{rank}")
    distributed.destroy()


def _gloo_probes(tmp: str) -> dict:
    """Every probe of GLOO_PROBES at once, each in BEYOND_WORLD processes of
    its own: name -> 'accepted', 'refused: <gloo's error>', 'aborted:
    <the first line gloo wrote before the process died>' or 'timed out'."""
    import os
    import socket

    import torch.multiprocessing as mp

    running = {}
    for name in GLOO_PROBES:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        spec = dict(probe=name, port=port, out=f"{tmp}/probe_{name}")
        running[name] = (spec, mp.start_processes(
            _gloo_probe_rank, args=(spec,), nprocs=BEYOND_WORLD, join=False,
            start_method="spawn"))
    deadline = time.monotonic() + 120
    out = {}
    for name, (spec, ctx) in running.items():
        timed_out = True
        try:
            while time.monotonic() < deadline:
                try:
                    if ctx.join(timeout=1.0):
                        timed_out = False
                        break
                except Exception:
                    timed_out = False
                    break
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join(10)
        results = [f"{spec['out']}.{r}" for r in range(BEYOND_WORLD)]
        if all(os.path.exists(f) for f in results):
            # a refusal on either rank is the probe's (the peer of a
            # refusing rank sees its connection close)
            got = [torch.load(f, weights_only=False) for f in results]
            out[name] = next((g for g in got if g != "accepted"),
                             "accepted")
            continue
        if timed_out:
            out[name] = "timed out"
            continue
        lines = [line.strip() for r in range(BEYOND_WORLD)
                 for line in Path(f"{spec['out']}.{r}.stderr").read_text(
                     errors="replace").splitlines()
                 if "gloo" in line.lower() or "what()" in line
                 or "Fatal Python error" in line or " in wait" in line]
        lines.sort(key=lambda line: ("what()" not in line,
                                     "Fatal" not in line))
        out[name] = "aborted: " + (lines[0][:240] if lines else
                                   "no message (exit code "
                                   f"{ctx.processes[0].exitcode})")
    return out


@contextlib.contextmanager
def _sync_functional_collectives():
    """DTensor's three functional collectives (all-gather, all-reduce,
    reduce-scatter) as the synchronous c10d calls on the same group and
    layout: gloo's functional collectives on CUDA tensors crash their
    process in ``wait_tensor``, its synchronous calls take them."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN, "product": dist.ReduceOp.PRODUCT,
           "avg": dist.ReduceOp.SUM}

    def group_of(group, tag=""):
        return dist.distributed_c10d._resolve_process_group(
            funcol._resolve_group_name(group, tag))

    def all_gather_tensor(self, gather_dim, group, tag=""):
        g = group_of(group, tag)
        n = dist.get_world_size(g)
        x = self.contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=g)
        if gather_dim != 0:
            out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
        return out

    def all_reduce(self, reduceOp, group, tag=""):
        g = group_of(group, tag)
        out = self.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=ops[reduceOp.lower()], group=g)
        return out / dist.get_world_size(g) if reduceOp.lower() == "avg" \
            else out

    def reduce_scatter_tensor(self, reduceOp, scatter_dim, group, tag=""):
        g = group_of(group, tag)
        n = dist.get_world_size(g)
        x = self
        if scatter_dim != 0:
            x = torch.cat(torch.chunk(x, n, dim=scatter_dim))
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
        dist.reduce_scatter_tensor(out, x, op=ops[reduceOp.lower()], group=g)
        return out / n if reduceOp.lower() == "avg" else out

    saved = {name: getattr(funcol, name) for name in (
        "all_gather_tensor", "all_reduce", "reduce_scatter_tensor")}
    funcol.all_gather_tensor = all_gather_tensor
    funcol.all_reduce = all_reduce
    funcol.reduce_scatter_tensor = reduce_scatter_tensor
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(funcol, name, fn)


def _beyond_rank(rank: int, spec: dict) -> None:
    """19(b)-(c)'s rank: the TP encoders and one TP step on a (1, 2) mesh,
    then the step on a 2-slice mesh and the flat world-2 step, each from
    the same weights and batch."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.parallel import distributed
    from cosmos_tpu_torch.parallel.mesh import (create_multislice_mesh,
                                                create_tp_mesh)
    from cosmos_tpu_torch.parallel.tp import make_tp_encoders
    from cosmos_tpu_torch.training.scheduler import const_lr

    import faulthandler

    faulthandler.enable()
    _beyond_env(rank, spec["port"])
    K = _kernel_modules()
    distributed.init_distributed(None, backend="gloo")
    ref = torch.load(spec["ref"], map_location="cpu", weights_only=True)
    out = {}
    try:
        with _sync_functional_collectives():
            mesh = create_tp_mesh(1, BEYOND_WORLD, "cuda")
            model = create_model("ViT-B-16", "fp32", device="cuda", seed=7,
                                 vision_layers=GLOO_LAYERS,
                                 text_layers=GLOO_LAYERS, **COSMOS).eval()
            _, enc_image, enc_text = make_tp_encoders(model, mesh)
            feats, k1 = {}, {}
            for name, enc, x in (("image", enc_image, ref["images"]),
                                 ("text", enc_text, ref["texts"])):
                zero_launches(K)
                feats[name] = enc(x.cuda()).cpu()
                k1[name] = read_launches(K)["K1"]
            out["encoders"] = dict(
                k1=k1, errs={n: (feats[n] - ref[f"{n}_features"]).abs()
                             .max().item() for n in feats},
                sharded=sum(p.__class__.__name__ == "DTensor"
                            for p in model.parameters()))
            del model, enc_image, enc_text
            model = _dp_model(False, "cuda")
            step, state = _gspmd_setup(model, const_lr(DP_LR, 0, 100),
                                       torch.float32, mesh, eps=DP_EPS)
            batch = {k: v.cuda() for k, v in ref["batch"].items()}
            zero_launches(K)
            m = step(state, batch)
            launches = read_launches(K)
            whole = _gathered(state)     # rank 0's
            out["tp_step"] = dict(
                loss=m["loss"].item(), launches=launches,
                errs={w: max((whole[w][k] - ref[w][k]).abs().max().item()
                             for k in ref[w]) for w in ("student",
                                                        "teacher")}
                if rank == 0 else {})
            del model, step, state, batch, whole
            torch.cuda.empty_cache()
        runs = {}
        for name in ("flat", "multislice"):
            model = _dp_model(False, "cuda")
            mesh = (create_multislice_mesh(BEYOND_WORLD,
                                           device_type="cuda")
                    if name == "multislice" else None)
            step, state = _dp_ms_setup(model, mesh)
            batch = {k: v.cuda() for k, v in _dp_batch(rank).items()}
            zero_launches(K)
            metrics = [{k: float(v) for k, v in
                        step(state, batch).items()} for _ in range(2)]
            runs[name] = dict(metrics=metrics,
                              launches=read_launches(K),
                              digest=_state_digest(state),
                              student={k: v.cpu() for k, v in
                                       state.student.state_dict()
                                       .items()})
            del model, step, state, batch
            torch.cuda.empty_cache()
        out["multislice"] = dict(
            flat=runs["flat"]["metrics"],
            multislice=runs["multislice"]["metrics"],
            launches=runs["multislice"]["launches"],
            digests=[runs[n]["digest"] for n in ("flat", "multislice")],
            student_err=max(
                (runs["multislice"]["student"][k] - v).abs().max().item()
                for k, v in runs["flat"]["student"].items()))
    finally:
        torch.save(out, f"{spec['out']}.{rank}")
        distributed.destroy()


def _gathered(state) -> dict:
    from cosmos_tpu_torch.training.checkpoint import host_state

    return host_state(state, optimizer=False)


def _dp_ms_setup(model, mesh):
    """16(b)'s COSMOS step (local loss), over ``mesh``."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import TrainStepConfig

    lr = const_lr(DP_LR, 0, 100)
    opt = create_optimizer(model, lr, beta1=0.9, beta2=0.98, eps=DP_EPS,
                           weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.999, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True, cosmos=True,
                          local_loss=True, gather_scope="global")
    return (make_train_step(model, opt, cfg, mesh=mesh),
            create_train_state(model, opt))


def _beyond_reference(path: str) -> float:
    """19(b)'s references in this process: the unsharded encoders' features
    on seeded inputs, and one step of the recipe (no local loss) from
    16(b)'s weights on BEYOND_TP_BATCH rows; saved to ``path``."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training.scheduler import const_lr

    t0 = time.perf_counter()
    rng = np.random.default_rng(43)
    images = torch.from_numpy(rng.standard_normal(
        (BEYOND_ENC[0], 224, 224, 3)).astype(np.float32))
    texts = torch.from_numpy(_train_texts(rng, (1, BEYOND_ENC[1], 77))[0])
    model = create_model("ViT-B-16", "fp32", device="cuda", seed=7,
                         vision_layers=GLOO_LAYERS, text_layers=GLOO_LAYERS,
                         **COSMOS).eval()
    with torch.no_grad():
        img = model.encode_image(images.cuda(), normalize=True)
        txt = model.encode_text(texts.cuda(), normalize=True)
    del model
    model = _dp_model(False, "cuda")
    step, state = _gspmd_setup(model, const_lr(DP_LR, 0, 100), torch.float32,
                               eps=DP_EPS)
    batch = {k: v[:, :BEYOND_TP_BATCH] for k, v in _dp_batch().items()}
    m = step(state, {k: v.cuda() for k, v in batch.items()})
    torch.save(dict(
        images=images, texts=texts,
        image_features=img["image_features"].cpu(),
        text_features=txt["text_features"].cpu(), batch=batch,
        loss=m["loss"].item(),
        student={k: v.cpu() for k, v in state.student.state_dict().items()},
        teacher={k: v.cpu() for k, v in state.teacher.state_dict().items()}),
        path)
    del model, step, state
    torch.cuda.empty_cache()
    return time.perf_counter() - t0


def _spawn_ranks(fn, spec: dict, timeout: float) -> list:
    """``fn(rank, spec)`` in BEYOND_WORLD processes on this card; their
    saved results in rank order."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        spec = dict(spec, port=sock.getsockname()[1])
    ctx = mp.start_processes(fn, args=(spec,), nprocs=BEYOND_WORLD,
                             join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"{fn.__name__}: the ranks outlasted {timeout} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
            proc.join(10)
    return [torch.load(f"{spec['out']}.{r}", weights_only=False)
            for r in range(BEYOND_WORLD)]


def _beyond_gloo(tmp: str) -> dict:
    """19(b)-(c): print what gloo takes on CUDA tensors, then run both
    parts on two gloo ranks."""
    probe = _gloo_probes(tmp)
    print("[beyond] gloo on CUDA tensors: " + "; ".join(
        f"{k} {v}" for k, v in probe.items()))
    ref = f"{tmp}/beyond_ref.pt"
    ref_s = _beyond_reference(ref)
    t0 = time.perf_counter()
    ranks = _spawn_ranks(_beyond_rank, dict(out=f"{tmp}/beyond", ref=ref),
                         600)
    for r, got in enumerate(ranks):
        check({"encoders", "tp_step", "multislice"} <= got.keys(),
              f"19(b)-(c) rank {r}: stopped after {sorted(got)}")
    res = dict(probe=probe, ref_s=ref_s, ranks_s=time.perf_counter() - t0,
               k1_launches=0, k2_launches=0)
    enc = [r["encoders"] for r in ranks]
    step = [r["tp_step"] for r in ranks]
    want_step = step_launches(None, GLOO_LAYERS, BEYOND_TP_BATCH)
    for r, (e, s) in enumerate(zip(enc, step)):
        check(e["k1"] == {"image": GLOO_LAYERS, "text": GLOO_LAYERS},
              f"19(b) rank {r}: K1 per TP encoder call {e['k1']}, expected "
              f"{GLOO_LAYERS} (every block)")
        check(max(e["errs"].values()) <= BEYOND_ENC_TOL, f"19(b) rank "
              f"{r}: TP features off the unsharded {e['errs']}")
        check(e["sharded"] > 0, f"19(b) rank {r}: no sharded weight")
        check(all(s["launches"][k] == want_step[k] for k in ("K1", "K2")),
              f"19(b) rank {r}: TP step launches {s['launches']}, "
              f"expected {want_step}")
        check(abs(s["loss"] - torch.load(ref)["loss"])
              <= DP_LOSS_RTOL * abs(s["loss"]),
              f"19(b) rank {r}: TP loss {s['loss']}")
        for which, err in s["errs"].items():
            check(err <= DP_WEIGHT_ATOL, f"19(b) rank {r}: updated "
                  f"{which} max err {err} against the DP step")
    res["tp"] = dict(encoders=enc, step=step)
    res["k1_launches"] += sum(sum(e["k1"].values()) + s["launches"]["K1"]
                              for e, s in zip(enc, step))
    res["k2_launches"] += sum(s["launches"]["K2"] for s in step)
    print(f"[beyond] (b) TP on a (1, 2) mesh, ViT-B-16 COSMOS float32: "
          f"encoders ({BEYOND_ENC[0]} images, {BEYOND_ENC[1]} captions) "
          f"max abs err {[e['errs'] for e in enc]}, K1 per call "
          f"{enc[0]['k1']} on each rank; one step on {BEYOND_TP_BATCH} "
          f"rows: loss {step[0]['loss']:.7f}, updated student/teacher "
          f"err {[s['errs'] for s in step]}, K1/K2 "
          f"{step[0]['launches']['K1']}/{step[0]['launches']['K2']}")
    ms = [r["multislice"] for r in ranks]
    for r, m in enumerate(ms):
        for a, b in zip(m["multislice"], m["flat"]):
            check(abs(a["loss"] - b["loss"]) <= DP_LOSS_RTOL
                  * abs(b["loss"]), f"19(c) rank {r}: 2-slice loss "
                  f"{a['loss']}, flat {b['loss']}")
        check(m["student_err"] <= DP_WEIGHT_ATOL, f"19(c) rank {r}: "
              f"student after 2 steps off the flat step's by "
              f"{m['student_err']}")
    check(ms[0]["digests"][1] == ms[1]["digests"][1],
          "19(c): the ranks hold other bits after the 2-slice steps")
    res["multislice"] = ms
    res["k1_launches"] += sum(m["launches"]["K1"] for m in ms)
    res["k2_launches"] += sum(m["launches"]["K2"] for m in ms)
    print(f"[beyond] (c) --num-slices {BEYOND_WORLD} --gather-scope "
          f"global at world {BEYOND_WORLD} ({DP_BATCH} rows a rank): "
          f"losses {[x['loss'] for x in ms[0]['multislice']]}, flat "
          f"{[x['loss'] for x in ms[0]['flat']]}, student max err "
          f"{max(m['student_err'] for m in ms):.3g}; same bits on both "
          f"ranks; the bits of the flat step: "
          f"{ms[0]['digests'][0] == ms[0]['digests'][1]}")
    return res


def phase_beyond_dp(K, data: str, tmp: str) -> dict:
    """Phase 19: FSDP, tensor parallelism and the multislice gather."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fsdp = _beyond_fsdp(K, data, tmp)
    gloo = _beyond_gloo(tmp)
    out = dict(fsdp=fsdp, gloo=gloo, phase_s=time.perf_counter() - t_phase)
    print(f"[beyond] phase {out['phase_s']:.1f} s")
    return out



# phase 20: weights in.  ViT-L-14 from an OpenAI-layout TorchScript archive
# (64 images, 256 captions in bfloat16; 2 images, 4 captions card against
# CPU in float32), the trainer's eval from a cached tag at 336 px, MobileCLIP-S2
# from Apple's train-form layout through its registry tag, and the int8 ops
WEIGHTS_SEED = 20
WEIGHTS_IMAGES, WEIGHTS_CAPTIONS = 64, 256
WEIGHTS_CPU = (2, 4)
WEIGHTS_CPU_TOL = 1e-4
L14_GEOMETRY = ("vision ViT-L-14 224px", 64, 257, 3 * 1024, 16, False)
L14_CALL_K1 = {"image": 24, "text": 12}
MC_CALL_K1 = {"image": 0, "text": 12}
B16_CALL_K1 = {"image": 12, "text": 12}
TAG_IMAGE_SIZE = 336
INT8_SHAPE = (64 * 197, 768, 3072)          # rows, K, N: ViT-B-16's c_fc
POS_RESIZE_TOL = 1e-6


class _Tree(torch.nn.Module):
    pass


class _Archive(torch.nn.Module):
    """Named tensors in a scripted module, as OpenAI's release archives
    hold them: its ``state_dict()`` has the file's keys."""

    def __init__(self, sd):
        super().__init__()
        for key, value in sd.items():
            *mods, leaf = key.split(".")
            m = self
            for name in mods:
                if not hasattr(m, name):
                    m.add_module(name, _Tree())
                m = getattr(m, name)
            m.register_buffer(leaf, value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


def apple_mobileclip_state_dict(layers, dims, text, embed_dim, seed,
                                ratio=3) -> dict:
    """Random weights from ``seed`` under Apple's MobileCLIP train-form
    names and shapes (ml-mobileclip's image_encoder.model.* MCi trunk of
    MobileOne branches and text_encoder.* base transformer): conv weights
    with std fan_in ** -0.5, BatchNorm statistics with positive variances,
    small layer scales.  ``text`` holds width, layers, context_length and
    vocab_size."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(key, *shape, std=None, value=None):
        if value is not None:
            sd[key] = torch.tensor(value)
            return
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        scale = std if std is not None else fan_in ** -0.5
        sd[key] = torch.from_numpy(
            (rng.standard_normal(shape) * scale).astype(np.float32))

    def bn(p, c):
        put(f"{p}.weight", c, std=0.1)
        sd[f"{p}.weight"] += 1.0
        put(f"{p}.bias", c, std=0.1)
        put(f"{p}.running_mean", c, std=0.1)
        sd[f"{p}.running_var"] = torch.from_numpy(
            (rng.random(c) + 0.5).astype(np.float32))
        put(f"{p}.num_batches_tracked", value=0)

    def conv_bn(p, cin, cout, k, groups):
        put(f"{p}.conv.weight", cout, cin // groups, k, k)
        bn(f"{p}.bn", cout)

    def mobileone(p, cin, cout, k, stride=1, groups=1, branches=1,
                  scale=True):
        for j in range(branches):
            conv_bn(f"{p}.rbr_conv.{j}", cin, cout, k, groups)
        if k > 1 and scale:
            conv_bn(f"{p}.rbr_scale", cin, cout, 1, groups)
        if cin == cout and stride == 1:
            bn(f"{p}.rbr_skip", cin)

    img = "image_encoder.model."
    d0 = dims[0]
    mobileone(f"{img}patch_embed.0", 3, d0, 3, stride=2)
    mobileone(f"{img}patch_embed.1", d0, d0, 3, stride=2, groups=d0)
    mobileone(f"{img}patch_embed.2", d0, d0, 1)
    idx = 0
    for s, (depth, dim) in enumerate(zip(layers, dims)):
        hidden = dim * ratio
        if s == 3:
            put(f"{img}network.{idx}.pe.weight", dim, 1, 7, 7)
            put(f"{img}network.{idx}.pe.bias", dim, std=0.02)
            idx += 1
        for b in range(depth):
            p = f"{img}network.{idx}.{b}"
            if s < 3:
                mobileone(f"{p}.token_mixer.norm", dim, dim, 3, groups=dim,
                          branches=0, scale=False)
                mobileone(f"{p}.token_mixer.mixer", dim, dim, 3, groups=dim)
                put(f"{p}.token_mixer.layer_scale", dim, 1, 1, std=0.02)
                put(f"{p}.layer_scale", dim, 1, 1, std=0.02)
            else:
                bn(f"{p}.norm", dim)
                put(f"{p}.token_mixer.qkv.weight", 3 * dim, dim)
                put(f"{p}.token_mixer.proj.weight", dim, dim)
                put(f"{p}.token_mixer.proj.bias", dim, std=0.02)
                put(f"{p}.layer_scale_1", dim, 1, 1, std=0.02)
                put(f"{p}.layer_scale_2", dim, 1, 1, std=0.02)
            conv_bn(f"{p}.convffn.conv", dim, dim, 7, dim)
            put(f"{p}.convffn.fc1.weight", hidden, dim, 1, 1)
            put(f"{p}.convffn.fc1.bias", hidden, std=0.02)
            put(f"{p}.convffn.fc2.weight", dim, hidden, 1, 1)
            put(f"{p}.convffn.fc2.bias", dim, std=0.02)
        idx += 1
        if s < 3:
            p = f"{img}network.{idx}.proj"
            conv_bn(f"{p}.0.lkb_origin", dim, dims[s + 1], 7, dim)
            conv_bn(f"{p}.0.small_conv", dim, dims[s + 1], 3, dim)
            mobileone(f"{p}.1", dims[s + 1], dims[s + 1], 1)
            idx += 1
    final = 2 * dims[-1]
    rd = max(1, int(final / 16))
    mobileone(f"{img}conv_exp", dims[-1], final, 3, groups=dims[-1])
    put(f"{img}conv_exp.se.reduce.weight", rd, final, 1, 1)
    put(f"{img}conv_exp.se.reduce.bias", rd, std=0.02)
    put(f"{img}conv_exp.se.expand.weight", final, rd, 1, 1)
    put(f"{img}conv_exp.se.expand.bias", final, std=0.02)
    put(f"{img}head.proj", final, embed_dim, std=final ** -0.5)

    txt, w = "text_encoder.", text["width"]
    put(f"{txt}embedding_layer.weight", text["vocab_size"], w, std=0.02)
    put(f"{txt}positional_embedding.pos_embed.pos_embed", 1,
        text["context_length"], w, std=0.01)
    for i in range(text["layers"]):
        p = f"{txt}transformer.{i}"
        for ln in ("pre_norm_mha.0", "pre_norm_ffn.0"):
            put(f"{p}.{ln}.weight", w, std=0.02)
            sd[f"{p}.{ln}.weight"] += 1.0
            put(f"{p}.{ln}.bias", w, std=0.02)
        put(f"{p}.pre_norm_mha.1.qkv_proj.weight", 3 * w, w)
        put(f"{p}.pre_norm_mha.1.qkv_proj.bias", 3 * w, std=0.02)
        put(f"{p}.pre_norm_mha.1.out_proj.weight", w, w)
        put(f"{p}.pre_norm_mha.1.out_proj.bias", w, std=0.02)
        put(f"{p}.pre_norm_ffn.1.weight", 4 * w, w)
        put(f"{p}.pre_norm_ffn.1.bias", 4 * w, std=0.02)
        put(f"{p}.pre_norm_ffn.4.weight", w, 4 * w)
        put(f"{p}.pre_norm_ffn.4.bias", w, std=0.02)
    put(f"{txt}final_layer_norm.weight", w, std=0.02)
    sd[f"{txt}final_layer_norm.weight"] += 1.0
    put(f"{txt}final_layer_norm.bias", w, std=0.02)
    put(f"{txt}projection_layer", w, embed_dim, std=w ** -0.5)
    put("logit_scale", value=float(np.log(1 / 0.07)))
    return sd


def bicubic_resize_np(pe: np.ndarray, src: int, dst: int) -> np.ndarray:
    """The [1 + src**2, D] position table at dst x dst in float64 numpy:
    F.interpolate's bicubic (a = -0.75, align_corners=False, border taps
    replicated) as one matrix per axis, the JAX package's construction."""
    def matrix(n_in, n_out):
        a, m = -0.75, np.zeros((n_out, n_in))
        for i in range(n_out):
            x = (i + 0.5) * (n_in / n_out) - 0.5
            f = np.floor(x)
            for k in range(-1, 3):
                t = abs(x - (f + k))
                w = ((a + 2) * t ** 3 - (a + 3) * t ** 2 + 1 if t <= 1 else
                     a * t ** 3 - 5 * a * t ** 2 + 8 * a * t - 4 * a
                     if t < 2 else 0.0)
                m[i, int(np.clip(f + k, 0, n_in - 1))] += w
        return m

    grid = pe[1:].astype(np.float64).reshape(src, src, -1)
    mh = matrix(src, dst)
    out = np.einsum("ah,hwd,bw->abd", mh, grid, mh).reshape(dst * dst, -1)
    return np.concatenate([pe[:1].astype(np.float64), out])


def _weights_serve(K, model, size, per_call, label, seed, length=77,
                   tag="weights", captions=None):
    """bfloat16 serving of ``model``: the exact K1 launches of an image
    call of WEIGHTS_IMAGES and a text call of WEIGHTS_CAPTIONS at
    ``length`` (``captions``: those token ids, else BPE-shaped ones), then
    timed calls; returns the record and the K1 launches of every call
    made."""
    from cosmos_tpu_torch.training.evaluate import make_encoders

    gen = torch.Generator(device="cuda").manual_seed(seed)
    images = torch.randn(WEIGHTS_IMAGES, size, size, 3, device="cuda",
                         generator=gen)
    if captions is None:
        captions = _captions(WEIGHTS_CAPTIONS, length, seed=seed)
    captions = torch.as_tensor(captions, device="cuda")
    calls = {"image": [], "text": []}
    enc_image, enc_text, _ = make_encoders(model)
    fns = {"image": _counted(lambda: enc_image(images), calls["image"]),
           "text": _counted(lambda: enc_text(captions), calls["text"])}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for what, fn in fns.items():
        zero_launches(K)
        feats = fn()
        torch.cuda.synchronize()
        got = read_launches(K)
        check(got == {**dict.fromkeys(got, 0), "K1": per_call[what]},
              f"{label} encode_{what}: launches {got}, expected K1 "
              f"{per_call[what]} only")
        check(torch.isfinite(feats).all().item(), f"{label} {what} finite")
    zero_launches(K)
    img_ms = time_ms(fns["image"], iters=TOWER_TIMED_CALLS)
    txt_ms = time_ms(fns["text"], iters=TOWER_TIMED_CALLS)
    timed = read_launches(K)["K1"]
    check(timed == sum(per_call[w] * (len(calls[w]) - 1) for w in calls),
          f"{label}: K1 launches of the timed calls {timed}")
    k1 = {w: per_call[w] * len(calls[w]) for w in calls}
    out = dict(image_call_ms=img_ms, text_call_ms=txt_ms,
               images_per_s=WEIGHTS_IMAGES / img_ms * 1e3,
               captions_per_s=WEIGHTS_CAPTIONS / txt_ms * 1e3,
               k1_per_call=per_call, k1_launches=k1,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[{tag}] {label}: {out['images_per_s']:.1f} images/s "
          f"({WEIGHTS_IMAGES} at {size} px, bf16), "
          f"{out['captions_per_s']:.1f} captions/s ({WEIGHTS_CAPTIONS} at "
          f"{length}), K1 {per_call['image']} an image call and "
          f"{per_call['text']} a text call, peak {out['peak_mem_gb']:.2f} GB")
    return out, sum(k1.values())


def _weights_card_vs_cpu(cpu, label, seed, gpu=None):
    """The same float32 weights on the card and on the CPU: normalised
    features of WEIGHTS_CPU images and captions within WEIGHTS_CPU_TOL."""
    n_img, n_txt = WEIGHTS_CPU
    size = cpu.cfg.vision_cfg.image_size
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n_img, size, size, 3))
                         .astype(np.float32))
    toks = torch.from_numpy(_captions(n_txt, 77, seed=seed))
    gpu = gpu if gpu is not None else copy.deepcopy(cpu).to("cuda")

    def features(model, device):
        with torch.inference_mode():
            return (model.encode_image(x.to(device), True)["image_features"],
                    model.encode_text(toks.to(device), True)["text_features"])

    errs = {}
    for what, g, w in zip(("image", "text"), features(gpu, "cuda"),
                          features(cpu, "cpu")):
        g = g.cpu()
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"{label} {what} features shape/finite")
        errs[what] = (g - w).abs().max().item()
        check(errs[what] <= WEIGHTS_CPU_TOL,
              f"{label} card vs CPU {what}: max err {errs[what]}")
    print(f"[weights] {label} card vs CPU (float32, {n_img} images, "
          f"{n_txt} captions): max abs err image {errs['image']:.3g} "
          f"text {errs['text']:.3g}")
    return errs


def _weights_openai_l14(K, fa, tmp):
    """20(a): ViT-L-14 from an OpenAI-layout TorchScript archive of float16
    weights through load_openai_model."""
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.models.openai import load_openai_model

    t0 = time.perf_counter()
    src = create_model("ViT-L-14", "fp32", device="cpu", seed=WEIGHTS_SEED)
    sd = {k: v.half() for k, v in src.state_dict().items()}
    del src
    sd.update(input_resolution=torch.tensor(224),
              context_length=torch.tensor(77),
              vocab_size=torch.tensor(49408))
    path = f"{tmp}/ViT-L-14.pt"
    torch.jit.save(torch.jit.script(_Archive(sd)), path)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = load_openai_model(path, "bf16")
    load_s = time.perf_counter() - t0
    check(model.cfg.quick_gelu, "load_openai_model: QuickGELU")
    for k, v in model.state_dict().items():
        check(v.dtype == torch.float32 and torch.equal(
            v, sd[k].to(v.device).float()), f"ViT-L-14 {k} as in the file")
    check(fa.supported(16, 1024, 257, 2), "K1's gate admits ViT-L-14")
    serve, k1 = _weights_serve(K, model, 224, L14_CALL_K1, "ViT-L-14",
                               WEIGHTS_SEED)
    del model
    torch.cuda.empty_cache()
    cpu = load_openai_model(path, "fp32", device="cpu")
    errs = _weights_card_vs_cpu(cpu, "ViT-L-14", WEIGHTS_SEED)
    del cpu
    torch.cuda.empty_cache()
    print(f"[weights] ViT-L-14 archive: written in {write_s:.1f} s, "
          f"load_openai_model (bf16, card) {load_s:.1f} s")
    return dict(serve=serve, card_vs_cpu=errs, tol=WEIGHTS_CPU_TOL,
                write_s=write_s, load_s=load_s), k1


def _weights_trainer_tag(K, data, cache, tmp):
    """20(b): the trainer's retrieval eval from the cosmos_cc3m tag, its
    file phase 12's epoch checkpoint in the cache, at 336 px."""
    import os

    from cosmos_tpu_torch.models.checkpoint import (load_checkpoint,
                                                    read_checkpoint)
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.models.pretrained import resolve_pretrained
    from cosmos_tpu_torch.training import main as trainer

    argv = ["--logs-dir", f"{tmp}/logs", "--name", "weights_in",
            "--model", "ViT-B-16", "--precision", "amp", "--cosmos",
            "--output-all", "--attentional-pool",
            "--eval-mode", "retrieval", "--pretrained", "cosmos_cc3m",
            "--force-image-size", str(TAG_IMAGE_SIZE),
            "--data-root-dir", f"{data}/eval", "--batch-size", "64",
            "--workers", "1"]
    old = os.environ.get("COSMOS_TPU_CACHE")
    os.environ["COSMOS_TPU_CACHE"] = cache
    try:
        path = resolve_pretrained("ViT-B-16", "cosmos_cc3m")
        check(path == f"{cache}/cosmos_vitb16_cc3m.pt", f"tag -> {path}")
        zero_launches(K)
        t0 = time.perf_counter()
        metrics = trainer.main(argv)
        wall_s = time.perf_counter() - t0
        launches = read_launches(K)
    finally:
        if old is None:
            del os.environ["COSMOS_TPU_CACHE"]
        else:
            os.environ["COSMOS_TPU_CACHE"] = old
    check(launches == {**dict.fromkeys(launches, 0), "K1": launches["K1"]}
          and launches["K1"] > 0 and launches["K1"] % 12 == 0,
          f"the tag's eval launches {launches}")
    retrieval = {k: v for k, v in metrics.items() if "R@" in k}
    check(len(retrieval) >= 12 and all(0.0 <= v <= 1.0
                                        for v in retrieval.values()),
          f"retrieval metrics {retrieval}")
    print(f"[weights] trainer --pretrained cosmos_cc3m --force-image-size "
          f"{TAG_IMAGE_SIZE} (L {(TAG_IMAGE_SIZE // 16) ** 2 + 1}, amp): "
          f"{wall_s:.1f} s, K1 {launches['K1']}; " + " ".join(
              f"{k}={v:.4f}" for k, v in sorted(retrieval.items())))
    model = create_model("ViT-B-16", "fp32", device="cpu", seed=1,
                         force_image_size=TAG_IMAGE_SIZE, **COSMOS)
    load_checkpoint(model, path)
    src = read_checkpoint(path)["visual.positional_embedding"].numpy()
    grid = TAG_IMAGE_SIZE // 16
    want = bicubic_resize_np(src, 14, grid)
    got = model.visual.positional_embedding.detach().double().numpy()
    pos_err = float(np.abs(got - want).max())
    print(f"[weights] position table [197, 768] -> [{grid * grid + 1}, "
          f"768]: max abs diff from the float64 numpy resize {pos_err:.3g}")
    check(pos_err <= POS_RESIZE_TOL, f"position table resize: {pos_err}")
    del model
    return dict(metrics=retrieval, wall_s=wall_s, launches=launches,
                pos_resize_err=pos_err, tol=POS_RESIZE_TOL), launches["K1"]


def _weights_mobileclip(K, cache):
    """20(c): MobileCLIP-S2 from Apple's train-form layout through the
    datacompdr tag (identity mean/std, bilinear resize)."""
    import os

    from cosmos_tpu_torch.models.config import get_model_config
    from cosmos_tpu_torch.models.factory import (
        create_model, create_model_from_pretrained, get_model_preprocess_cfg)
    from cosmos_tpu_torch.models.fastvit import FASTVIT_CONFIGS

    cfg = get_model_config("MobileCLIP-S2")
    g = FASTVIT_CONFIGS[cfg["vision_cfg"]["timm_model_name"]]
    t0 = time.perf_counter()
    sd = apple_mobileclip_state_dict(g["layers"], g["dims"], cfg["text_cfg"],
                                     cfg["embed_dim"], WEIGHTS_SEED)
    torch.save(sd, f"{cache}/mobileclip_s2.pt")
    old = os.environ.get("COSMOS_TPU_CACHE")
    os.environ["COSMOS_TPU_CACHE"] = cache
    try:
        model, preprocess = create_model_from_pretrained(
            "MobileCLIP-S2", "datacompdr", "bf16")
        load_s = time.perf_counter() - t0
        cpu = create_model("MobileCLIP-S2", "fp32", device="cpu",
                           pretrained="datacompdr")
    finally:
        if old is None:
            del os.environ["COSMOS_TPU_CACHE"]
        else:
            os.environ["COSMOS_TPU_CACHE"] = old
    pp = get_model_preprocess_cfg(model)
    check((tuple(preprocess.mean), tuple(preprocess.std),
           preprocess.interpolation) == ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                         "bilinear")
          and pp["interpolation"] == "bilinear",
          f"MobileCLIP preprocessing {preprocess} {pp}")
    size = model.cfg.vision_cfg.image_size
    serve, k1 = _weights_serve(K, model, size, MC_CALL_K1, "MobileCLIP-S2",
                               WEIGHTS_SEED + 1)
    del model
    torch.cuda.empty_cache()
    errs = _weights_card_vs_cpu(cpu, "MobileCLIP-S2", WEIGHTS_SEED + 1)
    del cpu
    print(f"[weights] MobileCLIP-S2 train form: {len(sd)} Apple keys "
          f"written, fused and loaded (bf16, card) in {load_s:.1f} s")
    return dict(serve=serve, card_vs_cpu=errs, tol=WEIGHTS_CPU_TOL,
                apple_keys=len(sd), load_s=load_s), k1


def _weights_int8(K):
    """20(d): int8_matmul on the card against the CPU's exact product, and
    ViT-B-16 COSMOS served from int8-quantized, dequantized weights."""
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.ops import int8

    rows, k, n = INT8_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(WEIGHTS_SEED)
    x = torch.randn(rows, k, device="cuda", generator=gen)
    w = torch.randn(n, k, device="cuda", generator=gen) * k ** -0.5
    wq, ws = int8.quantize_weight(w)
    xq, _ = int8.quantize_activations(x)
    for what, card_q, cpu_q in (("weights", (wq, ws),
                                 int8.quantize_weight(w.cpu())),
                                ("activations", (xq, _),
                                 int8.quantize_activations(x.cpu()))):
        check(all(torch.equal(a.cpu(), b) for a, b in zip(card_q, cpu_q)),
              f"int8 {what}: card vs CPU bits")
    acc = int8._int_product(xq, wq)
    acc_cpu = int8._int_product(xq.cpu(), wq.cpu())
    check(torch.equal(acc.cpu(), acc_cpu), "int8 product: card vs CPU bits")
    got = int8.int8_matmul(x, wq, ws)
    want = int8.int8_matmul(x.cpu(), wq.cpu(), ws.cpu())
    check(torch.equal(got.cpu(), want), "int8_matmul: card vs CPU bits")
    xb, wb = x.bfloat16(), w.bfloat16()
    ms = time_ms(lambda: int8.int8_matmul(x, wq, ws))
    int_mm_ms = time_ms(lambda: torch._int_mm(xq, wq.t()))
    bf16_ms = time_ms(lambda: F.linear(xb, wb))
    rel = ((got - F.linear(x, w)).norm() / F.linear(x, w).norm()).item()
    print(f"[weights] int8_matmul [{rows}, {k}] x [{k}, {n}]: card == CPU "
          f"bit for bit; {ms:.4f} ms (torch._int_mm alone {int_mm_ms:.4f} "
          f"ms) against F.linear in bf16 {bf16_ms:.4f} ms; relative error "
          f"against the float32 product {rel:.3g}")

    cpu = create_model("ViT-B-16", "fp32", device="cpu", seed=WEIGHTS_SEED,
                       **COSMOS)
    sd = cpu.state_dict()
    after, before = int8.quantized_bytes(sd)
    deq = int8.dequantize_dense_params(int8.quantize_dense_params(sd))
    ref = create_model("ViT-B-16", "bf16", device="cuda", seed=WEIGHTS_SEED,
                       **COSMOS)
    quant = create_model("ViT-B-16", "bf16", device="cuda",
                         seed=WEIGHTS_SEED, **COSMOS)
    quant.load_state_dict(deq)
    serve, k1 = _weights_serve(K, quant, 224, B16_CALL_K1,
                               "ViT-B-16 int8-dequantized", WEIGHTS_SEED + 2)
    gen = torch.Generator(device="cuda").manual_seed(WEIGHTS_SEED + 3)
    images = torch.randn(WEIGHTS_IMAGES, 224, 224, 3, device="cuda",
                         generator=gen)
    captions = torch.as_tensor(_captions(WEIGHTS_CAPTIONS, 77,
                                         seed=WEIGHTS_SEED + 3),
                               device="cuda")
    zero_launches(K)
    with torch.inference_mode():
        rels = {}
        for what, fn, arg in (("image", "encode_image", images),
                              ("text", "encode_text", captions)):
            f_ref = getattr(ref, fn)(arg)[f"{what}_features"].float()
            f_q = getattr(quant, fn)(arg)[f"{what}_features"].float()
            rels[what] = ((f_q - f_ref).norm(dim=-1)
                          / f_ref.norm(dim=-1)).max().item()
    k1 += read_launches(K)["K1"]
    del ref, quant
    torch.cuda.empty_cache()
    cpu.load_state_dict(deq)
    errs = _weights_card_vs_cpu(cpu, "ViT-B-16 int8-dequantized",
                                WEIGHTS_SEED + 4)
    del cpu
    print(f"[weights] ViT-B-16 COSMOS int8 state dict {after / 1e6:.1f} MB "
          f"against {before / 1e6:.1f} MB float32; features of the "
          f"dequantized weights against the float weights (bf16, card): "
          f"largest relative error image {rels['image']:.4f} text "
          f"{rels['text']:.4f}")
    return dict(int8_ms=ms, int_mm_ms=int_mm_ms, bf16_linear_ms=bf16_ms,
                product_rel_err=rel, state_bytes=[after, before],
                feature_rel_err=rels, serve=serve, card_vs_cpu=errs), k1


def phase_weights_in(K, data: str, cache: str, tmp: str) -> dict:
    """Phase 20: (a) ViT-L-14 from an OpenAI archive, (b) the trainer from
    a cached tag at 336 px, (c) MobileCLIP-S2 from Apple's train form,
    (d) the int8 ops; K1 held to its plain version at ViT-L-14's geometry
    first."""
    t0 = time.perf_counter()
    fa = K.fa
    gen = torch.Generator(device="cuda").manual_seed(WEIGHTS_SEED)
    label, b, l, d3, heads, causal = L14_GEOMETRY
    rows = [kernel_row(fa, label, b, l, d3, heads, causal, dtype, gen)
            for dtype in (torch.float32, torch.bfloat16)]
    l14, k1_l14 = _weights_openai_l14(K, fa, tmp)
    tag, k1_tag = _weights_trainer_tag(K, data, cache, tmp)
    mc, k1_mc = _weights_mobileclip(K, cache)
    q, k1_q = _weights_int8(K)
    k1 = {"ViT-L-14": k1_l14, "trainer tag": k1_tag, "MobileCLIP-S2": k1_mc,
          "int8": k1_q}
    out = dict(kernel_rows=rows, openai_l14=l14, trainer_tag=tag,
               mobileclip=mc, int8=q, k1_launches=k1,
               phase_s=time.perf_counter() - t0)
    print(f"[weights] phase 20 in {out['phase_s']:.1f} s; K1 launches "
          + " ".join(f"{k}={v}" for k, v in k1.items()))
    return out


# phase 21: CoCa at coca_ViT-B-32's full width (a ViT-B-32 of width 768
# pooled by 256 learned queries into a 512-wide decoder), random weights
# from a seed; K1/K2 take its vision tower only (L 50, 12 heads)
COCA_MODEL = "coca_ViT-B-32"
COCA_SEED = 21
COCA_GEOMETRY = ("vision coca_ViT-B-32 224px", 64, 50, 3 * 768, 12, False)
COCA_CALL_K1 = {"image": 12, "text": 0}
COCA_CONTEXT = 76
COCA_RETRIEVAL = (512, 5, 256)      # images, captions an image, batch
COCA_CPU = (2, 4)                   # images, captions of 21(b)
COCA_CPU_TOL = 1e-5                 # float32 on both sides, TF32 off
COCA_GEN = dict(seq_len=30, min_seq_len=5)
COCA_GEN_IMAGES, COCA_GEN_CPU_IMAGES, COCA_BEAMS = 16, 2, 6
COCA_SAMPLING = {"greedy": {}, "top_k": dict(top_k=5),
                 "top_p": dict(top_p=0.9)}
COCA_STEPS = (3, 10)                # 21(d): warm-up and timed steps
COCA_STEP_BATCH = 64
COCA_SMALL = 2                      # layers a tower of 21(d)'s f32 step
COCA_STEP_RTOL = 1e-4
COCA_TRAINER_STEPS = 2


def _coca_model(precision, device, layers=None):
    """coca_ViT-B-32 with weights from COCA_SEED; ``layers`` cuts every
    tower and the decoder to that depth."""
    import dataclasses

    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.models.coca import CoCa
    from cosmos_tpu_torch.models.config import build_clip_cfg
    from cosmos_tpu_torch.models.factory import init_weights, resolve_dtype

    if layers is None:
        return create_model(COCA_MODEL, precision, device=device,
                            seed=COCA_SEED)
    cfg = build_clip_cfg(COCA_MODEL, {"vision_layers": layers,
                                      "text_layers": layers})
    cfg = dataclasses.replace(cfg, multimodal_cfg=dataclasses.replace(
        cfg.multimodal_cfg, layers=layers))
    model = CoCa(cfg, dtype=resolve_dtype(precision))
    init_weights(model, torch.Generator().manual_seed(COCA_SEED))
    return model.to(device).eval()


def _coca_serving(K, model):
    """21(a): encode_image at batch 64 (224 px) and encode_text at 256 x 76
    in bfloat16, exactly 12 K1 launches an image call and none a text
    call; then evaluate_retrieval over 512 images and 2560 captions (no
    EOT truncation: CoCa's text tower appends its CLS token)."""
    from cosmos_tpu_torch.training.evaluate import make_encoders
    from cosmos_tpu_torch.training.retrieval import evaluate_retrieval
    from cosmos_tpu_torch.training.zero_shot import supports_eot_truncation

    serve, k1 = _weights_serve(K, model, 224, COCA_CALL_K1, COCA_MODEL,
                               COCA_SEED, length=COCA_CONTEXT, tag="coca")
    check(not supports_eot_truncation(model), "CoCa takes no EOT truncation")
    n_img, per_img, batch = COCA_RETRIEVAL
    gen = torch.Generator(device="cuda").manual_seed(COCA_SEED + 1)
    images = torch.randn(n_img, 224, 224, 3, device="cuda", generator=gen)
    captions = _captions(n_img * per_img, COCA_CONTEXT, seed=COCA_SEED + 2)
    data = SimpleNamespace(
        captions=captions, caption_ids=np.arange(n_img * per_img),
        img2txt={i: list(range(per_img * i, per_img * (i + 1)))
                 for i in range(n_img)},
        txt2img={c: [c // per_img] for c in range(n_img * per_img)})
    loader = [(images[i:i + batch], np.arange(i, i + batch))
              for i in range(0, n_img, batch)]
    enc_img, enc_txt, _ = make_encoders(model)
    zero_launches(K)
    t0 = time.perf_counter()
    metrics = evaluate_retrieval(enc_img, enc_txt, data, loader,
                                 batch_size=batch, eot_truncate=False)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    got = read_launches(K)
    want = {**dict.fromkeys(got, 0), "K1": 12 * len(loader)}
    check(got == want, f"CoCa retrieval launches {got}, expected {want}")
    for k in ("text_to_image_R@1", "image_to_text_R@10"):
        check(0.0 <= metrics[k] <= 1.0, f"CoCa retrieval {k} = {metrics[k]}")
    print(f"[coca] evaluate_retrieval over {n_img} images / "
          f"{len(captions)} captions at {COCA_CONTEXT}: {eval_s:.3f} s, K1 "
          f"{got['K1']} (12 an image call, none a text call); "
          + " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    return dict(serve=serve, retrieval=metrics, retrieval_s=eval_s,
                retrieval_k1=got["K1"]), k1 + got["K1"]


def _coca_inputs(n_img, n_txt, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n_img, 224, 224, 3))
                         .astype(np.float32))
    return x, torch.from_numpy(_captions(n_txt, COCA_CONTEXT, seed=seed))


def _coca_card_vs_cpu(cpu, gpu):
    """21(b): the same float32 weights on the card and on the CPU: the
    normalised features of 2 images and 4 captions, and the decoder's
    logits of the 2 images with the first 2 captions."""
    n_img, n_txt = COCA_CPU
    x, toks = _coca_inputs(n_img, n_txt, COCA_SEED + 3)

    def outputs(model, device):
        with torch.inference_mode():
            xi, ti = x.to(device), toks.to(device)
            return dict(image=model.encode_image(xi),
                        text=model.encode_text(ti),
                        logits=model(xi, ti[:n_img])["logits"])

    errs = {}
    for (what, g), w in zip(outputs(gpu, "cuda").items(),
                            outputs(cpu, "cpu").values()):
        g = g.cpu()
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"CoCa {what} shape/finite")
        errs[what] = (g - w).abs().max().item()
        check(errs[what] <= COCA_CPU_TOL,
              f"CoCa card vs CPU {what}: max err {errs[what]}")
    print(f"[coca] card vs CPU (float32, {n_img} images, {n_txt} captions, "
          f"logits [{n_img}, {COCA_CONTEXT - 1}, 49408]): max abs err "
          + " ".join(f"{k} {v:.3g}" for k, v in errs.items()))
    return errs


def _coca_generation(K, model, cpu, gpu):
    """21(c): generate (greedy, top_k, top_p) and 6-beam search on 16
    images at seq_len 30 in bfloat16, tokens/s, 12 K1 launches a call (the
    image call; the decoder's masked and cross attention take the plain
    path); then float32 greedy tokens of 2 images on the CPU, the card's
    logits along them (teacher-forced) and the share of equal tokens."""
    from cosmos_tpu_torch.models import coca

    gen = torch.Generator(device="cuda").manual_seed(COCA_SEED + 4)
    images = torch.randn(COCA_GEN_IMAGES, 224, 224, 3, device="cuda",
                         generator=gen)
    runs, k1 = {}, 0
    modes = [(m, lambda kw=kw: coca.generate(
        model, images, generation_type=m, generator=gen, **kw,
        **COCA_GEN)) for m, kw in COCA_SAMPLING.items()]
    modes.append((f"beam{COCA_BEAMS}", lambda: coca.beam_search_generate(
        model, images, num_beams=COCA_BEAMS, **COCA_GEN)))
    for name, fn in modes:
        zero_launches(K)
        fn()                                   # warm-up
        torch.cuda.synchronize()
        warm = read_launches(K)
        check(warm == {**dict.fromkeys(warm, 0), "K1": 12},
              f"CoCa {name} warm-up: launches {warm}, expected 12 K1")
        zero_launches(K)
        t0 = time.perf_counter()
        toks = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_launches(K)
        check(got == {**dict.fromkeys(got, 0), "K1": 12},
              f"CoCa {name}: launches {got}, expected 12 K1")
        k1 += warm["K1"] + got["K1"]
        check(toks.shape == (COCA_GEN_IMAGES, COCA_GEN["seq_len"])
              and bool((toks[:, 0] == 49406).all())
              and bool(((toks >= 0) & (toks < 49408)).all()),
              f"CoCa {name}: tokens")
        new = COCA_GEN_IMAGES * (COCA_GEN["seq_len"] - 1)
        runs[name] = dict(s=wall, tokens_per_s=new / wall,
                          eot_share=float((toks == 49407).any(1)
                                          .float().mean()))
        print(f"[coca] {name}: {COCA_GEN_IMAGES} images x "
              f"{COCA_GEN['seq_len']} tokens in {wall:.3f} s, "
              f"{runs[name]['tokens_per_s']:.1f} tokens/s (bf16)")
    x, _ = _coca_inputs(COCA_GEN_CPU_IMAGES, 0, COCA_SEED + 5)
    cpu_toks = coca.generate(cpu, x, generation_type="greedy", **COCA_GEN)
    gpu_toks = coca.generate(gpu, x.cuda(), generation_type="greedy",
                             **COCA_GEN).cpu()
    with torch.inference_mode():
        want = cpu.decode_logits(cpu._encode_image(x)[1], cpu_toks)
        got = gpu.decode_logits(gpu._encode_image(x.cuda())[1],
                                cpu_toks.cuda()).cpu()
    err = (got - want).abs().max().item()
    same = float((gpu_toks == cpu_toks).float().mean())
    check(err <= COCA_CPU_TOL, f"CoCa teacher-forced logits card vs CPU: "
          f"max err {err}")
    print(f"[coca] float32 greedy, {COCA_GEN_CPU_IMAGES} images: the card's "
          f"logits along the CPU's tokens within {err:.3g}; equal tokens "
          f"{same:.4f}")
    return dict(runs=runs, teacher_forced_err=err, equal_token_share=same,
                cpu_tokens=cpu_toks.tolist(), card_tokens=gpu_toks.tolist()), k1


def _coca_batch(b, seed, device):
    rng = np.random.default_rng(seed)
    return {"global_images": torch.from_numpy(rng.integers(
                0, 256, (1, b, 224, 224, 3), np.uint8)).to(device),
            "texts": torch.from_numpy(_train_texts(
                rng, (1, b, COCA_CONTEXT))).to(device)}


def _coca_step(K):
    """21(d): the CoCa step at full width in bfloat16, batch 64, on one
    fixed uint8 batch: 3 + 10 steps with per-step CUDA events, exactly 12
    K1 and 12 K2 a step, a finite and falling loss; then one 2-layer
    float32 step at batch 2 on the card and on the CPU from the same
    weights."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import TrainStepConfig

    model = _coca_model("bf16", "cuda").train()
    lr = const_lr(1e-4, 0, 100)
    opt = create_optimizer(model, lr, beta1=0.9, beta2=0.98, eps=1e-8,
                           weight_decay=0.1)
    cfg = TrainStepConfig(cosmos=False, coca=True, momentum_teacher=0.999,
                          fix_momentum=True, lr_schedule=lr,
                          input_dtype=torch.bfloat16)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    batch = _coca_batch(COCA_STEP_BATCH, COCA_SEED + 6, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    zero_launches(K)
    for i in range(sum(COCA_STEPS)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch)
        end.record()
        losses.append(m["loss"].item())
        if i >= COCA_STEPS[0]:
            ms.append(start.elapsed_time(end))
    n = sum(COCA_STEPS)
    launches = read_launches(K)
    want = {**dict.fromkeys(launches, 0), "K1": 12 * n, "K2": 12 * n}
    check(launches == want, f"CoCa step launches {launches}, expected "
          f"{want}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"CoCa step losses finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = dict(losses=losses, step_ms=ms, step_ms_median=float(np.median(ms)),
               step_ms_mean=float(np.mean(ms)), peak_mem_gb=peak,
               samples_per_s=COCA_STEP_BATCH / float(np.median(ms)) * 1e3,
               launches=launches)
    print(f"[coca] step bf16 batch {COCA_STEP_BATCH}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; ms per step median "
          f"{out['step_ms_median']:.3f} mean {out['step_ms_mean']:.3f} "
          f"({out['samples_per_s']:.1f} samples/s); peak memory {peak:.2f} "
          f"GB; K1/K2 12/12 a step")
    del step, state, opt, model, batch
    torch.cuda.empty_cache()

    lr_small = 1e-4
    cpu_model = _coca_model("fp32", "cpu", layers=COCA_SMALL).train()
    gpu_model = copy.deepcopy(cpu_model).to("cuda")
    small = _coca_batch(2, COCA_SEED + 7, "cpu")
    cfg_kw = dict(cosmos=False, coca=True)
    cpu = _step_run(cpu_model, cfg_kw, small, lr_small)
    gpu = _step_run(gpu_model, cfg_kw, small, lr_small)
    check((gpu["K1"], gpu["K2"]) == (COCA_SMALL, COCA_SMALL),
          f"2-layer CoCa step: K1/K2 {gpu['K1']}/{gpu['K2']}")
    errs = {"loss": abs(gpu["loss"] - cpu["loss"]) / abs(cpu["loss"])}
    check(errs["loss"] <= COCA_STEP_RTOL,
          f"CoCa loss card {gpu['loss']} vs CPU {cpu['loss']}")
    errs["grads"] = _grad_errs(gpu["grads"], cpu["grads"], COCA_STEP_RTOL,
                               1e-8, "CoCa 2-layer step")
    for which in ("student", "teacher"):
        errs[which] = max((gpu[which][k] - cpu[which][k]).abs().max().item()
                          for k in cpu[which])
        check(errs[which] <= 2 * lr_small,
              f"updated {which} card vs CPU: max err {errs[which]}")
    print(f"[coca] 2-layer float32 step card vs CPU: loss rel err "
          f"{errs['loss']:.3g}, max grad err {errs['grads']:.3g}, updated "
          f"student {errs['student']:.3g} teacher {errs['teacher']:.3g}")
    out["card_vs_cpu"] = errs
    return out, (launches["K1"] + gpu["K1"], launches["K2"] + gpu["K2"])


def _coca_trainer_argv(data, workers, logs):
    """Phase 12's flags for coca_ViT-B-32: one view (the CoCa step reads
    the first crop and caption only), COCA_TRAINER_STEPS steps an epoch,
    the evals every second epoch and at the last."""
    argv = _drop_flags(
        _trainer_argv(data, logs, workers),
        values=("--model", "--name", "--global-crops-number",
                "--local-crops-number", "--crop-scale",
                "--caption-sampling-mode", "--num-sampled-captions",
                "--steps-per-epoch"),
        switches=("--cosmos", "--output-all", "--attentional-pool",
                  "--use-imagecrop-aug"))
    return argv + ["--model", COCA_MODEL, "--name", "coca",
                   "--caption-sampling-mode", "random",
                   "--num-sampled-captions", "1", "--steps-per-epoch",
                   str(COCA_TRAINER_STEPS), "--save-frequency", "0",
                   "--val-frequency", "2"]


def _coca_trainer(K, data, workers, logs):
    """21(e): main([...]) with --model coca_ViT-B-32 on phase 12's shards
    (amp, batch 64, no multi-crop), 2 epochs of 2 steps with the val and
    COCO retrieval evals at the second and a checkpoint, then --resume
    latest for a third; K1 12 a vision-tower call (the steps' and the
    evals'), K2 12 a step."""
    from cosmos_tpu_torch.models.coca import CoCa
    from cosmos_tpu_torch.training import main as trainer

    argv = _coca_trainer_argv(data, workers, logs)
    calls = []
    encode = CoCa._encode_image

    def counted(self, *a, **kw):
        calls.append(1)
        return encode(self, *a, **kw)

    record = {"steps": [], "evals": [], "profiles": {}}
    zero_launches(K)
    t0 = time.perf_counter()
    CoCa._encode_image = counted
    try:
        with _instrumented_trainer(K, record, profiled=()):
            run1 = trainer.main(argv + ["--epochs", "2"])
            run2 = trainer.main(argv + ["--epochs", "3", "--resume",
                                        "latest"])
    finally:
        CoCa._encode_image = encode
    wall_s = time.perf_counter() - t0
    launches = read_launches(K)
    epochs = run1["train_epoch_stats"] + run2["train_epoch_stats"]
    check([s["epoch"] for s in epochs] == [0, 1, 2],
          f"CoCa trainer: epochs run {[s['epoch'] for s in epochs]}")
    losses = [line["loss"] for s in epochs for line in s["logged"]]
    n_steps = 3 * COCA_TRAINER_STEPS
    check(len(losses) == n_steps and all(np.isfinite(losses)),
          f"CoCa trainer: a finite loss at every step: {losses}")
    step_want = {**dict.fromkeys(launches, 0), "K1": 12, "K2": 12}
    check(record["steps"] == [step_want] * n_steps,
          f"CoCa trainer step launches {record['steps']}")
    check(len(record["evals"]) == 2, "CoCa trainer: two evals")
    want = {**dict.fromkeys(launches, 0), "K1": 12 * len(calls),
            "K2": 12 * n_steps}
    check(launches == want, f"CoCa trainer launches {launches}, expected "
          f"{want} ({len(calls)} vision-tower calls)")
    for prefix in ("", "ema_"):
        for key in ("clip_val_loss", "coco_image_to_text_R@1",
                    "coco_text_to_image_R@10"):
            v = run2.get(prefix + key)
            check(v is not None and np.isfinite(v), f"{prefix}{key}: {v}")
    step_ms = [ms for s in epochs for ms in s["step_ms"][1:]]
    out = dict(losses=losses, launches=launches, vision_calls=len(calls),
               eval_launches=record["evals"], step_ms=step_ms,
               eval_s=[s.get("eval_s") for s in epochs], wall_s=wall_s,
               metrics={k: v for k, v in run2.items()
                        if isinstance(v, (int, float))})
    print(f"[coca] trainer {COCA_MODEL}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; K1 {launches['K1']} "
          f"over {len(calls)} vision-tower calls, K2 {launches['K2']} over "
          f"{n_steps} steps; evals "
          + ", ".join(f"{s:.2f} s" for s in out["eval_s"] if s)
          + f"; wall {wall_s:.1f} s")
    shutil.rmtree(f"{logs}/coca")
    return out


def phase_coca(K, data: str, workers: int, tmp: str) -> dict:
    """Phase 21: CoCa at coca_ViT-B-32's full width.  (f) K1 and K2 held
    to their plain versions and timed at its vision geometry first, then
    (a) serving, (b) card against CPU, (c) generation, (d) the step and
    (e) the trainer."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa = K.fa
    gen = torch.Generator(device="cuda").manual_seed(COCA_SEED)
    label, b, l, d3, heads, causal = COCA_GEOMETRY
    rows = [kernel_row(fa, label, b, l, d3, heads, causal, dtype, gen)
            for dtype in (torch.float32, torch.bfloat16)]
    bwd_rows = [kernel_bwd_row(fa, label, b, l, d3, heads, causal, dtype,
                               gen)
                for dtype in (torch.float32, torch.bfloat16)]
    check(fa.supported(heads, d3 // 3, l, 2) and fa.supported(
        heads, d3 // 3, l, 4), "K1's gate admits CoCa's vision geometry")
    parts = {"kernels": time.perf_counter() - t0}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    model = _coca_model("bf16", "cuda")
    serving, k1_serve = _coca_serving(K, model)
    done("serving")
    cpu = _coca_model("fp32", "cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    card_vs_cpu = _coca_card_vs_cpu(cpu, gpu)
    done("card vs CPU")
    generation, k1_gen = _coca_generation(K, model, cpu, gpu)
    done("generation")
    del model, cpu, gpu
    torch.cuda.empty_cache()
    step, (k1_step, k2_step) = _coca_step(K)
    done("step")
    trainer = _coca_trainer(K, data, workers, f"{tmp}/coca_logs")
    done("trainer")
    k1 = {"CoCa serving": k1_serve, "CoCa generation": k1_gen,
          "CoCa step": k1_step, "CoCa trainer": trainer["launches"]["K1"]}
    k2 = {"CoCa step": k2_step, "CoCa trainer": trainer["launches"]["K2"]}
    out = dict(kernel_rows=rows, kernel_bwd_rows=bwd_rows, serving=serving,
               card_vs_cpu=card_vs_cpu, generation=generation, step=step,
               trainer=trainer, k1_launches=k1, k2_launches=k2,
               parts_s=parts, phase_s=time.perf_counter() - t0)
    print(f"[coca] phase 21 in {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
          + "); K1 launches "
          + " ".join(f"{k}={v}" for k, v in k1.items()) + "; K2 launches "
          + " ".join(f"{k}={v}" for k, v in k2.items()))
    return out


# phase 22: the sharded modes complete.  (a) K5 at the column shards of
# tensor parallelism; (b) fuse_ln under TP, ViT-B-16 COSMOS at full width
# on two gloo ranks of this card; (c) CoCa under FSDP at world 1 on NCCL;
# (d) CoCa under TP on the same two ranks as (b)
# (D, O): ViT-B's packed QKV (2304) at tp 2 and 4, the 512-wide text
# tower's (1536) at tp 4
K5_TP_SHAPES = ((768, 1152), (768, 576), (512, 384))
K5_TP_ROWS = (1, 63, 65, 7392)
TP_MAIN_ROWS = 25216         # the kernel table's rows: the vision globals
K6_TP_SHAPE = (768, 1536)    # (D, HD): ViT-B's MLP at tp 2
# sha256 (first 16 hex digits) of K5's bf16 output at (R, D, O) on
# _k5_inputs, from the kernel before its width gate was widened (the
# parent commit's ln_matmul.cu, built and run beside this one by
# ``--k5-against``): widths that are multiples of 256 keep these bits
K5_PRE_BITS = {(7392, 768, 2304): "887be864d76b77db",
               (7392, 512, 1536): "f4c7651981ab3508"}
SLICE16_TP = 2               # model-axis ranks of 22(b) and (d), gloo
SLICE16_BATCH = 4            # 22(b)'s rows a step, whole on both ranks
SLICE16_STEPS = (1, 2)       # 22(b)'s warm-up and timed steps
SLICE16_SMALL = 2            # layers a tower of 22(b)'s and (d)'s float32 steps
# blocks a tower of 22(b)'s bf16 TP step, at full width: cut from 12 to keep
# the script within its time limit
SLICE16_LAYERS = 2
SLICE16_ENC = (8, 16)        # 22(d)'s images and captions
SLICE16_LR = 1e-4            # 22(b)'s float32 steps (phase 8's lr)
# 22(b) in bfloat16: each rank's K6 output is its partial sum rounded to
# bf16 before the sum over the model group (one more rounding, of a partial
# about half the output's size, than the one-process step's), so the TP
# losses are held to the one-process step's within this relative bound
FUSE_TP_LOSS_RTOL = 5e-3
COCA_FSDP_STEPS = 2          # 22(c)'s steps of each, plain and FSDP


def _k5_inputs(r, d, o):
    """Seeded bf16 inputs of K5 at (R, D, O) on the card."""
    rng = np.random.default_rng((r, d, o))

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale + shift)
                                .astype(np.float32)).cuda()

    return (t(r, d, scale=2.0, shift=0.5).bfloat16(), t(d, shift=1.0), t(d),
            t(o, d, scale=d ** -0.5).bfloat16(), t(o).bfloat16().float())


K5_AGAINST_FLAG = "--k5-against"
# (R, D, O) where ``--k5-against`` times both kernels: the vision and text
# towers' packed QKV at the kernel table's rows
K5_AGAINST_TIMED = ((25216, 768, 2304), (25216, 512, 1536))


def k5_against(other: str) -> int:
    """K5 of another checkout (``other``, e.g. the parent commit unpacked by
    ``git archive``) built from its ``ln_matmul.cu`` and run beside this
    one's at the widths both take: the bits at K5_PRE_BITS' shapes, and at
    K5_AGAINST_TIMED whether the outputs are equal and the ms of each, in
    the order other, this, this, other."""
    import ctypes

    from cosmos_tpu_torch.ops import build as kernel_build

    K = _kernel_modules()
    print(phase_card())
    src = Path(other) / "cosmos_tpu_torch" / "ops" / "csrc" / "ln_matmul.cu"
    lib = ROOT / "build" / "k5_other.so"
    lib.parent.mkdir(exist_ok=True)
    proc = subprocess.run([kernel_build.find_nvcc(), *kernel_build.NVCC_FLAGS,
                           "-o", str(lib), str(src)], capture_output=True,
                          text=True)
    check(proc.returncode == 0, f"nvcc {src}: {proc.stderr[-2000:]}")
    K.lm.build()
    fn = ctypes.CDLL(str(lib)).cosmos_ln_matmul_fwd
    fn.argtypes = K.lm._function().argtypes
    fn.restype = ctypes.c_int

    def run_other(x, g, b, w, bias):
        (r, d), o = x.shape, w.shape[0]
        y = torch.empty(r, o, dtype=x.dtype, device="cuda")
        st = torch.empty(r, 2, dtype=torch.float32, device="cuda")
        rc = fn(x.data_ptr(), g.data_ptr(), b.data_ptr(), w.data_ptr(),
                bias.data_ptr(), y.data_ptr(), st.data_ptr(), r, d, o, 1e-5,
                1, torch.cuda.current_stream().cuda_stream)
        check(rc == 0, f"the other K5 failed with cudaError {rc}")
        return y

    out = {}
    for shape in K5_PRE_BITS:
        args = _k5_inputs(*shape)
        out[f"bits R={shape[0]} D={shape[1]} O={shape[2]}"] = dict(
            other=_bits(run_other(*args)),
            this=_bits(K.lm.ln_matmul_fwd(*args)))
    for shape in K5_AGAINST_TIMED:
        args = _k5_inputs(*shape)
        out[f"R={shape[0]} D={shape[1]} O={shape[2]}"] = dict(
            same_bits=torch.equal(run_other(*args),
                                  K.lm.ln_matmul_fwd(*args)),
            ms_other_this_this_other=[
                time_ms(lambda: run_other(*args)),
                time_ms(lambda: K.lm.ln_matmul_fwd(*args)),
                time_ms(lambda: K.lm.ln_matmul_fwd(*args)),
                time_ms(lambda: run_other(*args))])
    print(json.dumps({"k5_against": other, **out}))
    return 0


def _bits(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.sha256(t.view(torch.int16).cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def _slice16_kernels(K) -> dict:
    """22(a): K5 at the column shards of K5_TP_SHAPES against its plain
    version at ragged rows in both dtypes, with the same bits on a repeat;
    K5 at each shard and K6 at its hidden shard timed at TP_MAIN_ROWS in
    bf16 beside the plain version, the stock composition and the bound;
    and the bits of the widths the kernel took before."""
    f32, bf16 = torch.float32, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(32)

    def rand(*shape, scale=1.0, shift=0.0, dtype=f32):
        return (torch.randn(*shape, device="cuda", generator=gen) * scale
                + shift).to(dtype)

    errs, rows = {}, []
    for d, o in K5_TP_SHAPES:
        for dtype in (f32, bf16):
            for r in K5_TP_ROWS:
                what = f"R={r} D={d} O={o} {str(dtype)[6:]}"
                x = rand(r, d, scale=2.0, shift=0.5, dtype=dtype)
                s, sh = rand(d, shift=1.0), rand(d)
                w = rand(o, d, scale=d ** -0.5, dtype=dtype)
                bias = rand(o).to(dtype).float()
                got = K.lm.ln_matmul_fwd(x, s, sh, w, bias)
                check(torch.equal(got, K.lm.ln_matmul_fwd(x, s, sh, w, bias)),
                      f"22(a) K5 repeated at {what}: results differ")
                errs[what] = _held(f"22(a) K5 at {what}", got,
                                   K.lm.ln_matmul_reference(x, s, sh, w, bias),
                                   LN_TOL[dtype])
    r = TP_MAIN_ROWS

    def row(kernel, shape, err, fn, plain, stock, bound):
        ms = time_ms(fn)
        plain_ms = time_ms(plain, iters=5)
        library_ms = time_ms(stock)
        bound_ms, bound_by, nbytes, ops = bound
        rows.append(dict(kernel=kernel, shape=list(shape), dtype="bfloat16",
                         max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         bound_by=bound_by, bytes=nbytes, ops=ops,
                         x_bound=ms / bound_ms, x_library=ms / library_ms))
        print(f"[slice16] (a) {kernel} {list(shape)} bf16: err {err:.3g} | "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, stock "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
              f"x{ms / bound_ms:.2f} bound, x{ms / library_ms:.2f} stock)")

    for d, o in K5_TP_SHAPES:
        x = rand(r, d, scale=2.0, shift=0.5, dtype=bf16)
        s, sh = rand(d, shift=1.0), rand(d)
        w = rand(o, d, scale=d ** -0.5, dtype=bf16)
        bias = rand(o).to(bf16).float()
        s_c, sh_c, bias_c = s.to(bf16), sh.to(bf16), bias.to(bf16)
        err = _held(f"22(a) K5 at R={r} D={d} O={o}",
                    K.lm.ln_matmul_fwd(x, s, sh, w, bias),
                    K.lm.ln_matmul_reference(x, s, sh, w, bias), LN_TOL[bf16])
        row("K5", (r, d, o), err,
            lambda: K.lm.ln_matmul_fwd(x, s, sh, w, bias),
            lambda: K.lm.ln_matmul_reference(x, s, sh, w, bias),
            lambda: F.linear(F.layer_norm(x, (d,), s_c, sh_c), w, bias_c),
            ln_matmul_bound(r, d, o, bf16))
        del x, w
    d, hd = K6_TP_SHAPE
    x = rand(r, d, scale=2.0, shift=0.5, dtype=bf16)
    s, sh = rand(d, shift=1.0), rand(d)
    w1 = rand(hd, d, scale=d ** -0.5, dtype=bf16)
    w2 = rand(d, hd, scale=(2 * hd) ** -0.5, dtype=bf16)
    b1 = rand(hd, scale=0.1)
    # a rank's call: its hidden shard, zeros for b2 (added after the sum)
    b2 = torch.zeros(d, device="cuda")
    s_c, sh_c, b1_c = s.to(bf16), sh.to(bf16), b1.to(bf16)
    args = (x, s, sh, w1, b1, w2, b2, 1e-5, "gelu_tanh")
    got = K.mb.mlp_block_fwd(*args)
    check(torch.equal(got, K.mb.mlp_block_fwd(*args)),
          "22(a) K6 repeated at its hidden shard: results differ")
    err = _held(f"22(a) K6 at R={r} D={d} HD={hd}", got,
                K.mb.mlp_block_reference(*args), LN_TOL[bf16])
    row("K6", (r, d, hd), err, lambda: K.mb.mlp_block_fwd(*args),
        lambda: K.mb.mlp_block_reference(*args),
        lambda: F.linear(F.gelu(F.linear(F.layer_norm(x, (d,), s_c, sh_c),
                                         w1, b1_c), approximate="tanh"), w2),
        mlp_block_bound(r, d, hd, bf16))
    del x, w1, w2, got
    bits = {}
    for (r, d, o), want in K5_PRE_BITS.items():
        got = _bits(K.lm.ln_matmul_fwd(*_k5_inputs(r, d, o)))
        bits[f"R={r} D={d} O={o}"] = got
        check(got == want, f"22(a) K5 at R={r} D={d} O={o}: bits {got}, "
              f"before the widened gate {want}")
    print(f"[slice16] (a) K5 at the column shards, max abs err "
          + " ".join(f"{k}: {v:.3g}" for k, v in errs.items())
          + f"; the bits before the widened gate at "
          + ", ".join(bits) + ": the same")
    torch.cuda.empty_cache()
    return dict(errs=errs, rows=rows, bits=bits)


COCA_MODE = dict(cosmos=False, coca=True)


def _slice16_coca_fsdp(K, data: str, workers: int, tmp: str) -> dict:
    """22(c): the CoCa step at coca_ViT-B-32's full width in bf16, batch
    64, plain and under FSDP at world 1 on NCCL (a process group of this
    one rank), COCA_FSDP_STEPS steps of each from the same weights and
    batch: the same losses and the same student to the bit, 12/12 K1/K2 a
    step; then main([...]) with phase 21's flags and --fsdp: an epoch of
    COCA_TRAINER_STEPS steps and a gathered checkpoint, and --resume
    latest into a second with the val eval."""
    import hashlib

    from cosmos_tpu_torch.parallel import distributed
    from cosmos_tpu_torch.parallel.mesh import create_mesh
    from cosmos_tpu_torch.training.checkpoint import host_state
    from cosmos_tpu_torch.training.scheduler import const_lr

    runs = {}
    for fsdp in (False, True):
        if fsdp:
            distributed.init_distributed(None, alone=True)
        try:
            model = _coca_model("bf16", "cuda").train()
            step, state = _gspmd_setup(
                model, const_lr(1e-4, 0, 100), torch.bfloat16,
                create_mesh(device_type="cuda") if fsdp else None, fsdp,
                mode=COCA_MODE)
            batch = _coca_batch(COCA_STEP_BATCH, COCA_SEED + 6, "cuda")
            run = _timed_steps(K, step, state, batch, 0, COCA_FSDP_STEPS)
            student = (host_state(state, optimizer=False)["student"] if fsdp
                       else state.student.state_dict())
            h = hashlib.sha256()
            for k, v in student.items():
                h.update(k.encode())
                h.update(v.detach().cpu().numpy().tobytes())
            run["student_digest"] = h.hexdigest()[:16]
            runs["fsdp" if fsdp else "plain"] = run
            del model, step, state, batch, student
        finally:
            if fsdp:
                distributed.destroy()
        torch.cuda.empty_cache()
    want = {**dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6"), 0),
            "K1": 12, "K2": 12}
    for name, run in runs.items():
        check(all(x == want for x in run["launches"]),
              f"22(c) {name}: launches {run['launches']}, expected {want}")
    plain, fsdp = runs["plain"], runs["fsdp"]
    check(fsdp["losses"] == plain["losses"]
          and fsdp["student_digest"] == plain["student_digest"],
          f"22(c): FSDP at world 1 losses {fsdp['losses']} (student "
          f"{fsdp['student_digest']}), plain {plain['losses']} "
          f"({plain['student_digest']})")
    print(f"[slice16] (c) CoCa step under FSDP at world 1 (NCCL), bf16 "
          f"batch {COCA_STEP_BATCH}: losses {fsdp['losses']}, the plain "
          f"step's bits (student {fsdp['student_digest']}); K1/K2 12/12 a "
          f"step; ms a step FSDP {fsdp['step_ms']}, plain "
          f"{plain['step_ms']}; peak memory FSDP {fsdp['peak_mem_gb']:.2f} "
          f"GB, plain {plain['peak_mem_gb']:.2f} GB")

    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training import main as trainer

    logs = f"{tmp}/slice16_coca"
    # the val eval alone (no COCO retrieval), at the end of the second
    # epoch (--val-frequency 2)
    argv = _drop_flags(_coca_trainer_argv(data, workers, logs),
                       values=("--data-root-dir",)) + ["--fsdp"]
    record = {"steps": [], "evals": [], "profiles": {}}
    t0 = time.perf_counter()
    with _instrumented_trainer(K, record, profiled=()):
        run1 = trainer.main(argv + ["--epochs", "1", "--val-frequency", "0"])
        run2 = trainer.main(argv + ["--epochs", "2", "--resume", "latest"])
    wall_s = time.perf_counter() - t0
    epochs = run1["train_epoch_stats"] + run2["train_epoch_stats"]
    check([e["epoch"] for e in epochs] == [0, 1],
          f"22(c) trainer: epochs {[e['epoch'] for e in epochs]}")
    losses = [line["loss"] for e in epochs for line in e["logged"]]
    n = 2 * COCA_TRAINER_STEPS
    check(len(losses) == n and all(np.isfinite(losses)),
          f"22(c) trainer: losses {losses}")
    check(record["steps"] == [want] * n,
          f"22(c) trainer: step launches {record['steps']}")
    check(len(record["evals"]) == 1 and record["evals"][0]["K1"] > 0,
          f"22(c) trainer: evals {record['evals']}")
    for key in ("clip_val_loss", "ema_clip_val_loss"):
        check(np.isfinite(run2.get(key, float("nan"))),
              f"22(c) trainer: {key} {run2.get(key)}")
    ckpt = torch.load(f"{logs}/coca/checkpoints/epoch_2.pt",
                      map_location="cpu", weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in create_model(
        COCA_MODEL, device="meta").state_dict().items()}
    for which in ("student", "teacher"):
        check({k: tuple(v.shape) for k, v in ckpt[which].items()} == shapes,
              f"22(c) trainer: the checkpoint's {which} is not whole")
    check(ckpt["num_updates"] == n, "22(c) trainer: the checkpoint's count")
    shutil.rmtree(logs)
    trainer_out = dict(losses=losses, launches_per_step=want,
                       eval_k1=sum(e["K1"] for e in record["evals"]),
                       step_ms=[ms for e in epochs for ms in e["step_ms"]],
                       wall_s=wall_s)
    print(f"[slice16] (c) main([...]) --model {COCA_MODEL} --fsdp: epochs "
          f"0-1 (resumed), losses {' '.join(f'{x:.5f}' for x in losses)}, "
          f"K1/K2 12/12 a step, evals K1 "
          f"{[e['K1'] for e in record['evals']]}, the gathered epoch_2.pt "
          f"whole; {wall_s:.1f} s")
    return dict(steps=runs, trainer=trainer_out,
                k1=sum(x["K1"] for r in runs.values() for x in r["launches"])
                + n * 12 + trainer_out["eval_k1"],
                k2=sum(x["K2"] for r in runs.values() for x in r["launches"])
                + n * 12)


def _slice16_reference(K, path: str) -> dict:
    """22(b) and (d)'s references in this process, saved to ``path``: the
    one-process fuse_ln step (with FUSED_LN) at full width in bf16 on
    22(b)'s batch; its 2-layer float32 step on the CPU; the unsharded
    coca_ViT-B-32's features in float32 on the card; its 2-layer float32
    step on the card."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.training.scheduler import const_lr, cosine_lr

    ref = {}
    with ln_setting("fuse_ln"):
        model = create_model("ViT-B-16", "bf16", device="cuda", seed=0,
                             vision_layers=SLICE16_LAYERS,
                             text_layers=SLICE16_LAYERS, fuse_ln=True,
                             **TRAIN_RECIPE)
        step, state = _gspmd_setup(model, cosine_lr(5e-4, 2000, 100000),
                                   torch.bfloat16)
        batch = _train_batch(SLICE16_BATCH, seed=20, device="cuda")
        ref["fuse"] = _timed_steps(K, step, state, batch, *SLICE16_STEPS)
        del model, step, state, batch
        torch.cuda.empty_cache()
        model = create_model("ViT-B-16", "fp32", device="cpu", seed=7,
                             vision_layers=SLICE16_SMALL,
                             text_layers=SLICE16_SMALL, fuse_ln=True,
                             **TRAIN_RECIPE)
        step, state = _gspmd_setup(model, const_lr(SLICE16_LR, 0, 100),
                                   torch.float32)
        ref["fuse_small_batch"] = _train_batch(2, seed=21, device="cpu")
        ref["fuse_small"] = _small_result(step(state, ref["fuse_small_batch"]),
                                          state)
    images, texts = _coca_inputs(*SLICE16_ENC, seed=COCA_SEED + 8)
    model = _coca_model("fp32", "cuda").eval()
    with torch.no_grad():
        ref["coca_features"] = {
            "image": model.encode_image(images.cuda()).cpu(),
            "text": model.encode_text(texts.cuda()).cpu()}
    ref.update(coca_images=images, coca_texts=texts)
    del model
    model = _coca_model("fp32", "cuda", layers=SLICE16_SMALL).train()
    step, state = _gspmd_setup(model, const_lr(DP_LR, 0, 100), torch.float32,
                               eps=DP_EPS, mode=COCA_MODE)
    ref["coca_small_batch"] = _coca_batch(4, COCA_SEED + 9, "cpu")
    ref["coca_small"] = _small_result(step(state, {
        k: v.cuda() for k, v in ref["coca_small_batch"].items()}), state)
    del model, step, state
    torch.cuda.empty_cache()
    torch.save(ref, path)
    return ref


def _small_result(metrics, state, whole=None) -> dict:
    """A float32 step's loss and updated student and teacher on the CPU
    (``whole``: the gathered state of a sharded one)."""
    whole = whole or {w: getattr(state, w).state_dict()
                      for w in ("student", "teacher")}
    return dict(loss=metrics["loss"].item(),
                **{w: {k: v.detach().cpu() for k, v in whole[w].items()}
                   for w in ("student", "teacher")})


def _slice16_rank(rank: int, spec: dict) -> None:
    """22(b) and (d)'s rank on a (1, SLICE16_TP) mesh of gloo ranks on this
    card: the fuse_ln step (with FUSED_LN) at full width in bf16 and at 2
    layers in float32; coca_ViT-B-32's TP encoders in float32 and its
    2-layer float32 step."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.parallel import distributed
    from cosmos_tpu_torch.parallel.mesh import create_tp_mesh
    from cosmos_tpu_torch.parallel.tp import make_tp_encoders
    from cosmos_tpu_torch.training.scheduler import const_lr, cosine_lr

    import faulthandler

    faulthandler.enable()
    _beyond_env(rank, spec["port"])
    K = _kernel_modules()
    distributed.init_distributed(None, backend="gloo")
    ref = torch.load(spec["ref"], map_location="cpu", weights_only=False)
    out = {}
    try:
        with _sync_functional_collectives():
            mesh = create_tp_mesh(1, SLICE16_TP, "cuda")
            with ln_setting("fuse_ln"):
                model = create_model("ViT-B-16", "bf16", device="cuda",
                                     seed=0, vision_layers=SLICE16_LAYERS,
                                     text_layers=SLICE16_LAYERS,
                                     fuse_ln=True, **TRAIN_RECIPE)
                step, state = _gspmd_setup(
                    model, cosine_lr(5e-4, 2000, 100000), torch.bfloat16,
                    mesh)
                batch = _train_batch(SLICE16_BATCH, seed=20, device="cuda")
                out["fuse"] = _timed_steps(K, step, state, batch,
                                           *SLICE16_STEPS)
                out["fuse"]["sharded"] = sum(
                    type(p).__name__ == "DTensor"
                    for p in state.student.parameters())
                del model, step, state, batch
                torch.cuda.empty_cache()
                model = create_model(
                    "ViT-B-16", "fp32", device="cuda", seed=7,
                    vision_layers=SLICE16_SMALL, text_layers=SLICE16_SMALL,
                    fuse_ln=True, **TRAIN_RECIPE)
                step, state = _gspmd_setup(model, const_lr(SLICE16_LR, 0, 100),
                                           torch.float32, mesh)
                zero_launches(K)
                m = step(state, {k: v.cuda() for k, v in
                                 ref["fuse_small_batch"].items()})
                launches = read_launches(K)
                out["fuse_small"] = dict(_small_result(m, state, _gathered(
                    state)), launches=launches)
                del model, step, state
            model = _coca_model("fp32", "cuda").eval()
            _, enc_image, enc_text = make_tp_encoders(model, mesh)
            feats, k1 = {}, {}
            for name, enc, x in (("image", enc_image, ref["coca_images"]),
                                 ("text", enc_text, ref["coca_texts"])):
                zero_launches(K)
                feats[name] = enc(x.cuda()).cpu()
                k1[name] = read_launches(K)["K1"]
            out["coca_encoders"] = dict(k1=k1, errs={
                n: (feats[n] - ref["coca_features"][n]).abs().max().item()
                for n in feats})
            del model, enc_image, enc_text
            model = _coca_model("fp32", "cuda", layers=SLICE16_SMALL).train()
            step, state = _gspmd_setup(model, const_lr(DP_LR, 0, 100),
                                       torch.float32, mesh, eps=DP_EPS,
                                       mode=COCA_MODE)
            zero_launches(K)
            m = step(state, {k: v.cuda() for k, v in
                             ref["coca_small_batch"].items()})
            launches = read_launches(K)
            out["coca_small"] = dict(_small_result(m, state, _gathered(state)),
                                     launches=launches)
            del model, step, state
            torch.cuda.empty_cache()
    finally:
        torch.save(out, f"{spec['out']}.{rank}")
        distributed.destroy()


def _max_err(got: dict, want: dict) -> float:
    return max((got[k] - v).abs().max().item() for k, v in want.items())


def _slice16_tp(K, tmp: str) -> dict:
    """22(b) and (d): the references in this process, then both parts on
    SLICE16_TP gloo ranks of this card."""
    t0 = time.perf_counter()
    path = f"{tmp}/slice16_ref.pt"
    ref = _slice16_reference(K, path)
    ref_s = time.perf_counter() - t0
    ranks = _spawn_ranks(_slice16_rank, dict(out=f"{tmp}/slice16", ref=path),
                         600)
    ranks_s = time.perf_counter() - t0 - ref_s
    for r, got in enumerate(ranks):
        check({"fuse", "fuse_small", "coca_encoders", "coca_small"}
              <= got.keys(), f"22(b)-(d) rank {r}: stopped after "
              f"{sorted(got)}")
    # (b) full width: every rank launches the one-process step's K1-K6
    want = step_launches("fuse_ln", SLICE16_LAYERS, SLICE16_BATCH)
    check(all(x == want for x in ref["fuse"]["launches"]),
          f"22(b) one-process fuse_ln launches {ref['fuse']['launches']}, "
          f"expected {want} a step")
    fuse = [r["fuse"] for r in ranks]
    errs = []
    for r, run in enumerate(fuse):
        check(all(x == want for x in run["launches"]),
              f"22(b) rank {r}: launches {run['launches']}, expected {want} "
              "a step (the one-process step's)")
        check(run["sharded"] > 0, f"22(b) rank {r}: no sharded weight")
        check(run["losses"] == fuse[0]["losses"],
              f"22(b) rank {r}: losses {run['losses']} vs rank 0's")
        rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   ref["fuse"]["losses"])]
        errs.append(max(rel))
        check(max(rel) <= FUSE_TP_LOSS_RTOL, f"22(b) rank {r}: TP losses "
              f"{run['losses']}, one process {ref['fuse']['losses']}")
    # (b) 2 layers, float32: the card's TP step against the CPU's
    small = [r["fuse_small"] for r in ranks]
    want_small = step_launches("fuse_ln", SLICE16_SMALL, 2)
    cpu = ref["fuse_small"]
    small_errs = {"loss": abs(small[0]["loss"] - cpu["loss"])
                  / abs(cpu["loss"])}
    check(small_errs["loss"] <= 1e-4, f"22(b) 2-layer float32 TP loss "
          f"{small[0]['loss']}, CPU {cpu['loss']}")
    for which in ("student", "teacher"):
        small_errs[which] = _max_err(small[0][which], cpu[which])
        check(small_errs[which] <= 2 * SLICE16_LR, f"22(b) 2-layer float32: "
              f"updated {which} card (TP) vs CPU max err "
              f"{small_errs[which]}")
    for r, s in enumerate(small):
        check(s["launches"] == want_small, f"22(b) 2-layer rank {r}: "
              f"launches {s['launches']}, expected {want_small}")
    print(f"[slice16] (b) fuse_ln + FUSED_LN under TP on a (1, "
          f"{SLICE16_TP}) mesh, ViT-B-16 COSMOS bf16, {SLICE16_BATCH} rows: "
          f"losses {' '.join(f'{x:.6f}' for x in fuse[0]['losses'])}, one "
          f"process {' '.join(f'{x:.6f}' for x in ref['fuse']['losses'])} "
          f"(max rel err {max(errs):.3g}, bound {FUSE_TP_LOSS_RTOL}); "
          f"launches a step on each rank {want}; ms a step "
          f"{[r['step_ms'] for r in fuse]} (one process "
          f"{ref['fuse']['step_ms']}); peak memory a rank "
          f"{[round(r['peak_mem_gb'], 2) for r in fuse]} GB (one process "
          f"{ref['fuse']['peak_mem_gb']:.2f} GB); 2-layer float32 TP step "
          f"against the CPU: " + " ".join(f"{k}={v:.3g}"
                                          for k, v in small_errs.items()))
    # (d) CoCa under TP
    enc = [r["coca_encoders"] for r in ranks]
    for r, e in enumerate(enc):
        check(e["k1"] == {"image": 12, "text": 0}, f"22(d) rank {r}: K1 per "
              f"TP encoder call {e['k1']}, expected 12 an image call, none "
              "a text call")
        check(max(e["errs"].values()) <= BEYOND_ENC_TOL, f"22(d) rank {r}: "
              f"TP features off the unsharded {e['errs']}")
    coca = [r["coca_small"] for r in ranks]
    unsharded = ref["coca_small"]
    coca_errs = {"loss": abs(coca[0]["loss"] - unsharded["loss"])
                 / abs(unsharded["loss"])}
    check(coca_errs["loss"] <= DP_LOSS_RTOL, f"22(d) 2-layer TP CoCa loss "
          f"{coca[0]['loss']}, unsharded {unsharded['loss']}")
    for which in ("student", "teacher"):
        coca_errs[which] = _max_err(coca[0][which], unsharded[which])
        check(coca_errs[which] <= DP_WEIGHT_ATOL, f"22(d) 2-layer TP CoCa: "
              f"updated {which} max err {coca_errs[which]}")
    want_coca = {**dict.fromkeys(want, 0), "K1": SLICE16_SMALL,
                 "K2": SLICE16_SMALL}
    for r, c in enumerate(coca):
        check(c["launches"] == want_coca, f"22(d) rank {r}: launches "
              f"{c['launches']}, expected {want_coca}")
    print(f"[slice16] (d) {COCA_MODEL} under TP on a (1, {SLICE16_TP}) "
          f"mesh, float32: encoders ({SLICE16_ENC[0]} images, "
          f"{SLICE16_ENC[1]} captions) max abs err "
          f"{[e['errs'] for e in enc]}, K1 a call {enc[0]['k1']}; 2-layer "
          f"step against the unsharded step: " + " ".join(
              f"{k}={v:.3g}" for k, v in coca_errs.items())
          + f"; K1/K2 {want_coca['K1']}/{want_coca['K2']}")
    launches = {k: sum(x[k] for r in fuse for x in r["launches"])
                + sum(s["launches"][k] for s in small)
                for k in ("K1", "K2", "K3", "K4", "K5", "K6")}
    launches["K1"] += sum(sum(e["k1"].values()) + c["launches"]["K1"]
                          for e, c in zip(enc, coca))
    launches["K2"] += sum(c["launches"]["K2"] for c in coca)
    return dict(reference=dict(fuse=ref["fuse"]), ref_s=ref_s,
                ranks_s=ranks_s, fuse=fuse, fuse_loss_rel_err=max(errs),
                fuse_small_errs=small_errs, coca_encoders=enc,
                coca_small_errs=coca_errs, launches=launches)


def phase_slice16(K, data: str, workers: int, tmp: str) -> dict:
    """Phase 22: the sharded modes complete: (a) K5 at the column shards of
    tensor parallelism, (c) CoCa under FSDP at world 1, then (b) fuse_ln
    and (d) CoCa under tensor parallelism on two gloo ranks."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    kernels = _slice16_kernels(K)
    done("(a) K5 at the column shards")
    coca_fsdp = _slice16_coca_fsdp(K, data, workers, tmp)
    done("(c) CoCa under FSDP")
    tp = _slice16_tp(K, tmp)
    done("(b), (d) under TP")
    k1 = {"fuse_ln under TP": sum(x["K1"] for r in tp["fuse"]
                                  for x in r["launches"]),
          "CoCa under FSDP": coca_fsdp["k1"],
          "sharded 2-layer steps and CoCa TP encoders":
              tp["launches"]["K1"] - sum(x["K1"] for r in tp["fuse"]
                                         for x in r["launches"])}
    k2 = {"fuse_ln under TP": sum(x["K2"] for r in tp["fuse"]
                                  for x in r["launches"]),
          "CoCa under FSDP": coca_fsdp["k2"],
          "sharded 2-layer steps":
              tp["launches"]["K2"] - sum(x["K2"] for r in tp["fuse"]
                                         for x in r["launches"])}
    out = dict(kernels=kernels, coca_fsdp=coca_fsdp, tp=tp,
               k1_launches=k1, k2_launches=k2,
               launches={k: tp["launches"][k] for k in ("K3", "K4", "K5",
                                                        "K6")},
               fuse_tp_launches={k: sum(x[k] for r in tp["fuse"]
                                        for x in r["launches"])
                                 for k in ("K5", "K6")},
               parts_s=parts, phase_s=time.perf_counter() - t0)
    print(f"[slice16] phase 22 in {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items()) + ")")
    return out


# phase 23: the last surface of the JAX package that needs no download.
# (a) the native data path's build (before phase 12, whose trainer reads
# through it); (b) the decode split; (c) the loader alone with and without
# it; (d) ViT-B-16-SigLIP at full width from a big_vision file; (e) K1 and
# K2 at the SigLIP towers' geometries
SIGLIP_MODEL = "ViT-B-16-SigLIP"
SIGLIP_SEED = 23
SIGLIP_CONTEXT = 64
# (label, B, L, 3D, heads, causal): the vision tower (no CLS token) at the
# serving and step batch, the text tower (no causal mask) at the serving
# batch for K1 and at the step's for K2
SIGLIP_K1_GEOMETRIES = (
    ("vision ViT-B-16-SigLIP 224px", 64, 196, 3 * 768, 12, False),
    ("text ViT-B-16-SigLIP 64 tokens", 256, 64, 3 * 768, 12, False))
SIGLIP_K2_GEOMETRIES = (
    ("vision ViT-B-16-SigLIP 224px", 64, 196, 3 * 768, 12, False),
    ("text ViT-B-16-SigLIP 64 tokens", 64, 64, 3 * 768, 12, False))
SIGLIP_CALL_K1 = {"image": 12, "text": 12}
SIGLIP_STEP_BATCH = 64
SIGLIP_STEPS = (2, 8)         # 23(d): warm-up and timed steps
SIGLIP_SMALL = 2              # layers a tower of 23(d)'s float32 checks
SIGLIP_STEP_RTOL = 1e-4
SIGLIP_VOCAB = 32000          # its SentencePiece vocabulary
DECODE_IMAGES = (8, 12)       # 23(b): shards x JPEGs, short side 1024-1600
DECODE_SIDES = (1024, 1600)
DECODE_FULL_CROPS = 16        # 23(b): JPEGs whose full-size decode is cropped
# 23(c): (batch, batches timed after the first) on phase 12's shards and on
# (b)'s; a worker batches within an epoch, so (b)'s 12 JPEGs a shard take
# batches of 12
NATIVE_LOADER_RUNS = {"256-640 px": (TRAINER_BATCH, 7),
                      "1024-1600 px": (12, 14)}


def big_vision_state_dict(seed: int, width: int = 768, layers: int = 12,
                          heads: int = 12, patch: int = 16, grid: int = 14,
                          vocab: int = 32000, ctx: int = 64,
                          mlp: int = 3072) -> dict:
    """ViT-B-16-SigLIP's weights in big_vision's layout (``params/img/...``,
    ``params/txt/...``, ``t``, ``b``), float32 normals from ``seed``."""
    rng = np.random.default_rng(seed)
    hd = width // heads
    sd = {}

    def put(name, *shape, scale=0.02, shift=0.0):
        a = rng.standard_normal(shape, dtype=np.float32)
        a *= np.float32(scale)
        sd[f"params/{name}"] = a + np.float32(shift)

    def attention(p):
        for n in ("query", "key", "value"):
            put(f"{p}/{n}/kernel", width, heads, hd)
            put(f"{p}/{n}/bias", heads, hd)
        put(f"{p}/out/kernel", heads, hd, width)
        put(f"{p}/out/bias", width)

    def ln(p):
        put(f"{p}/scale", width, shift=1.0)
        put(f"{p}/bias", width)

    def mlp_block(p):
        put(f"{p}/Dense_0/kernel", width, mlp)
        put(f"{p}/Dense_0/bias", mlp)
        put(f"{p}/Dense_1/kernel", mlp, width)
        put(f"{p}/Dense_1/bias", width)

    def encoder(p):
        for i in range(layers):
            b = f"{p}/encoderblock_{i}"
            ln(f"{b}/LayerNorm_0")
            ln(f"{b}/LayerNorm_1")
            attention(f"{b}/MultiHeadDotProductAttention_0")
            mlp_block(f"{b}/MlpBlock_0")
        ln(f"{p}/encoder_norm")

    put("img/embedding/kernel", patch, patch, 3, width)
    put("img/embedding/bias", width)
    put("img/pos_embedding", 1, grid * grid, width)
    encoder("img/Transformer")
    put("img/MAPHead_0/probe", 1, 1, width)
    attention("img/MAPHead_0/MultiHeadDotProductAttention_0")
    ln("img/MAPHead_0/LayerNorm_0")
    mlp_block("img/MAPHead_0/MlpBlock_0")
    put("txt/Embed_0/embedding", vocab, width)
    put("txt/pos_embedding", 1, ctx, width)
    encoder("txt/Encoder_0")
    put("txt/head/kernel", width, width)
    put("txt/head/bias", width)
    sd["params/t"] = np.asarray([np.log(10.0)], np.float32)
    sd["params/b"] = np.asarray([-10.0], np.float32)
    return sd


def phase_native_build() -> dict:
    """23(a): build (or find) the native data path's library, as the loader's
    parent does, and name the compiler, the headers and libjpeg."""
    from cosmos_tpu_torch.data import native

    t0 = time.perf_counter()
    path = native.library_path()
    built = not path.exists()
    native.load()
    seconds = time.perf_counter() - t0
    compiler = subprocess.run(["g++", "--version"], capture_output=True,
                              text=True).stdout.splitlines()[0]
    libjpeg = native.find_libjpeg()
    headers = (native.JPEG_INCLUDE / "jconfig.h").read_text()
    version = next(line.split()[-1] for line in headers.splitlines()
                   if line.startswith("#define LIBJPEG_TURBO_VERSION "))
    out = dict(seconds=seconds, built=built, compiler=compiler,
               libjpeg=libjpeg, headers=str(native.JPEG_INCLUDE.relative_to(
                   ROOT)), headers_version=f"libjpeg-turbo {version}",
               library=path.name)
    print(f"[native] {'built' if built else 'found'} {path.name} in "
          f"{seconds:.2f} s: {compiler}; headers {out['headers']} "
          f"({out['headers_version']}, JPEG_LIB_VERSION 62); libjpeg "
          f"{libjpeg}")
    return out


def _decode_split(shards) -> dict:
    """23(b): ms per sample of PIL's decode, the native decode at the
    loader's DCT scale (min_size 2 x 224) and the multi-crop transform (2 x
    224 + 6 x 96) on each; and whether the native decode at denominator 1
    gives PIL's bits."""
    import io
    import random

    from PIL import Image

    from cosmos_tpu_torch.data import native
    from cosmos_tpu_torch.data.loader import WdsTrainConfig, train_transform
    from cosmos_tpu_torch.data.webdataset import tar_to_samples

    jpegs = [s["jpg"] for shard in shards for s in tar_to_samples(shard)]
    transform = train_transform(WdsTrainConfig(urls=[]))
    lib = native.load()

    def pil(data):
        img = Image.open(io.BytesIO(data))
        img.load()
        return img

    def timed(fn, items):
        t0 = time.perf_counter()
        out = [fn(x) for x in items]
        return out, (time.perf_counter() - t0) / len(items) * 1e3

    full, pil_ms = timed(pil, jpegs)
    scaled, native_ms = timed(lambda d: native.decode_jpeg_scaled(d, 448),
                              jpegs)
    denoms = [native.scale_denom(lib, d, 448) for d in jpegs]
    rng = random.Random(SIGLIP_SEED)
    _, crop_scaled_ms = timed(lambda a: transform(Image.fromarray(a), rng),
                              scaled)
    _, crop_full_ms = timed(lambda img: transform(img, rng),
                            full[:DECODE_FULL_CROPS])
    same = sum(np.array_equal(native.decode_jpeg_scaled(d),
                              np.asarray(img.convert("RGB")))
               for d, img in zip(jpegs, full))
    check(all(min(a.shape[:2]) >= 448 for a in scaled),
          "the DCT-scaled decode keeps the short side >= 448")
    out = dict(images=len(jpegs), pil_ms=pil_ms, native_ms=native_ms,
               denominators={str(d): denoms.count(d) for d in set(denoms)},
               crop_native_ms=crop_scaled_ms, crop_full_ms=crop_full_ms,
               denom1_equal_pil=same)
    print(f"[native] decode of {len(jpegs)} JPEGs (short side "
          f"{DECODE_SIDES[0]}-{DECODE_SIDES[1]} px, 4:2:0, q 90): PIL "
          f"{pil_ms:.3f} ms, native at 1/{max(denoms)}-1/{min(denoms)} "
          f"{native_ms:.3f} ms a sample; the multi-crop transform "
          f"{crop_scaled_ms:.3f} ms on the scaled decode, {crop_full_ms:.3f} "
          f"ms on PIL's (the first {DECODE_FULL_CROPS}); native at 1/1 gives "
          f"PIL's bits for {same} of "
          f"{len(jpegs)}")
    return out


def _native_loader_rate(argv, use_native_io: bool, batches: int) -> dict:
    """The trainer's loader for ``argv`` with ``use_native_io`` set: time to
    the first batch, then samples/s over ``batches`` more, timed after one
    batch a worker has been taken (the batches the workers queued while
    the first was awaited would time the queue, not the workers)."""
    import dataclasses

    from cosmos_tpu_torch.data.loader import WdsTrainLoader
    from cosmos_tpu_torch.models.factory import get_tokenizer
    from cosmos_tpu_torch.training.data_pipeline import get_data
    from cosmos_tpu_torch.training.params import parse_args

    made = get_data(parse_args(argv), get_tokenizer("ViT-B-16"))
    cfg = dataclasses.replace(made["train"].dataloader.cfg,
                              use_native_io=use_native_io)
    loader = WdsTrainLoader(cfg)
    try:
        with _as_main_module("cosmos_tpu_torch.training.main"):
            t0 = time.perf_counter()
            it = iter(loader)
            next(it)
        first_s = time.perf_counter() - t0
        for _ in range(cfg.num_workers):
            next(it)
        t1 = time.perf_counter()
        for _ in range(batches):
            next(it)
        seconds = time.perf_counter() - t1
    finally:
        loader.shutdown()
    return dict(first_batch_s=first_s, workers=cfg.num_workers,
                batch=cfg.batch_size, batches=batches,
                samples_per_s=batches * cfg.batch_size / seconds)


def _native_loaders(data: str, workers: int, big: str, logs: str) -> dict:
    """23(c): the loader alone, native and not, on phase 12's shards
    (256-640 px: no DCT scale engages) and on (b)'s (1024-1600 px)."""
    base = _trainer_argv(data, logs, workers)
    argvs = {"256-640 px": base, "1024-1600 px": _drop_flags(
        base, values=("--train-data",)) + [
        "--train-data",
        f"{big}/big-{{0000..{DECODE_IMAGES[0] - 1:04d}}}.tar"]}
    out = {}
    for name, argv in argvs.items():
        batch, batches = NATIVE_LOADER_RUNS[name]
        argv = _drop_flags(argv, values=("--batch-size",)) + [
            "--batch-size", str(batch)]
        for use in (True, False):
            key = f"{name} {'native' if use else 'PIL'}"
            out[key] = _native_loader_rate(argv, use, batches)
            print(f"[native] loader alone, {key}: "
                  f"{out[key]['samples_per_s']:.1f} samples/s "
                  f"({out[key]['workers']} workers, {batches} batches of "
                  f"{batch}), first batch after "
                  f"{out[key]['first_batch_s']:.2f} s")
    return out


def _siglip_load(path: str) -> tuple:
    """23(d): ViT-B-16-SigLIP in bf16 from the big_vision file through the
    load path: the model built on the CPU, the file read, converted and
    loaded (``load_checkpoint``), the weights moved to the card, each
    timed; its weights the file's."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.models.checkpoint import load_checkpoint

    t0 = time.perf_counter()
    model = create_model(SIGLIP_MODEL, "bf16", device="cpu", seed=SIGLIP_SEED)
    t1 = time.perf_counter()
    load_checkpoint(model, path)
    t2 = time.perf_counter()
    model = model.to("cuda")
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    with np.load(path) as f:
        probe = f["params/img/MAPHead_0/probe"]
        head = f["params/txt/head/kernel"]
    check(torch.equal(model.visual.attn_pool.probe.cpu(),
                      torch.from_numpy(probe))
          and torch.equal(model.text_projection.weight.cpu(),
                          torch.from_numpy(head).t())
          and model.logit_bias.item() == -10.0,
          "the SigLIP model holds the big_vision file's weights")
    n = sum(p.numel() for p in model.parameters())
    gb = Path(path).stat().st_size / 1e9
    out = dict(build_s=t1 - t0, load_s=t2 - t1, to_card_s=t3 - t2,
               params=n, file_gb=gb)
    print(f"[siglip] {SIGLIP_MODEL} ({n / 1e6:.2f} M parameters): built in "
          f"{out['build_s']:.2f} s, a big_vision npz of {gb:.2f} GB read, "
          f"converted and loaded in {out['load_s']:.2f} s, moved to the card "
          f"in {out['to_card_s']:.2f} s")
    return model, out


def _siglip_tokens(n: int, seed: int) -> np.ndarray:
    """n captions of SIGLIP_CONTEXT ids below SIGLIP_VOCAB (the tower pools
    the last position, so every position holds a token)."""
    rng = np.random.default_rng(seed)
    return rng.integers(1, SIGLIP_VOCAB, (n, SIGLIP_CONTEXT)).astype(np.int64)


def _siglip_batch(b, seed, device, size=224):
    """One global crop and one caption view of ``b`` rows."""
    rng = np.random.default_rng(seed)
    return {"global_images": torch.from_numpy(rng.integers(
                0, 256, (1, b, size, size, 3), np.uint8)).to(device),
            "texts": torch.from_numpy(_siglip_tokens(b, seed)[None]).to(
                device)}


def _siglip_step(K, model) -> dict:
    """23(d): the --siglip step at full width in bf16, batch 64, one fixed
    uint8 batch (one crop, one caption): warm-up and timed steps with CUDA
    events, exactly 12 K1 and 12 K2 a tower a step, finite losses."""
    from cosmos_tpu_torch import (create_optimizer, create_train_state,
                                  make_train_step)
    from cosmos_tpu_torch.training.scheduler import const_lr
    from cosmos_tpu_torch.training.train import TrainStepConfig

    model.train()
    lr = const_lr(1e-4, 0, 100)
    opt = create_optimizer(model, lr, beta1=0.9, beta2=0.98, eps=1e-8,
                           weight_decay=0.1)
    cfg = TrainStepConfig(cosmos=False, siglip=True, momentum_teacher=0.999,
                          fix_momentum=True, lr_schedule=lr,
                          input_dtype=torch.bfloat16)
    step = make_train_step(model, opt, cfg)
    state = create_train_state(model, opt)
    batch = _siglip_batch(SIGLIP_STEP_BATCH, SIGLIP_SEED + 3, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    zero_launches(K)
    for i in range(sum(SIGLIP_STEPS)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        m = step(state, batch)
        end.record()
        losses.append(m["loss"].item())
        if i >= SIGLIP_STEPS[0]:
            ms.append(start.elapsed_time(end))
    n = sum(SIGLIP_STEPS)
    launches = read_launches(K)
    want = {**dict.fromkeys(launches, 0), "K1": 24 * n, "K2": 24 * n}
    check(launches == want, f"SigLIP step launches {launches}, expected "
          f"{want}")
    check(all(np.isfinite(losses)), f"SigLIP step losses finite: {losses}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out = dict(losses=losses, step_ms=ms, step_ms_median=float(np.median(ms)),
               step_ms_mean=float(np.mean(ms)), peak_mem_gb=peak,
               samples_per_s=SIGLIP_STEP_BATCH / float(np.median(ms)) * 1e3,
               launches=launches)
    print(f"[siglip] --siglip step bf16 batch {SIGLIP_STEP_BATCH}: losses "
          f"{' '.join(f'{x:.5f}' for x in losses)}; ms per step median "
          f"{out['step_ms_median']:.3f} mean {out['step_ms_mean']:.3f} "
          f"({out['samples_per_s']:.1f} samples/s); peak memory {peak:.2f} "
          f"GB; K1/K2 24/24 a step")
    del step, state, opt
    return out


def _siglip_card_vs_cpu() -> dict:
    """23(d): a 2-layer float32 ViT-B-16-SigLIP on the card and on the CPU
    from the same weights: the normalised features of 2 images and 4
    captions, then one --siglip step at batch 2 (loss, gradients, the
    updated student and teacher)."""
    from cosmos_tpu_torch import create_model

    cpu = create_model(SIGLIP_MODEL, "fp32", device="cpu",
                       seed=SIGLIP_SEED + 4, vision_layers=SIGLIP_SMALL,
                       text_layers=SIGLIP_SMALL)
    gpu = copy.deepcopy(cpu).to("cuda")
    n_img, n_txt = WEIGHTS_CPU
    rng = np.random.default_rng(SIGLIP_SEED + 5)
    x = torch.from_numpy(rng.standard_normal((n_img, 224, 224, 3))
                         .astype(np.float32))
    toks = torch.from_numpy(_siglip_tokens(n_txt, SIGLIP_SEED + 5))
    errs = {}
    for what, fn, inp in (("image", "encode_image", x),
                          ("text", "encode_text", toks)):
        with torch.inference_mode():
            key = f"{what}_features"
            w = getattr(cpu, fn)(inp, True)[key]
            g = getattr(gpu, fn)(inp.cuda(), True)[key].cpu()
        check(g.shape == w.shape and torch.isfinite(g).all().item(),
              f"SigLIP {what} features shape/finite")
        errs[what] = (g - w).abs().max().item()
        check(errs[what] <= WEIGHTS_CPU_TOL,
              f"SigLIP card vs CPU {what}: max err {errs[what]}")
    lr = 1e-4
    small = _siglip_batch(2, SIGLIP_SEED + 6, "cpu")
    cfg_kw = dict(cosmos=False, siglip=True)
    want = _step_run(cpu.train(), cfg_kw, small, lr)
    got = _step_run(gpu.train(), cfg_kw, small, lr)
    check((got["K1"], got["K2"]) == (2 * SIGLIP_SMALL, 2 * SIGLIP_SMALL),
          f"2-layer SigLIP step: K1/K2 {got['K1']}/{got['K2']}")
    errs["loss"] = abs(got["loss"] - want["loss"]) / abs(want["loss"])
    check(errs["loss"] <= SIGLIP_STEP_RTOL,
          f"SigLIP loss card {got['loss']} vs CPU {want['loss']}")
    errs["grads"] = _grad_errs(got["grads"], want["grads"], SIGLIP_STEP_RTOL,
                               1e-8, "SigLIP 2-layer step")
    for which in ("student", "teacher"):
        errs[which] = max((got[which][k] - want[which][k]).abs().max().item()
                          for k in want[which])
        check(errs[which] <= 2 * lr,
              f"SigLIP updated {which} card vs CPU: max err {errs[which]}")
    print(f"[siglip] 2-layer float32 card vs CPU: features image "
          f"{errs['image']:.3g} text {errs['text']:.3g}; step loss rel err "
          f"{errs['loss']:.3g}, max grad err {errs['grads']:.3g}, updated "
          f"student {errs['student']:.3g} teacher {errs['teacher']:.3g}")
    return errs


def _siglip_kernel_rows(fa) -> tuple:
    """23(e): K1 and K2 held to their plain versions, with the same bits on
    a repeat, and timed beside the plain version, SDPA and the bound, at
    the SigLIP towers' geometries in both dtypes."""
    gen = torch.Generator(device="cuda").manual_seed(SIGLIP_SEED)
    rows = []
    for label, b, l, d3, heads, causal in SIGLIP_K1_GEOMETRIES:
        check(fa.supported(heads, d3 // 3, l, 2) and fa.supported(
            heads, d3 // 3, l, 4), f"K1's gate admits {label}")
        for dtype in (torch.float32, torch.bfloat16):
            rows.append(kernel_row(fa, label, b, l, d3, heads, causal, dtype,
                                   gen))
            x = torch.randn(b, l, d3, device="cuda", generator=gen).to(dtype)
            _same_bits(f"K1 at {label} {dtype}",
                       [fa.fused_attention_qkv(x, heads, causal)],
                       [fa.fused_attention_qkv(x, heads, causal)])
    bwd = [kernel_bwd_row(fa, label, b, l, d3, heads, causal, dtype, gen)
           for label, b, l, d3, heads, causal in SIGLIP_K2_GEOMETRIES
           for dtype in (torch.float32, torch.bfloat16)]
    return rows, bwd


def phase_siglip(K, native_build: dict, data: str, workers: int,
                 tmp: str) -> dict:
    """Phase 23: (e) K1/K2 at the SigLIP geometries first, then (b) the
    decode split, (c) the loader alone, (d) ViT-B-16-SigLIP at full width
    (the big_vision load, serving, the --siglip step, card against CPU);
    (a), the native build, ran before phase 12."""
    from cosmos_tpu_torch.data.synthetic import write_shards

    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parts = {}

    def done(part):
        parts[part] = time.perf_counter() - t0 - sum(parts.values())

    rows, bwd_rows = _siglip_kernel_rows(K.fa)
    done("kernels")
    big = f"{tmp}/native_big"
    shards = write_shards(big + "/big-{i:04d}.tar", *DECODE_IMAGES,
                          seed=SIGLIP_SEED, size_range=DECODE_SIDES)
    done("JPEGs written")
    decode = _decode_split(shards)
    done("decode split")
    loaders = _native_loaders(data, workers, big, f"{tmp}/native_logs")
    done("loader alone")
    path = f"{tmp}/siglip_big_vision.npz"
    np.savez(path, **big_vision_state_dict(SIGLIP_SEED))
    done("big_vision file written")
    model, load = _siglip_load(path)
    Path(path).unlink()
    done("load")
    serve, k1_serve = _weights_serve(
        K, model, 224, SIGLIP_CALL_K1, SIGLIP_MODEL, SIGLIP_SEED + 1,
        length=SIGLIP_CONTEXT, tag="siglip",
        captions=_siglip_tokens(WEIGHTS_CAPTIONS, SIGLIP_SEED + 1))
    done("serving")
    step = _siglip_step(K, model)
    del model
    torch.cuda.empty_cache()
    done("step")
    zero_launches(K)
    card_vs_cpu = _siglip_card_vs_cpu()
    small = read_launches(K)
    done("card vs CPU")
    k1 = {"SigLIP serving": k1_serve, "SigLIP step": step["launches"]["K1"],
          "SigLIP 2-layer card vs CPU": small["K1"]}
    k2 = {"SigLIP step": step["launches"]["K2"],
          "SigLIP 2-layer card vs CPU": small["K2"]}
    # the launches at each kernel row's geometry, all bf16: the image calls
    # and the step's vision tower; the text calls (256 captions); the
    # step's towers for K2
    steps = sum(SIGLIP_STEPS)
    by_geometry = {
        "K1 vision": serve["k1_launches"]["image"] + 12 * steps,
        "K1 text": serve["k1_launches"]["text"],
        "K2 vision": 12 * steps, "K2 text": 12 * steps}
    out = dict(native_build=native_build, decode=decode,
               loader_alone=loaders, load=load, serving=serve, step=step,
               card_vs_cpu=card_vs_cpu, kernel_rows=rows,
               kernel_bwd_rows=bwd_rows, k1_launches=k1, k2_launches=k2,
               launches_by_geometry=by_geometry, parts_s=parts,
               phase_s=time.perf_counter() - t0)
    print(f"[siglip] phase 23 in {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())
          + "); K1 launches " + " ".join(f"{k}={v}" for k, v in k1.items())
          + "; K2 launches " + " ".join(f"{k}={v}" for k, v in k2.items()))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == [DP_RANK_FLAG]:
        return dp_rank(sys.argv[2], sys.argv[3:])
    if sys.argv[1:2] == [K5_AGAINST_FLAG]:
        return k5_against(sys.argv[2])
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
    # 23(a): every trainer from phase 12 on reads through the native path
    native_build = phase_native_build()
    with tempfile.TemporaryDirectory(prefix="cosmos_trainer_") as work:
        trainer = phase_trainer(K, work)
        with tempfile.TemporaryDirectory(prefix="cosmos_evals_") as tmp:
            ckpt = _eval_checkpoint(f"{tmp}/vit_b_16_cosmos.pt")
            classification = phase_classification(K, ckpt)
            segmentation = phase_segmentation(K, ckpt)
        options = phase_trainer_options(K, card, trainer, work)
        data_parallel = phase_data_parallel(K, trainer["data_dir"], work)
        towers = phase_towers(K, trainer["data_dir"], trainer["workers"],
                              work)
        beyond = phase_beyond_dp(K, trainer["data_dir"], work)
        # phase 12 left its last checkpoint in work/weights_cache
        weights = phase_weights_in(K, trainer["data_dir"],
                                   f"{work}/weights_cache", work)
        coca = phase_coca(K, trainer["data_dir"], trainer["workers"], work)
        slice16 = phase_slice16(K, trainer["data_dir"], trainer["workers"],
                                work)
        siglip = phase_siglip(K, native_build, trainer["data_dir"],
                              trainer["workers"], work)
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

    # phase 19: the FSDP steps and trainer (its steps and evals) in this
    # process, the TP and multislice ranks' own counts
    fsdp_runs = [r["fsdp"] for k, r in beyond["fsdp"].items()
                 if k != "trainer"]
    beyond_k = {k: sum(n[k] for r in fsdp_runs for n in r["launches"])
                + beyond["fsdp"]["trainer"]["launches"][k]
                + beyond["gloo"][f"{k.lower()}_launches"]
                for k in ("K1", "K2")}
    beyond_k["K1"] += beyond["fsdp"]["trainer"]["eval_k1"]

    def pick(table, geometry, **match):
        label, dtype = geometry
        return next(r for r in table if (r["label"], r["dtype"]) == (
            label, str(dtype).replace("torch.", ""))
            and all(r.get(k) == v for k, v in match.items()))

    l14_image_k1 = weights["openai_l14"]["serve"]["k1_launches"]["image"]
    check(l14_image_k1 > 0, "K1 never launched at ViT-L-14's geometry")
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
        + sum(last_k1.values()) + sum(towers["k1_launches"].values())
        + beyond_k["K1"] + sum(weights["k1_launches"].values())
        + sum(coca["k1_launches"].values())
        + sum(slice16["k1_launches"].values())
        + sum(siglip["k1_launches"].values()),
        "launches_by_path": {"serving": serving["launches"],
                             "training": train["k1_launches"],
                             **{f"training {s}": r["launches"]["K1"]
                                for s, r in train_ln.items()},
                             "trainer": trainer["launches"]["K1"],
                             "classification":
                                 classification["launches"]["K1"],
                             "segmentation": seg_k1,
                             "trainer options": options["launches"]["K1"],
                             "data parallel": dp_k1, **last_k1,
                             **towers["k1_launches"],
                             "beyond DP": beyond_k["K1"],
                             **{f"weights in {k}": v for k, v in
                                weights["k1_launches"].items()},
                             **coca["k1_launches"],
                             **slice16["k1_launches"],
                             **siglip["k1_launches"]},
        **{k: k1_row[k] for k in attention_keys},
    }, {
        # K1 at ViT-L-14's geometry (16 heads, D 1024): phase 20(a)'s
        # image calls are its main path
        "name": "fused_attention_qkv_fwd_vit_l14",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_fwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:101",
        "launches": l14_image_k1,
        "launches_by_path": {"weights in ViT-L-14 image calls":
                             l14_image_k1},
        **{k: pick(weights["kernel_rows"], (L14_GEOMETRY[0],
                                            torch.bfloat16))[k]
           for k in attention_keys},
    }, {
        "name": "fused_attention_qkv_bwd",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_bwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:190",
        "launches": train["k2_launches"] + sum(
            r["launches"]["K2"] for r in train_ln.values())
        + trainer["launches"]["K2"] + options["launches"]["K2"]
        + data_parallel["world1"]["launches"]["K2"]
        + last["launches"]["K2"] + sum(towers["k2_launches"].values())
        + beyond_k["K2"] + sum(coca["k2_launches"].values())
        + sum(slice16["k2_launches"].values())
        + sum(siglip["k2_launches"].values()),
        "launches_by_path": {"training": train["k2_launches"],
                             **{f"training {s}": r["launches"]["K2"]
                                for s, r in train_ln.items()},
                             "trainer": trainer["launches"]["K2"],
                             "trainer options": options["launches"]["K2"],
                             "data parallel":
                                 data_parallel["world1"]["launches"]["K2"],
                             "last flags trainer": last["launches"]["K2"],
                             **towers["k2_launches"],
                             "beyond DP": beyond_k["K2"],
                             **coca["k2_launches"],
                             **slice16["k2_launches"],
                             **siglip["k2_launches"]},
        **{k: k2_row[k] for k in attention_keys},
    }]
    # K1 and K2 at the SigLIP towers' geometries (phase 23): the bf16
    # serving calls and the --siglip step at each
    by_geometry = siglip["launches_by_geometry"]
    for key, name, source, replaces, table, (label, *_) in (
            ("K1 vision", "fused_attention_qkv_fwd_siglip_vision",
             "fused_attention_fwd.cu", "cosmos_tpu/ops/fused_attention.py:101",
             siglip["kernel_rows"], SIGLIP_K1_GEOMETRIES[0]),
            ("K1 text", "fused_attention_qkv_fwd_siglip_text",
             "fused_attention_fwd.cu", "cosmos_tpu/ops/fused_attention.py:101",
             siglip["kernel_rows"], SIGLIP_K1_GEOMETRIES[1]),
            ("K2 vision", "fused_attention_qkv_bwd_siglip_vision",
             "fused_attention_bwd.cu", "cosmos_tpu/ops/fused_attention.py:190",
             siglip["kernel_bwd_rows"], SIGLIP_K2_GEOMETRIES[0]),
            ("K2 text", "fused_attention_qkv_bwd_siglip_text",
             "fused_attention_bwd.cu", "cosmos_tpu/ops/fused_attention.py:190",
             siglip["kernel_bwd_rows"], SIGLIP_K2_GEOMETRIES[1])):
        n = by_geometry[key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cosmos_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": n,
            "launches_by_path": {f"SigLIP serving and step, {key}": n},
            **{k: pick(table, (label, torch.bfloat16))[k]
               for k in attention_keys}})
        check(n > 0, f"{key} never launched at the SigLIP geometry")
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
        # phase 22's ranks: fuse_ln under TP, full width and 2 layers
        by_path["fuse_ln under TP"] = slice16["launches"][key]
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
    # K5 and K6 on a rank's shard under tensor parallelism (phase 22):
    # their launches in 22(b)'s full-width steps, each at the shard's width
    for key, name, source, replaces, shape in (
            ("K5", "ln_matmul_fwd_tp_shard", "ln_matmul.cu",
             "cosmos_tpu/ops/experimental/ln_matmul.py:59",
             [TP_MAIN_ROWS, 768, 1152]),
            ("K6", "mlp_block_fwd_tp_shard", "mlp_block.cu",
             "cosmos_tpu/ops/experimental/mlp_block.py:70",
             [TP_MAIN_ROWS, *K6_TP_SHAPE])):
        row = next(r for r in slice16["kernels"]["rows"]
                   if r["kernel"] == key and r["shape"] == shape)
        n = slice16["fuse_tp_launches"][key]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"cosmos_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "launches": n,
            "launches_by_path": {"fuse_ln under TP, full width": n},
            **{k: row[k] for k in keys + ("x_bound", "x_library")}})
        check(n > 0, f"{key} never launched on a tensor-parallel shard")
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
                  towers=towers, beyond_dp=beyond, weights_in=weights,
                  coca=coca, slice16=slice16, siglip=siglip,
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
