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
     register and spill lines;
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
     activation), checks that two launches of K5 and of K6 give the same
     bits, and times each beside its plain version, the stock composition
     as a yardstick (F.layer_norm, its autograd backward, F.layer_norm +
     F.linear, F.layer_norm + F.linear + F.gelu + F.linear), its bound and,
     for K5/K6 in bfloat16, the time before the Hopper redesign; then holds
     K5 and K6 to their plain versions at ragged row counts (R = 1, 63,
     65, 130, 7392) in both dtypes, with the same bits on a repeat;
 10. trains full-width ViT-B-16 COSMOS in bfloat16 (phase 7's recipe) for
     3 + 5 steps under each setting of the fused-LayerNorm paths: (a)
     layers.FUSED_LN, (b) layers.HYBRID_LN, (c) fuse_ln=True with
     FUSED_LN; checks finite, falling losses, the clamps, every student
     gradient and the exact launches of K1-K6 per step (derived from the
     step's tower calls), holds (c)'s 8th loss within 1e-3 of the loss
     before the K5/K6 redesign, and prints ms per step, samples/s, peak
     memory and a profile beside phase 7's step;
 11. repeats phase 8's 2-layer float32 step, card against CPU, under each
     of (a)-(c).

Any failed check raises, so the script exits non-zero.  The last lines are
the card's name and power limit, one JSON object with the kernel records,
and {"ok": true, "device": {...}}.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

import contextlib
import copy
import json
import subprocess
import sys
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
# K5 and K6 in bfloat16 before the Hopper redesign, ms per call at each
# geometry (PERF.md, PR 3's kernel table: the mma.sync kernels, NVIDIA H100
# 80GB HBM3 at 700 W); printed beside this run's times, not checked
PREV_LN_BF16_MS = {
    ("K5", "vision globals"): 1.3405, ("K6", "vision globals"): 5.7767,
    ("K5", "vision 96px locals"): 0.7677, ("K6", "vision 96px locals"): 4.6423,
    ("K5", "text head views"): 0.2381, ("K6", "text head views"): 1.3606,
    ("K5", "text short bucket"): 0.2352, ("K6", "text short bucket"): 1.3419,
    ("K5", "text long quarter"): 0.1915, ("K6", "text long quarter"): 0.9209,
}
# row counts on both sides of K5's 128-row and K6's 64-row tiles, and one
# that is not a multiple of either cluster's rows; checked, not timed
LN_RAGGED_ROWS = (1, 63, 65, 130, 7392)
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


def phase_kernel(fa):
    """K1 against its plain version, and times, at every geometry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, b, l, d3, heads, causal in GEOMETRIES:
        for dtype in (torch.float32, torch.bfloat16):
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
                lambda: fa.fused_attention_qkv_reference(x, heads, causal),
                iters=5)
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal))
            bound_ms, bound_by, nbytes, ops = attention_bound(
                b, l, d, causal, dtype)
            row = dict(label=label, shape=[b, l, d3], heads=heads,
                       causal=causal, dtype=str(dtype).replace("torch.", ""),
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       library_ms=library_ms, bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes, ops=ops,
                       tflops=ops / ms / 1e9,
                       x_bound=ms / bound_ms, x_library=ms / library_ms)
            rows.append(row)
            print(f"[kernel] {label:28s} {row['dtype']:8s} [{b},{l},{d3}] "
                  f"h={heads} causal={int(causal)} err={err:.3g} "
                  f"K1={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms sdpa={library_ms:.4f} ms "
                  f"bound={bound_ms:.4f} ms ({bound_by}) "
                  f"x{row['x_bound']:.1f} bound x{row['x_library']:.2f} sdpa "
                  f"{row['tflops']:.1f} TFLOP/s")
            del x, got, want, q, k, v
    return rows


def _held(what: str, got, want, tol) -> float:
    ok, err = _within(got, want, tol)
    check(ok, f"{what}: max err {err} (tolerance {tol})")
    return err


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
        rows.append(row)
        print(f"[ln-kernels] {kernel} {label:18s} {row['dtype']:8s} "
              f"{list(shape)} {extra.get('act', '')} err "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
              + f" | {kernel}={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"stock={library_ms:.4f} ms bound={bound_ms:.4f} ms "
              f"({bound_by}, x{row['x_bound']:.1f}, "
              f"x{row['x_library']:.2f} stock)"
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
            out = K.lm.ln_matmul_fwd(x2, s, sh, w, bias)
            want = K.lm.ln_matmul_reference(x2, s, sh, w, bias)
            torch.cuda.synchronize()
            errs = {"out": _held(f"K5 {label} {dtype}", out, want, tol)}
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
            del out, want, w

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


def phase_ln_ragged(K):
    """K5 and K6 against their plain versions at row counts that end
    inside, on or one past their row tiles, at both widths and in both
    dtypes, with the same bits on a repeat."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    errs = {}
    for d in (768, 512):
        for r in LN_RAGGED_ROWS:
            for dtype in (torch.float32, torch.bfloat16):
                def rand(*shape, scale=1.0, shift=0.0, dt=torch.float32):
                    return (torch.randn(*shape, device="cuda", generator=gen)
                            * scale + shift).to(dt)
                tol = LN_TOL[dtype]
                what = f"R={r} D={d} {str(dtype).replace('torch.', '')}"
                x = rand(r, d, scale=2.0, shift=0.5, dt=dtype)
                s, sh = rand(d, shift=1.0), rand(d)
                w = rand(3 * d, d, scale=d ** -0.5, dt=dtype)
                bias = rand(3 * d).to(dtype).float()
                got = K.lm.ln_matmul_fwd(x, s, sh, w, bias)
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
                errs[what] = {"K5": k5, "K6": k6}
    print("[ln-ragged] K5/K6 max abs err " + " ".join(
        f"{k}: {v['K5']:.3g}/{v['K6']:.3g}" for k, v in errs.items()))
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


def phase_kernel_bwd(fa):
    """K2 against its plain version and timed, K1 timed, at the training
    geometries; the autograd Function on the card against the CPU."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(10)
    rows = []
    for label, b, l, d3, heads, causal in TRAIN_GEOMETRIES:
        d = d3 // 3
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(b, l, d3, device="cuda", generator=gen).to(dtype)
            g = torch.randn(b, l, d, device="cuda", generator=gen).to(dtype)
            got = fa.fused_attention_qkv_backward(x, g, heads, causal)
            again = fa.fused_attention_qkv_backward(x, g, heads, causal)
            want = fa.fused_attention_qkv_backward_reference(x, g, heads,
                                                             causal)
            torch.cuda.synchronize()
            ok, err = _within(got, want, KERNEL_BWD_TOL[dtype])
            check(ok, f"K2 vs plain at {label} {dtype}: max err {err}")
            # no atomics and a fixed order of sums: the same bits every time
            check(torch.equal(got, again),
                  f"K2 repeated at {label} {dtype}: results differ")
            del again
            ms = time_ms(lambda: fa.fused_attention_qkv_backward(
                x, g, heads, causal))
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
            rows.append(row)
            print(f"[kernel-bwd] {label:20s} {row['dtype']:8s} [{b},{l},{d3}] "
                  f"h={heads} causal={int(causal)} err={err:.3g} "
                  f"K2={ms:.4f} ms "
                  f"plain={plain_ms:.4f} ms sdpa-bwd={library_ms:.4f} ms "
                  f"bound={bound_ms:.4f} ms ({bound_by}) "
                  f"x{row['x_bound']:.1f} bound x{row['x_library']:.2f} sdpa "
                  f"{row['tflops']:.1f} TFLOP/s K1={fwd_ms:.4f} ms")
            del x, g, got, want, q, k, v, o, g_heads

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
    ("K3", ("layer_norm_fwd_kernel",)),
    ("K4", ("layer_norm_bwd_rows_kernel", "layer_norm_bwd_reduce_kernel")),
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


def step_launches(setting, layers: int, b: int) -> dict:
    """Launches of K1-K6 in one training step of the recipe at per-card
    batch ``b`` with ``layers`` blocks per tower, under ``setting`` (None:
    the default path; or one of LN_SETTINGS), derived from the step's
    tower calls: the student's globals, locals, caption head views and
    the text bucket's short three quarters and long quarter of the other
    6b views (all with a gradient), the teacher's globals and head views
    (without), and the student's two cross poolers (ln_q and ln_k each,
    batch b).  A LayerNorm takes K3/K4 only where ``supported`` holds:
    every width here is a multiple of 128, so where the batch is even."""
    n = 6 * b
    short = n * 3 // 4
    calls = [("vision", 2 * b, True), ("vision", 6 * b, True),
             ("text", 2 * b, True), ("text", short, True),
             ("text", n - short, True),
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cosmos_tpu_torch.ops import build as kernel_build
    from cosmos_tpu_torch.ops import fused_attention as fa
    from cosmos_tpu_torch.ops.experimental import layer_norm as ln
    from cosmos_tpu_torch.ops.experimental import ln_matmul as lm
    from cosmos_tpu_torch.ops.experimental import mlp_block as mb

    K = SimpleNamespace(fa=fa, ln=ln, lm=lm, mb=mb)
    t0 = time.perf_counter()
    card = phase_card()
    build_s = phase_build(kernel_build, (fa, ln, lm, mb))
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
        # the main paths' runs: serving (phase 4), training (phases 7, 10)
        "launches": serving["launches"] + train["k1_launches"] + sum(
            r["launches"]["K1"] for r in train_ln.values()),
        "launches_by_path": {"serving": serving["launches"],
                             "training": train["k1_launches"],
                             **{f"training {s}": r["launches"]["K1"]
                                for s, r in train_ln.items()}},
        **{k: k1_row[k] for k in attention_keys},
    }, {
        "name": "fused_attention_qkv_bwd",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_bwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:190",
        "launches": train["k2_launches"] + sum(
            r["launches"]["K2"] for r in train_ln.values()),
        "launches_by_path": {"training": train["k2_launches"],
                             **{f"training {s}": r["launches"]["K2"]
                                for s, r in train_ln.items()}},
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
            **{k: row[k] for k in keys + ("x_bound", "x_library")}})
        check(kernels[-1]["launches"] > 0, f"{key} never launched")
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, kernel_rows=rows,
                  serving=serving, card_vs_cpu=card_vs_cpu,
                  kernel_bwd_rows=bwd_rows, function_card_vs_cpu=function_errs,
                  ragged=ragged,
                  train=train, train_card_vs_cpu=train_card_vs_cpu,
                  ln_kernel_rows=ln_rows, ln_ragged=ln_ragged,
                  train_ln=train_ln,
                  train_ln_card_vs_cpu=train_ln_card_vs_cpu,
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
