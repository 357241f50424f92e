#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cosmos_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one Hopper card (sm_90a)
and nvcc.  It builds every CUDA kernel of the serving path from the sources
in the checkout and then:

  1. prints the card, its power limit and the torch / CUDA versions;
  2. builds the packed-QKV attention kernel (K1) and prints the build time;
  3. holds K1 to its plain PyTorch version at the serving path's
     geometries in float32 and bfloat16, and times K1, the plain version
     and, as a yardstick only, F.scaled_dot_product_attention on the same
     split heads, beside the least time the card could take (bound);
  4. serves COSMOS ViT-B-16 zero-shot retrieval at full width in bfloat16
     (512 images, 2560 captions with EOT truncation), checks that every
     self-attention went through K1, times the encoders and gives K1's
     share of each tower call;
  5. runs the same float32 weights on the card and on the CPU and compares
     the encoders and the COSMOS forward.

Any failed check raises, so the script exits non-zero.  The last lines are
the card's name and power limit, one JSON object with the kernel records,
and {"ok": true, "device": {...}}.  The full record is also written to
chiprun_out/chip_smoke.json.
"""

from __future__ import annotations

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
# the serving phase's tower calls: 256 images at 224px, 256 captions whose
# EOT positions (8..40) truncate to 48 tokens
SERVING_GEOMETRIES = {"image": "vision ViT-B-16 224px",
                      "text": "text serving batch"}
# kernel vs plain version on the same card.  float32: summation order only
# (measured ~7e-7).  bfloat16: the kernel rounds exp(s - m) to bf16 and
# divides by the row sum at the end, the plain version rounds the
# normalised P: one bf16 ulp of outputs |o| < 4 plus 1% relative
KERNEL_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (1.6e-2, 1e-2)}


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


def attention_bound(b, l, d, causal, dtype):
    """(bound_ms, bound_by, bytes, ops) for one forward call: qkv read once
    and the output written once; QK^T and P.V over the key positions this
    call needs (the lower triangle with the diagonal when causal)."""
    nbytes = 4 * b * l * d * torch.tensor([], dtype=dtype).element_size()
    pairs = l * (l + 1) // 2 if causal else l * l
    ops = 4 * b * pairs * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, ops)


def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[card] {smi}")
    print(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    return smi.splitlines()[0]


def phase_build(fa, kernel_build) -> float:
    t0 = time.perf_counter()
    fa.build()
    seconds = time.perf_counter() - t0
    print(f"[build] K1 {fa.SOURCE} ready in {seconds:.2f} s")
    for line in kernel_build.build_logs.get(fa.SOURCE, "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build]   {line.strip()}")
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
                       tflops=ops / ms / 1e9)
            rows.append(row)
            print(f"[kernel] {label:28s} {row['dtype']:8s} [{b},{l},{d3}] "
                  f"h={heads} causal={int(causal)} err={err:.3g} "
                  f"K1={ms:.4f} ms plain={plain_ms:.4f} ms "
                  f"sdpa={library_ms:.4f} ms bound={bound_ms:.4f} ms "
                  f"({bound_by}) {row['tflops']:.1f} TFLOP/s")
            del x, got, want, q, k, v
    return rows


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from cosmos_tpu_torch.ops import build as kernel_build
    from cosmos_tpu_torch.ops import fused_attention as fa

    t0 = time.perf_counter()
    card = phase_card()
    build_s = phase_build(fa, kernel_build)
    rows = phase_kernel(fa)
    serving = phase_serving(fa, rows)
    card_vs_cpu = phase_card_vs_cpu(fa)

    main_row = next(r for r in rows if (r["label"], r["dtype"]) == (
        MAIN_GEOMETRY[0], str(MAIN_GEOMETRY[1]).replace("torch.", "")))
    kernels = [{
        "name": "fused_attention_qkv_fwd",
        "route": "cuda",
        "source": "cosmos_tpu_torch/ops/csrc/fused_attention_fwd.cu",
        "replaces": "cosmos_tpu/ops/fused_attention.py:101",
        "launches": serving["launches"],
        **{k: main_row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms")},
        "shape": main_row["shape"],
        "dtype": main_row["dtype"],
    }]
    record = dict(card=card, torch=torch.__version__,
                  cuda=torch.version.cuda, build_s=build_s, kernel_rows=rows,
                  serving=serving, card_vs_cpu=card_vs_cpu,
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
