"""Open-vocabulary segmentation eval entry point (counterpart of
``cosmos_tpu/training/seg_eval.py``).

    python -m cosmos_tpu_torch.training.seg_eval --model ViT-B-16 \\
        --pretrained <ckpt.pt> [--seg-w-background] [--use-csa] \\
        [--seg-data-root /path] [--benchmarks voc20,ade20k] [--limit N]

The benchmark list follows --seg-w-background (with: voc21, context60,
coco_object; without: voc20, cityscapes, context59, ade20k, coco_stuff) or
--benchmarks.  The model is built and its weights loaded once, the EMA
teacher's by default (--student for the student), from a local ``.pt``;
each benchmark gets its own segmentor (class names, thresholds) and reports
mIoU, aAcc and mAcc.  ``main(argv, device=None)`` runs on the card and
raises without CUDA; ``device="cpu"`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
import time
from typing import Dict

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser("cosmos_tpu_torch segmentation eval")
    p.add_argument("--model", default="ViT-B-16")
    p.add_argument("--pretrained", default="")
    p.add_argument("--huggingface-model-name", default="")
    p.add_argument("--huggingface-repo-name", default="sankim2/cosmos")
    p.add_argument("--precision", default="fp32")
    p.add_argument("--use-csa", action="store_true", default=False)
    p.add_argument("--seg-w-background", action="store_true", default=False)
    p.add_argument("--benchmarks", default="",
                   help="comma list overriding the background split")
    p.add_argument("--seg-data-root", default=None,
                   help="root replacing each benchmark's default data_root")
    p.add_argument("--pamr-steps", type=int, default=0)
    p.add_argument("--pamr-stride", type=str, default="8,16")
    p.add_argument("--limit", type=int, default=None,
                   help="evaluate only the first N images (smoke)")
    p.add_argument("--student", action="store_true", default=False,
                   help="use student weights instead of the teacher")
    p.add_argument("--use-ema-model", action="store_true", default=True,
                   help="the reference's alias; the EMA teacher is already "
                        "the default here (--student for the online model)")
    p.add_argument("--output-all", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--attentional-pool",
                   action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--add-zero-attn", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--cosmos", action=argparse.BooleanOptionalAction,
                   default=True)
    return p.parse_args(argv)


def load_model_for_seg(args, device):
    """(model, tokenizer), built and loaded once for every benchmark."""
    import os

    from ..models.convert import load_checkpoint
    from ..models.factory import create_model, get_tokenizer
    from .main import NEEDS_DOWNLOAD

    if args.huggingface_model_name:
        raise NotImplementedError(
            "--huggingface-model-name needs a download, which is not ported "
            f"(ROADMAP {NEEDS_DOWNLOAD}); pass a local .pt as --pretrained")
    if args.pretrained and not os.path.isfile(args.pretrained):
        raise NotImplementedError(
            f"--pretrained {args.pretrained!r}: only a local .pt file is "
            f"ported; a pretrained tag needs a download (ROADMAP "
            f"{NEEDS_DOWNLOAD})")
    model = create_model(
        args.model,
        precision=args.precision,
        cosmos=args.cosmos,
        output_all=args.output_all,
        attentional_pool=args.attentional_pool,
        add_zero_attn=args.add_zero_attn,
        device=device,
    )
    if args.pretrained:
        which = "student" if args.student else "teacher"
        model.load_state_dict(load_checkpoint(args.pretrained, which),
                              strict=True)
    return model, get_tokenizer(args.model)


def build_segmentor(args, bench, loaded):
    from ..segmentation import CLIPSegmentor, load_seg_classnames

    model, tokenizer = loaded
    return CLIPSegmentor(
        model,
        tokenizer,
        load_seg_classnames(bench.classnames_key),
        logit_scale=bench.logit_scale,
        prob_thd=bench.prob_thd,
        area_thd=bench.area_thd,
        pamr_steps=args.pamr_steps,
        pamr_stride=tuple(int(x) for x in args.pamr_stride.split(",")),
        use_csa=args.use_csa,
    )


def evaluate_benchmark(args, bench, data_root, loaded) -> Dict[str, float]:
    from ..segmentation import IoUMetric, SegDataset

    seg = build_segmentor(args, bench, loaded)
    ds = SegDataset(bench, data_root=data_root, limit=args.limit)
    metric = IoUMetric(num_classes=seg.num_classes)
    t0 = time.time()
    for i in range(len(ds)):
        image, label = ds[i]
        pred = seg.predict(image, ori_shape=label.shape[:2])
        metric.update(pred, label)
        if (i + 1) % 200 == 0:
            logger.info(f"{bench.name}: {i+1}/{len(ds)} images "
                        f"({(i+1)/(time.time()-t0):.2f} img/s)")
    out = metric.compute()
    logger.info(f"{bench.name}: {out}")
    return out


def main(argv=None, *, device=None) -> Dict[str, Dict[str, float]]:
    from ..models.factory import resolve_device
    from ..segmentation import (SEG_BENCHMARKS, WITH_BACKGROUND,
                                WITHOUT_BACKGROUND)
    from .logger import setup_logging

    args = parse_args(argv)
    dev = resolve_device(device)
    setup_logging()
    if args.benchmarks:
        names = [b.strip() for b in args.benchmarks.split(",") if b.strip()]
    else:
        names = list(WITH_BACKGROUND if args.seg_w_background
                     else WITHOUT_BACKGROUND)
    results = {}
    loaded = load_model_for_seg(args, dev)
    for name in names:
        bench = SEG_BENCHMARKS[name]
        try:
            results[name] = evaluate_benchmark(args, bench,
                                               args.seg_data_root, loaded)
        except FileNotFoundError as e:
            logger.error(f"{name}: dataset missing ({e}); skipping")
    print(json.dumps(results))
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
