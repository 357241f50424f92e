"""The model FLOPs and parameters report (counterpart of
``cosmos_tpu/training/profiler.py``).

    python -m cosmos_tpu_torch.training.profiler --model ViT-B-16,ViT-B-32 \\
        [--results-file out.csv] [--batch-size 1] [--cosmos] [--output-all] \\
        [--attentional-pool] [--device cuda|cpu]

For each model: the parameters of the whole model and of each tower, and
the FLOPs of one call of each encoder at ``--batch-size`` on zero inputs.
The FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` around the
calls: aten's matmuls and convolutions by torch's formulas, and the port's
kernels, which run as they would in the model (K1 on the card), by their
own formulas (``ops/fused_attention.py``: SDPA's 4·B·L²·D).  The JAX
package reads XLA's ``cost_analysis`` instead.  Runs on the card unless
``--device cpu``; raises without CUDA.
"""

from __future__ import annotations

import argparse
import csv
import sys
from typing import Dict, Optional, Union


def _flops(fn, *args) -> int:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


def profile_model(
    model_name: str,
    batch_size: int = 1,
    precision: str = "fp32",
    force_image_size: Optional[int] = None,
    device: Union[str, "torch.device", None] = None,
    **model_kwargs,
) -> Dict[str, float]:
    """One report row: the model's widths, parameters (millions) of the
    model, its vision tower (``visual.*``) and the rest, and GFLOPs of
    one ``encode_image`` and one ``encode_text`` call."""
    import torch

    from ..models.factory import create_model

    if force_image_size is not None:
        model_kwargs["vision_image_size"] = force_image_size
    model = create_model(model_name, precision=precision, device=device,
                         **model_kwargs)
    c = model.cfg
    dev = next(model.parameters()).device
    image_size = c.vision_cfg.image_size
    images = torch.zeros(batch_size, image_size, image_size, 3, device=dev)
    texts = torch.zeros(batch_size, c.text_cfg.context_length,
                        dtype=torch.long, device=dev)
    img_flops = _flops(model.encode_image, images)
    txt_flops = _flops(model.encode_text, texts)

    total = sum(p.numel() for p in model.parameters())
    visual = sum(p.numel() for p in model.visual.parameters())
    return {
        "model": model_name,
        "image_size": image_size,
        "image_width": c.vision_cfg.width,
        "text_width": c.text_cfg.width,
        "embed_dim": c.embed_dim,
        "mparams": round(total / 1e6, 2),
        "image_mparams": round(visual / 1e6, 2),
        "text_mparams": round((total - visual) / 1e6, 2),
        "gflops": round((img_flops + txt_flops) / 1e9, 2),
        "image_gflops": round(img_flops / 1e9, 2),
        "text_gflops": round(txt_flops / 1e9, 2),
    }


def main(argv=None):
    p = argparse.ArgumentParser("cosmos_tpu_torch profiler")
    p.add_argument("--model", type=str, default="ViT-B-16",
                   help="comma-separated model names")
    p.add_argument("--results-file", type=str, default=None,
                   help="csv output path")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--cosmos", action="store_true", default=False)
    p.add_argument("--output-all", action="store_true", default=False)
    p.add_argument("--attentional-pool", action="store_true", default=False)
    p.add_argument("--device", type=str, default=None,
                   help="the card (default) or 'cpu'")
    args = p.parse_args(argv)

    rows = []
    for name in args.model.split(","):
        name = name.strip()
        row = profile_model(
            name, batch_size=args.batch_size, device=args.device,
            cosmos=args.cosmos, output_all=args.output_all,
            attentional_pool=args.attentional_pool,
        )
        rows.append(row)
        print(row)

    if args.results_file and rows:
        with open(args.results_file, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
    return rows


if __name__ == "__main__":
    main(sys.argv[1:])
