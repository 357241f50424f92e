"""Segmentation eval dataset (counterpart of ``cosmos_tpu/segmentation/
dataset.py``): (resized image, label map) pairs from an mmseg layout,
walking the image and label dirs or a split file; images take mmseg's
keep-ratio (long, short)-bounded resize (PIL bilinear), label PNGs the
benchmark's reduce_zero_label.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .configs import SegBenchmark
from .metrics import reduce_zero_label


def keep_ratio_resize_dims(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmseg Resize(scale=(long, short), keep_ratio=True): the image is
    scaled by min(long/max_side, short/min_side)."""
    long_edge, short_edge = max(scale), min(scale)
    f = min(long_edge / max(h, w), short_edge / min(h, w))
    return int(h * f + 0.5), int(w * f + 0.5)


class SegDataset:
    def __init__(self, bench: SegBenchmark, data_root: Optional[str] = None,
                 limit: Optional[int] = None):
        self.bench = bench
        root = Path(data_root or bench.data_root)
        self.img_dir = root / bench.img_dir
        self.ann_dir = root / bench.ann_dir
        self.pairs: List[Tuple[Path, Path]] = []
        if bench.split_file:
            stems = [
                s.strip()
                for s in (root / bench.split_file).read_text().splitlines()
                if s.strip()
            ]
            for stem in stems:
                self.pairs.append(
                    (
                        self.img_dir / f"{stem}{bench.img_suffix}",
                        self.ann_dir / f"{stem}{bench.seg_suffix}",
                    )
                )
        else:
            for img_path in sorted(self.img_dir.rglob(f"*{bench.img_suffix}")):
                rel = img_path.relative_to(self.img_dir)
                stem = str(rel)[: -len(bench.img_suffix)]
                ann = self.ann_dir / f"{stem}{bench.seg_suffix}"
                if ann.exists():
                    self.pairs.append((img_path, ann))
        if limit:
            self.pairs = self.pairs[:limit]
        if not self.pairs:
            raise FileNotFoundError(
                f"no (image, label) pairs under {self.img_dir} / {self.ann_dir}"
            )

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (resized uint8 image [h, w, 3], label [H_ori, W_ori])."""
        from PIL import Image

        img_path, ann_path = self.pairs[idx]
        img = Image.open(img_path).convert("RGB")
        w, h = img.size
        nh, nw = keep_ratio_resize_dims(h, w, self.bench.scale)
        img = img.resize((nw, nh), Image.BILINEAR)
        label = np.asarray(Image.open(ann_path)).astype(np.int32)
        if label.ndim == 3:
            label = label[..., 0]
        if self.bench.reduce_zero_label:
            label = reduce_zero_label(label)
        return np.asarray(img, np.uint8), label
