"""Configs of the 8 open-vocabulary segmentation benchmarks (counterpart
of ``cosmos_tpu/segmentation/configs.py``): dataset layout, the keep-ratio
resize scale, the class-name bank, and the segmentor's per-benchmark
logit_scale / prob_thd / area_thd.  With background: voc21, context60,
coco_object; without: voc20, cityscapes, context59, ade20k, coco_stuff.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple


@dataclass
class SegBenchmark:
    name: str
    classnames_key: str            # key into assets/seg_classnames.json
    data_root: str                 # default path (override via CLI)
    img_dir: str
    ann_dir: str
    split_file: Optional[str] = None
    img_suffix: str = ".jpg"
    seg_suffix: str = ".png"
    scale: Tuple[int, int] = (2048, 336)   # (long, short) keep-ratio resize
    reduce_zero_label: bool = False
    logit_scale: float = 40.0
    prob_thd: float = 0.0
    area_thd: Optional[float] = None
    with_background: bool = False


SEG_BENCHMARKS: Dict[str, SegBenchmark] = {
    "voc20": SegBenchmark(
        name="voc20",
        classnames_key="voc20",
        data_root="/mmsegmentation_datasets/data/VOCdevkit/VOC2012",
        img_dir="JPEGImages",
        ann_dir="SegmentationClass",
        split_file="ImageSets/Segmentation/val.txt",
        reduce_zero_label=True,
    ),
    "voc21": SegBenchmark(
        name="voc21",
        classnames_key="voc21",
        data_root="/mmsegmentation_datasets/data/VOCdevkit/VOC2012",
        img_dir="JPEGImages",
        ann_dir="SegmentationClass",
        split_file="ImageSets/Segmentation/val.txt",
        logit_scale=65.0,
        prob_thd=0.1,
        area_thd=0.1,
        with_background=True,
    ),
    "context59": SegBenchmark(
        name="context59",
        classnames_key="context59",
        data_root="/mmsegmentation_datasets/data/VOCdevkit/VOC2010",
        img_dir="JPEGImages",
        ann_dir="SegmentationClassContext",
        split_file="ImageSets/SegmentationContext/val.txt",
        reduce_zero_label=True,
    ),
    "context60": SegBenchmark(
        name="context60",
        classnames_key="context60",
        data_root="/mmsegmentation_datasets/data/VOCdevkit/VOC2010",
        img_dir="JPEGImages",
        ann_dir="SegmentationClassContext",
        split_file="ImageSets/SegmentationContext/val.txt",
        logit_scale=50.0,
        prob_thd=0.1,
        with_background=True,
    ),
    "coco_object": SegBenchmark(
        name="coco_object",
        classnames_key="coco_object",
        data_root="/mmsegmentation_datasets/data/coco_stuff164k",
        img_dir="images/val2017",
        ann_dir="annotations/val2017",
        seg_suffix="_instanceTrainIds.png",
        logit_scale=50.0,
        prob_thd=0.1,
        with_background=True,
    ),
    "coco_stuff": SegBenchmark(
        name="coco_stuff",
        classnames_key="coco_stuff",
        data_root="/mmsegmentation_datasets/data/coco_stuff164k",
        img_dir="images/val2017",
        ann_dir="annotations/val2017",
        seg_suffix="_labelTrainIds.png",
        scale=(2048, 448),
        # NO zero-label reduction: _labelTrainIds.png already maps
        # unlabeled to 255 and class 0 is 'person' (mmseg
        # COCOStuffDataset reduce_zero_label=False; the reference's
        # cfg_coco_stuff164k.py uses plain LoadAnnotations).  Reducing
        # here shifted every label by -1 and scored GT against the
        # wrong classes.
    ),
    "cityscapes": SegBenchmark(
        name="cityscapes",
        classnames_key="city_scapes",
        data_root="/mmsegmentation_datasets/data/cityscapes",
        img_dir="leftImg8bit/val",
        ann_dir="gtFine/val",
        img_suffix="_leftImg8bit.png",
        seg_suffix="_gtFine_labelTrainIds.png",
        scale=(2048, 560),
    ),
    "ade20k": SegBenchmark(
        name="ade20k",
        classnames_key="ade20k",
        data_root="/mmsegmentation_datasets/data/ade/ADEChallengeData2016",
        img_dir="images/validation",
        ann_dir="annotations/validation",
        reduce_zero_label=True,
    ),
}

WITH_BACKGROUND = ("voc21", "context60", "coco_object")
WITHOUT_BACKGROUND = ("voc20", "cityscapes", "context59", "ade20k", "coco_stuff")
