"""get_data: the train, val and retrieval loaders from the trainer's flags
(counterpart of ``cosmos_tpu/training/data_pipeline.py``).

Returns ``{'train': DataInfo, 'val': WdsValLoader, 'train_eval': ...,
'coco-retrieval': RetrievalData, 'flickr-retrieval': RetrievalData,
'imagenet-val' / 'imagenet-v2' / a classification set's name:
MapDatasetLoader}`` for the keys the flags ask for.  Batches are numpy; the
trainer moves them to the device (``data/prefetch.py``).  The CSV loader is
not ported yet; the trainer refuses its flags.
"""

from __future__ import annotations

import logging
import os
import random
from typing import Dict, Iterator

import numpy as np

from ..data.caption import sample_captions
from ..data.datasets import ImageFolderDataset, RetrievalData, SyntheticDataset
from ..data.loader import (DataInfo, MapDatasetLoader, WdsTrainConfig,
                           WdsTrainLoader, WdsValLoader, collate_views,
                           train_transform)
from ..data.transforms import eval_transform_from_args
from ..data.webdataset import expand_urls

logger = logging.getLogger(__name__)


class SyntheticTrainLoader:
    """Batches from SyntheticDataset shaped like the wds train stream."""

    def __init__(self, cfg: WdsTrainConfig, num_samples: int = 4096):
        from ..data.tokenizer import SimpleTokenizer

        self.cfg = cfg
        self.dataset = SyntheticDataset(num_samples, image_size=cfg.image_size)
        self.tokenizer = SimpleTokenizer(context_length=cfg.context_length)
        self.transform = train_transform(cfg)
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            # re-keyed per epoch: the trainer calls set_epoch on one
            # long-lived iterator, so a resume at epoch k reproduces epoch
            # k's batches; hosts diverge by process_index
            epoch = self._epoch
            rng = random.Random(
                (self.cfg.seed + epoch) * self.cfg.process_count
                + self.cfg.process_index
            )
            idx = self.cfg.process_index
            g = self.cfg.global_crops_number if self.cfg.use_multicrop else 1
            n = self.cfg.local_crops_number if self.cfg.use_multicrop else 0
            while self._epoch == epoch:
                buf = []
                for _ in range(self.cfg.batch_size):
                    img, meta = self.dataset[idx % len(self.dataset)]
                    idx += self.cfg.process_count
                    crops = self.transform(img, rng)
                    if not isinstance(crops, list):
                        crops = [crops]
                    caps = sample_captions(
                        meta, self.cfg.num_sampled_captions,
                        self.cfg.caption_sampling_mode, rng,
                    )
                    buf.append((crops, self.tokenizer(caps)))
                yield collate_views(buf, g, n)


def _detect_dataset_type(args) -> str:
    if args.dataset_type != "auto":
        return args.dataset_type
    if args.train_data is None:
        return "none"
    ext = args.train_data.split(".")[-1]
    if ext in ("csv", "tsv"):
        return "csv"
    return "webdataset"


def make_train_config(args, process_index: int = 0,
                      process_count: int = 1) -> WdsTrainConfig:
    """The loader's config.  One process drives one card, so the loader's
    batch is --batch-size (the JAX package multiplies it by its local
    device count)."""
    urls, weights = expand_urls(
        args.train_data or "", args.train_data_upsampling_factors
    )
    if args.use_imagecrop_aug and args.global_crops_number != 2:
        raise ValueError(
            "--global-crops-number must be 2 with --use-imagecrop-aug "
            "(the COSMOS/DINO recipe)"
        )
    return WdsTrainConfig(
        urls=urls,
        weights=weights,
        batch_size=args.batch_size,
        num_workers=args.workers,
        global_crops_number=args.global_crops_number,
        local_crops_number=args.local_crops_number if args.use_imagecrop_aug else 0,
        image_size=getattr(args, "image_size", 224),
        crop_scale=args.crop_scale,
        num_sampled_captions=(
            args.num_sampled_captions if args.caption_sampling_mode != "raw" else 1
        ),
        caption_sampling_mode=args.caption_sampling_mode,
        context_length=getattr(args, "context_length", 77),
        seed=args.seed,
        process_index=process_index,
        process_count=process_count,
        resampled=args.dataset_resampled,
        use_multicrop=args.use_imagecrop_aug,
        aug_cfg=getattr(args, "aug_cfg", None) or None,
    )


def get_data(
    args,
    tokenizer,
    *,
    process_index: int = 0,
    process_count: int = 1,
    image_size: int = 224,
    context_length: int = 77,
) -> Dict[str, object]:
    data: Dict[str, object] = {}
    args.image_size = image_size
    args.context_length = context_length
    dtype = _detect_dataset_type(args)
    if dtype == "csv":
        raise NotImplementedError(
            "--dataset-type csv is not ported (ROADMAP queue 1, item 4)")
    global_batch = args.batch_size * process_count
    # one optimizer step consumes accum_freq micro-batches
    samples_per_step = global_batch * max(1, getattr(args, "accum_freq", 1))

    if dtype in ("webdataset", "synthetic"):
        cfg = make_train_config(args, process_index, process_count)
        if dtype == "synthetic":
            loader = SyntheticTrainLoader(cfg, num_samples=args.train_num_samples
                                          or 4096)
            num_samples = args.train_num_samples or 4096
        else:
            loader = WdsTrainLoader(cfg)
            if not args.train_num_samples:
                raise ValueError(
                    "--train-num-samples is required for webdataset training"
                )
            num_samples = args.train_num_samples
        num_batches = args.steps_per_epoch or max(1, num_samples // samples_per_step)
        data["train"] = DataInfo(loader, num_samples, num_batches)

    eval_tf = eval_transform_from_args(args, image_size)

    if args.val_data:
        val_urls, _ = expand_urls(args.val_data)
        data["val"] = WdsValLoader(
            val_urls,
            batch_size=args.batch_size,
            image_size=image_size,
            context_length=context_length,
            num_samples=args.val_num_samples,
            eval_tf=eval_tf,
        )

    if getattr(args, "train_eval_data", None):
        # the val reader over TRAIN shards, capped at a fixed sample count:
        # an overfitting monitor beside the held-out val loss
        te_urls, _ = expand_urls(args.train_eval_data)
        data["train_eval"] = WdsValLoader(
            te_urls,
            batch_size=args.batch_size,
            image_size=image_size,
            context_length=context_length,
            num_samples=getattr(args, "train_val_num_samples", 5120),
            eval_tf=eval_tf,
        )

    if args.data_root_dir:
        coco_dir = os.path.join(args.data_root_dir, "coco")
        flickr_dir = os.path.join(args.data_root_dir, "flickr30k-images")
        if os.path.isdir(coco_dir):
            data["coco-retrieval"] = RetrievalData.load(
                "coco", coco_dir, tokenizer
            )
        if os.path.isdir(flickr_dir):
            data["flickr-retrieval"] = RetrievalData.load(
                "flickr", flickr_dir, tokenizer, split="test"
            )

    if args.imagenet_val:
        ds = ImageFolderDataset(args.imagenet_val, transform=eval_tf)
        data["imagenet-val"] = MapDatasetLoader(ds, args.batch_size)

    if args.imagenet_v2:
        # integer class dirs 0..999, in numeric order
        ds = ImageFolderDataset(args.imagenet_v2, transform=eval_tf)
        data["imagenet-v2"] = MapDatasetLoader(ds, args.batch_size)

    if args.classification_data_dir and args.zeroshot_eval_datasets:
        from ..data.classification import ClassificationDataset
        from .zero_shot import bank_key

        for name in args.zeroshot_eval_datasets.split(","):
            name = name.strip()
            if not name:
                continue
            root = os.path.join(args.classification_data_dir, name)
            if not os.path.isdir(root):
                logger.warning(f"classification dataset dir missing: {root}")
                continue
            try:
                ds = ClassificationDataset(name, root, transform=eval_tf)
            except (KeyError, FileNotFoundError) as e:
                logger.warning(
                    f"{name}: native reader failed ({e}); "
                    "falling back to class-folder layout"
                )
                ds = ImageFolderDataset(root, transform=eval_tf)
            # stored under the canonical name, the one the evals look up
            data[bank_key(name)] = MapDatasetLoader(ds, args.batch_size)
    return data
