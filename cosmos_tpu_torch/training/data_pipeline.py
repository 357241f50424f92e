"""get_data: the train, val and retrieval loaders from the trainer's flags
(counterpart of ``cosmos_tpu/training/data_pipeline.py``).

Returns ``{'train': DataInfo, 'val': WdsValLoader, 'train_eval': ...,
'coco-retrieval': RetrievalData, 'flickr-retrieval': RetrievalData,
'imagenet-val' / 'imagenet-v2' / a classification set's name:
MapDatasetLoader}`` for the keys the flags ask for.  Batches are numpy; the
trainer moves them to the device (``data/prefetch.py``).  The train data is
webdataset shards, a CSV of (image path, caption) rows (``--dataset-type
csv``, or ``auto`` on a ``.csv``/``.tsv`` path; decoded in the stepping
process, as in the JAX package) or the synthetic source.
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


class CsvTrainLoader:
    """Train batches from a CSV of (image path, caption) rows, shaped like
    the webdataset stream and decoded inline.

    Each pass over the rows is keyed on (the current epoch, the pass within
    it): every process runs the same global shuffle and takes the strided
    slice ``order[process_index::process_count]``, so the processes read
    disjoint rows; a pass breaks off when the epoch changes, so a resume at
    epoch k gives epoch k's batches.  An unreadable image is skipped with a
    warning; a pass that yields nothing raises.  Captions are sampled
    ``raw`` or ``random`` (a CSV row has one caption)."""

    def __init__(self, cfg: WdsTrainConfig, csv_path: str, img_key: str,
                 caption_key: str, sep: str):
        from ..data.datasets import CsvDataset
        from ..data.tokenizer import SimpleTokenizer

        self.cfg = cfg
        ds = CsvDataset(csv_path, transform=None, img_key=img_key,
                        caption_key=caption_key, sep=sep)
        self.rows = list(zip(ds.images, ds.captions))
        if not self.rows:
            raise ValueError(f"no rows in {csv_path}")
        # a pass drops its partial batch: with fewer rows a process than one
        # batch, a pass yields nothing, and the error below would blame the
        # images; name the real constraint up front
        per_host = len(self.rows) // max(1, cfg.process_count)
        if per_host < cfg.batch_size:
            raise ValueError(
                f"CSV loader: {len(self.rows)} rows across "
                f"{cfg.process_count} process(es) leaves {per_host} rows "
                f"per host — fewer than one batch (batch_size="
                f"{cfg.batch_size}); shrink --batch-size or provide more "
                "rows"
            )
        self.tokenizer = SimpleTokenizer(context_length=cfg.context_length)
        self.transform = train_transform(cfg)
        self._epoch = 0

    def __len__(self):
        return len(self.rows)

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        from PIL import Image

        pass_no, prev_epoch = 0, None
        while True:
            epoch = self._epoch
            pass_no = pass_no + 1 if epoch == prev_epoch else 0
            prev_epoch = epoch
            rng = random.Random((self.cfg.seed + epoch) * 100003 + pass_no)
            order = list(range(len(self.rows)))
            rng.shuffle(order)
            order = order[self.cfg.process_index::self.cfg.process_count]
            g = self.cfg.global_crops_number if self.cfg.use_multicrop else 1
            n = self.cfg.local_crops_number if self.cfg.use_multicrop else 0
            mode = (self.cfg.caption_sampling_mode
                    if self.cfg.caption_sampling_mode in ("raw", "random")
                    else "random")
            buf = []
            yielded = 0
            for idx in order:
                if self._epoch != epoch:
                    break  # the epoch advanced mid-pass: re-key now
                path, caption = self.rows[idx]
                try:
                    img = Image.open(path).convert("RGB")
                except Exception as e:
                    logger.warning(f"csv row {idx}: unreadable image "
                                   f"{path!r} ({e!r})")
                    continue
                crops = self.transform(img, rng)
                if not isinstance(crops, list):
                    crops = [crops]
                caps = sample_captions({"raw_caption": [caption]},
                                       self.cfg.num_sampled_captions, mode,
                                       rng)
                buf.append((crops, self.tokenizer(caps)))
                if len(buf) == self.cfg.batch_size:
                    yield collate_views(buf, g, n)
                    yielded += 1
                    buf = []
            if yielded == 0 and self._epoch == epoch:
                # a whole pass gave nothing: every image unreadable (a
                # wrong working directory, corrupt files); fail rather than
                # reshuffle forever at step 0
                raise RuntimeError(
                    f"CSV loader: no readable images in any of "
                    f"{len(self.rows)} rows (see warnings above; are the "
                    "image paths relative to a different directory?)"
                )


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
    elif dtype == "csv":
        cfg = make_train_config(args, process_index, process_count)
        loader = CsvTrainLoader(
            cfg, args.train_data, args.csv_img_key, args.csv_caption_key,
            args.csv_separator,
        )
        num_samples = args.train_num_samples or len(loader)
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
