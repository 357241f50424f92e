"""Multiprocess training data loader (counterpart of
``cosmos_tpu/data/loader.py``).

N worker processes each stream a disjoint shard subset (split by host and
by worker), decode and augment on the host, and put COMPLETE batches on a
queue; the main process takes them in arrival order.  Crops cross the
process boundary as uint8: mean/std normalisation runs on the device in the
train step.  The workers import this package's data modules only (numpy,
PIL, ctypes, the standard library), never torch.  By default
(``use_native_io``) a worker streams each shard through the native tar
reader and decodes JPEGs at a reduced DCT scale (``data/native.py``), as the
JAX package's loader does; the parent builds that library before it starts
a worker, so a build failure raises there.

Epoch bookkeeping: the loader is an infinite stream; ``num_batches`` per
epoch comes from --train-num-samples and the global batch, and
``set_epoch`` reseeds the shard order deterministically.
"""

from __future__ import annotations

import dataclasses
import logging
import multiprocessing as mp
import os
import queue as queue_mod
import random
import threading
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class DataInfo:
    """Loader + bookkeeping handle."""

    dataloader: Any
    num_samples: int = 0
    num_batches: int = 0

    def set_epoch(self, epoch: int):
        if hasattr(self.dataloader, "set_epoch"):
            self.dataloader.set_epoch(epoch)


@dataclasses.dataclass
class WdsTrainConfig:
    urls: List[str]
    weights: Optional[List[float]] = None
    batch_size: int = 64              # per-host batch
    num_workers: int = 4
    global_crops_number: int = 2
    local_crops_number: int = 6
    image_size: int = 224
    local_size: int = 96
    crop_scale: float = 0.4
    num_sampled_captions: int = 8
    caption_sampling_mode: str = "textcrop"
    context_length: int = 77
    seed: int = 0
    shuffle_buffer: int = 1000
    process_index: int = 0
    process_count: int = 1
    resampled: bool = False
    use_multicrop: bool = True
    # --aug-cfg kwargs (scale/ratio/color_jitter[_prob]/gray_scale_prob)
    # for the non-multicrop train transform
    aug_cfg: Optional[dict] = None
    # native C++ tar streaming + DCT-scaled JPEG decode (data/native.py);
    # False reads with tarfile and decodes with PIL
    use_native_io: bool = True


def train_transform(cfg: WdsTrainConfig):
    """The multi-crop recipe with --use-imagecrop-aug, else the plain train
    transform producing ONE crop; uint8 output either way."""
    from cosmos_tpu_torch.data.transforms import (MulticropAugmentation,
                                                  image_transform_train)

    if cfg.use_multicrop:
        return MulticropAugmentation(
            image_size=cfg.image_size,
            local_crops_number=cfg.local_crops_number,
            global_crops_number=cfg.global_crops_number,
            crop_scale=cfg.crop_scale,
            local_size=cfg.local_size,
            as_uint8=True,
        )
    return image_transform_train(
        cfg.image_size, aug_cfg=cfg.aug_cfg, as_uint8=True
    )


def _worker_loop(cfg: WdsTrainConfig, worker_index: int, epoch0: int,
                 out_q, epoch_q) -> None:
    """Runs in a worker process: stream shards -> samples -> batches."""
    from cosmos_tpu_torch.data.caption import sample_captions
    from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
    from cosmos_tpu_torch.data.webdataset import (
        ShardedShardList,
        decode_sample,
        shuffle_buffer,
        tar_to_samples,
    )

    tokenizer = SimpleTokenizer(context_length=cfg.context_length)
    transform = train_transform(cfg)
    shards = ShardedShardList(
        cfg.urls,
        cfg.weights,
        shuffle=True,
        seed=cfg.seed,
        resampled=cfg.resampled,
        process_index=cfg.process_index,
        process_count=cfg.process_count,
        worker_index=worker_index,
        worker_count=cfg.num_workers,
    )

    jpeg_decoder = None
    if cfg.use_native_io:
        from cosmos_tpu_torch.data import native

        # decode JPEGs at a reduced DCT scale but keep >= 2x the largest
        # crop, so RandomResizedCrop's geometry is unchanged (only texture
        # finer than 2x the target is dropped)
        decode_min_size = 2 * cfg.image_size

        def jpeg_decoder(data):
            return native.decode_jpeg_scaled(data, min_size=decode_min_size)

    def shard_samples(shard):
        if not cfg.use_native_io:
            yield from tar_to_samples(shard)
            return
        with native.NativeTarStream([shard]) as stream:
            yield from stream

    epoch = epoch0
    while True:
        rng = random.Random(hash((cfg.seed, epoch, cfg.process_index, worker_index)))

        def sample_stream():
            for shard in shards.epoch_shards(epoch):
                for raw in shard_samples(shard):
                    decoded = decode_sample(raw, jpeg_decoder=jpeg_decoder)
                    if decoded is None:
                        continue
                    yield decoded

        k = cfg.num_sampled_captions
        buf: List = []
        for img, meta in shuffle_buffer(sample_stream(), cfg.shuffle_buffer, rng):
            try:
                crops = transform(img, rng) if cfg.use_multicrop else [transform(img, rng)]
                caps = sample_captions(meta, k, cfg.caption_sampling_mode, rng)
                tokens = tokenizer(caps)
            except Exception as e:
                logger.warning(f"worker {worker_index}: sample error {e!r}")
                continue
            buf.append((crops, tokens))
            if len(buf) == cfg.batch_size:
                out_q.put(_collate(buf, cfg))
                buf = []
        # epoch exhausted: adopt main's announced epoch only when it is
        # AHEAD of this worker, else self-advance.  The old drain-then-
        # increment turned a drained e+1 into e+2 (a worker finishing its
        # pass just after set_epoch(e+1) diverged from its siblings —
        # different shard permutations whose strided slices overlap, i.e.
        # duplicated/skipped shards within the epoch); symmetrically a
        # stale announcement must not drag a self-advanced worker BACK
        # into repeating an epoch.
        announced = None
        try:
            while True:
                announced = epoch_q.get_nowait()
        except queue_mod.Empty:
            pass
        if announced is not None and announced > epoch:
            epoch = announced
        else:
            epoch += 1


def collate_views(buf, g: int, n: int) -> Dict[str, np.ndarray]:
    """[(crops list, tokens [k, L])] -> views-major batch arrays.

    The one collation rule: the wds worker and SyntheticTrainLoader both
    batch through here."""
    out: Dict[str, np.ndarray] = {}
    gi = np.stack([np.stack([s[0][v] for s in buf]) for v in range(g)])
    out["global_images"] = gi  # [g, B, H, W, 3] uint8
    if n > 0:
        li = np.stack([np.stack([s[0][g + v] for s in buf]) for v in range(n)])
        out["local_images"] = li
    out["texts"] = np.stack(
        [np.stack([s[1][v] for s in buf]) for v in range(buf[0][1].shape[0])]
    )  # [k, B, L]
    return out


def _collate(buf, cfg: WdsTrainConfig) -> Dict[str, np.ndarray]:
    # non-multicrop workers produce ONE crop per sample (the reference's
    # plain train transform), whatever the crop-count fields say
    g = cfg.global_crops_number if cfg.use_multicrop else 1
    n = cfg.local_crops_number if cfg.use_multicrop else 0
    return collate_views(buf, g, n)


class WdsTrainLoader:
    """Infinite batch iterator over tar shards with worker processes.

    As in the JAX package, workers self-increment their epoch when a shard
    pass ends and drain ``set_epoch`` only between epochs, so a MID-epoch
    resume reproduces the shard set but not the exact intra-epoch sample
    order.  Epoch-boundary resumes (the reference's checkpoint cadence,
    --save-frequency in epochs) are order-exact.
    """

    # finished batches queued per worker
    QUEUE_PER_WORKER = 4

    def __init__(self, cfg: WdsTrainConfig):
        self.cfg = cfg
        self._epoch = 0
        self._procs: List = []
        self._epoch_qs: List = []
        self._q = None
        self._started = False

    def _start(self):
        # a worker whose strided shard split is empty would spin through
        # empty epoch passes forever, producing nothing at 100% CPU —
        # fail loudly instead (the reference asserts the same)
        total_workers = self.cfg.process_count * max(1, self.cfg.num_workers)
        if not self.cfg.resampled and len(self.cfg.urls) < total_workers:
            raise ValueError(
                f"{len(self.cfg.urls)} shards < {total_workers} total "
                "workers (process_count x num_workers): some workers would "
                "receive no shards; reduce --workers, add shards, or use "
                "--dataset-resampled"
            )
        if not self.cfg.resampled and self.cfg.weights is not None:
            # fail in the MAIN process, not 30s later via dead workers
            raise ValueError(
                "--train-data-upsampling-factors is only supported with "
                "--dataset-resampled "
            )
        if self.cfg.use_native_io:
            # build (or find) the native library here, once: a worker only
            # loads it, and a failed build raises in this process
            from cosmos_tpu_torch.data import native

            native.load()
        local = [u for u in self.cfg.urls if "://" not in str(u)]
        if local and not any(os.path.exists(u) for u in local):
            # every shard-open failure is nothrow-swallowed per sample
            # (reference semantics) — but NO shard existing at all means a
            # typo'd --train-data, which would otherwise hang at step 0
            # with workers spinning through empty epochs
            raise FileNotFoundError(
                f"none of the {len(local)} local tar shards exist "
                f"(first: {local[0]!r}) — check --train-data"
            )
        if self.cfg.num_workers == 0:
            self._started = True
            return
        # forkserver: workers fork from a clean server process — no re-exec
        # of __main__ (spawn would) and no inherited CUDA context (plain
        # fork would).
        ctx = mp.get_context("forkserver")
        self._q = ctx.Queue(
            maxsize=self.QUEUE_PER_WORKER * max(1, self.cfg.num_workers))
        for w in range(self.cfg.num_workers):
            eq = ctx.Queue()
            p = ctx.Process(
                target=_worker_loop,
                args=(self.cfg, w, self._epoch, self._q, eq),
                daemon=True,
            )
            p.start()
            self._procs.append(p)
            self._epoch_qs.append(eq)
        self._started = True

    def set_epoch(self, epoch: int):
        self._epoch = epoch
        for eq in self._epoch_qs:
            eq.put(epoch)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if not self._started:
            self._start()
        if self.cfg.num_workers == 0:
            yield from self._inline_iter()
            return
        while True:
            try:
                yield self._q.get(timeout=30.0)
            except queue_mod.Empty:
                if not any(p.is_alive() for p in self._procs):
                    raise RuntimeError(
                        "all data-loader workers died; see worker logs"
                    )

    def _inline_iter(self):
        """num_workers=0 debug path: the worker loop in ONE persistent
        daemon thread.  The thread and its epoch queue are created once
        and the queue is registered in _epoch_qs so set_epoch reaches the
        stream (a per-__iter__ thread with a throwaway queue would both
        leak a blocked thread per iter() call and silently ignore the
        deterministic epoch reseeding contract)."""
        if not self._procs:
            q: "queue_mod.Queue" = queue_mod.Queue(maxsize=2)
            eq: "queue_mod.Queue" = queue_mod.Queue()
            t = threading.Thread(
                target=_worker_loop,
                args=(dataclasses.replace(self.cfg, num_workers=1), 0,
                      self._epoch, q, eq),
                daemon=True,
            )
            t.start()
            self._q = q
            self._epoch_qs = [eq]
            self._procs = [t]
        while True:
            try:
                yield self._q.get(timeout=30.0)
            except queue_mod.Empty:
                # same fail-loudly contract as the multi-process path: a
                # dead inline thread must raise, not hang q.get() forever
                if not self._procs[0].is_alive():
                    raise RuntimeError(
                        "inline data-loader thread died; see logs above"
                    )

    def shutdown(self):
        for p in self._procs:
            if hasattr(p, "terminate"):   # inline path holds a daemon Thread
                p.terminate()
        self._procs = []


class MapDatasetLoader:
    """Batches of (first, second) item arrays from a map-style (eval)
    dataset, its items loaded by a pool of threads."""

    THREADS = 8

    def __init__(self, dataset, batch_size: int):
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.dataset)
        with ThreadPoolExecutor(self.THREADS) as pool:
            for start in range(0, n, self.batch_size):
                items = list(pool.map(self.dataset.__getitem__,
                                      range(start, min(n, start + self.batch_size))))
                yield (np.stack([np.asarray(it[0]) for it in items]),
                       np.stack([np.asarray(it[1]) for it in items]))


class WdsValLoader:
    """Single-pass (images [B,H,W,3] f32, texts [B,L]) batches over val tar
    shards with the eval transform: the contrastive val-loss input (not
    resampled)."""

    def __init__(self, urls, batch_size: int, image_size: int = 224,
                 context_length: int = 77, num_samples: Optional[int] = None,
                 eval_tf=None):
        self.urls = list(urls)
        self.batch_size = batch_size
        self.image_size = image_size
        self.context_length = context_length
        self.num_samples = num_samples
        # --image-mean/std/interpolation/resize-mode overrides arrive as a
        # prebuilt transform (transforms.eval_transform_from_args)
        self.eval_tf = eval_tf

    def __iter__(self):
        from cosmos_tpu_torch.data.caption import default_caption
        from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
        from cosmos_tpu_torch.data.transforms import EvalTransform
        from cosmos_tpu_torch.data.webdataset import decode_sample, tar_to_samples

        tokenizer = SimpleTokenizer(context_length=self.context_length)
        tf = self.eval_tf or EvalTransform(image_size=self.image_size)
        imgs, txts = [], []
        seen = 0
        for shard in self.urls:
            for raw in tar_to_samples(shard):
                decoded = decode_sample(raw)
                if decoded is None:
                    continue
                img, meta = decoded
                caption = default_caption(meta)
                imgs.append(tf(img))
                txts.append(tokenizer([caption])[0])
                seen += 1
                if len(imgs) == self.batch_size:
                    yield np.stack(imgs), np.stack(txts)
                    imgs, txts = [], []
                if self.num_samples and seen >= self.num_samples:
                    break
            if self.num_samples and seen >= self.num_samples:
                break
        if imgs:
            yield np.stack(imgs), np.stack(txts)
