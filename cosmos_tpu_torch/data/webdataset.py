"""Tar-shard ("webdataset") streaming reader with deterministic sharding
(counterpart of ``cosmos_tpu/data/webdataset.py``):
  - brace-pattern shard lists ('cc3m-train-{0000..0575}.tar');
  - a deterministic per-epoch shard shuffle keyed on seed + epoch;
  - weighted shard resampling with replacement;
  - per-host and per-worker shard splitting, (process_index,
    process_count) x worker id;
  - tolerant tar -> sample grouping: corrupt members logged and skipped,
    duplicate keys tolerated;
  - a sample shuffle buffer.

Pure stdlib (tarfile) + PIL; no webdataset dependency.  The training
loader streams shards through ``data/native.py`` instead and hands its
DCT-scaled JPEG decoder to ``decode_sample``.
"""

from __future__ import annotations

import io
import json
import logging
import random
import re
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence

logger = logging.getLogger(__name__)

IMG_EXTS = ("jpg", "jpeg", "png", "webp")


def braceexpand(pattern: str) -> List[str]:
    """Expand '{0000..0575}' numeric ranges and '{a,b,c}' lists."""
    m_range = re.search(r"\{(\d+)\.\.(\d+)\}", pattern)
    m_list = re.search(r"\{([^{}]*,[^{}]*)\}", pattern)
    # expand the LEFTMOST brace group first so nested expansion order
    # matches shell brace expansion
    if m_range and (not m_list or m_range.start() < m_list.start()):
        lo, hi = m_range.group(1), m_range.group(2)
        width = len(lo)
        out = []
        for v in range(int(lo), int(hi) + 1):
            out.extend(
                braceexpand(
                    pattern[: m_range.start()]
                    + str(v).zfill(width)
                    + pattern[m_range.end():]
                )
            )
        return out
    if m_list:
        out = []
        for part in m_list.group(1).split(","):
            out.extend(
                braceexpand(pattern[: m_list.start()] + part + pattern[m_list.end():])
            )
        return out
    return [pattern]


def expand_urls(urls, weights: Optional[str] = None):
    """'path1::path2' with optional '--train-data-upsampling-factors'
    weights 'w1::w2'."""
    if isinstance(urls, str):
        url_list = urls.split("::")
        w = weights.split("::") if weights else None
        if w is not None:
            assert len(w) == len(url_list), (
                "number of weights must match number of url specs"
            )
        all_urls, all_weights = [], []
        for i, u in enumerate(url_list):
            expanded = braceexpand(u)
            all_urls.extend(expanded)
            if w is not None:
                all_weights.extend([float(w[i])] * len(expanded))
        return all_urls, (all_weights if w is not None else None)
    # pre-expanded list input: keep the caller's weights instead of
    # silently discarding them (reference expand_urls returns both)
    if weights is None:
        return list(urls), None
    w = weights.split("::") if isinstance(weights, str) else list(weights)
    assert len(w) == len(urls), (
        "number of weights must match number of urls"
    )
    return list(urls), [float(x) for x in w]


def log_and_continue(exn) -> bool:
    """Sample-level error handler: log and go on."""
    logger.warning(f"Handling webdataset error ({repr(exn)}). Ignoring.")
    return True


def tar_to_samples(path: str) -> Iterator[Dict[str, bytes]]:
    """Stream one tar shard into {key, ext: bytes} sample dicts.

    Groups consecutive members sharing the basename prefix; tolerates
    duplicate keys and truncated members (nothrow semantics).
    """
    current_key = None
    sample: Dict[str, bytes] = {}
    try:
        with tarfile.open(path, mode="r|*") as tf:
            for member in tf:
                if not member.isfile():
                    continue
                name = member.name
                # split on the first dot of the BASENAME (webdataset's
                # base_plus_ext): a dotted directory like 'v1.2/0001.jpg'
                # must not break key grouping
                dirname, _, base = name.rpartition("/")
                if "." not in base:
                    continue
                stem, ext = base.split(".", 1)
                key = f"{dirname}/{stem}" if dirname else stem
                ext = ext.lower()
                try:
                    data = tf.extractfile(member).read()
                except Exception as e:  # truncated member
                    log_and_continue(e)
                    continue
                # a repeated extension within the same key starts a NEW
                # sample (the reference's group_by_keys_nothrow
                # — concatenated tars with repeated keys must yield every
                # pair, not silently drop the later ones)
                if key != current_key or ext in sample:
                    if sample and current_key is not None:
                        yield dict(sample, __key__=current_key.encode())
                    current_key, sample = key, {}
                sample[ext] = data
            if sample and current_key is not None:
                yield dict(sample, __key__=current_key.encode())
    except Exception as e:  # corrupt shard
        log_and_continue(e)


class ShardedShardList:
    """Deterministic epoch-shuffled, host/worker-split shard iterator."""

    def __init__(
        self,
        urls: Sequence[str],
        weights: Optional[Sequence[float]] = None,
        *,
        shuffle: bool = True,
        seed: int = 0,
        resampled: bool = False,
        process_index: int = 0,
        process_count: int = 1,
        worker_index: int = 0,
        worker_count: int = 1,
    ):
        self.urls = list(urls)
        self.weights = list(weights) if weights is not None else None
        self.shuffle = shuffle
        self.seed = seed
        self.resampled = resampled
        self.process_index = process_index
        self.process_count = process_count
        self.worker_index = worker_index
        self.worker_count = worker_count

    def _split(self, shards: List[str]) -> List[str]:
        stride = self.process_count * self.worker_count
        offset = self.process_index * self.worker_count + self.worker_index
        return shards[offset::stride]

    def epoch_shards(self, epoch: int) -> Iterator[str]:
        if self.resampled:
            # weighted sampling with replacement, deterministic per
            # (seed, epoch, worker)
            rng = random.Random(hash((self.seed, epoch, self.process_index,
                                       self.worker_index)))
            # each worker draws its per-epoch share of the shard budget
            n = max(1, len(self.urls) // (self.process_count * self.worker_count))
            for _ in range(n):
                yield rng.choices(self.urls, weights=self.weights, k=1)[0]
            return
        if self.weights is not None:
            # the strided no-replacement split cannot honor per-source
            # weights; silently uniform sampling would betray the
            # --train-data-upsampling-factors request (the reference
            # asserts the same)
            raise ValueError(
                "--train-data-upsampling-factors is only supported with "
                "--dataset-resampled (sampling with replacement)"
            )
        shards = list(self.urls)
        if self.shuffle:
            rng = random.Random(self.seed + epoch)  # detshuffle2 keying
            rng.shuffle(shards)
        yield from self._split(shards)


def shuffle_buffer(
    it: Iterator, bufsize: int, rng: random.Random
) -> Iterator:
    buf: List = []
    for x in it:
        if len(buf) < bufsize:
            buf.append(x)
            continue
        idx = rng.randrange(len(buf))
        buf[idx], x = x, buf[idx]
        yield x
    rng.shuffle(buf)
    yield from buf


def decode_sample(sample: Dict[str, bytes], jpeg_decoder=None):
    """bytes -> (PIL image, caption dict) or None if not a valid pair.

    ``jpeg_decoder(data) -> np.ndarray | None`` decodes a JPEG member (the
    native DCT-scaled decoder); where it returns None or raises (a CMYK or
    corrupt JPEG), PIL decodes the member, as every other image."""
    from PIL import Image

    img_bytes = None
    img_ext = None
    for ext in IMG_EXTS:
        if ext in sample:
            img_bytes = sample[ext]
            img_ext = ext
            break
    meta = None
    if "json" in sample:
        try:
            meta = json.loads(sample["json"])
        except Exception as e:
            log_and_continue(e)
            return None
    elif "txt" in sample:
        meta = {"raw_caption": [sample["txt"].decode("utf-8", "replace")]}
    if not img_bytes or meta is None:  # absent OR zero-length member
        return None
    if jpeg_decoder is not None and img_ext in ("jpg", "jpeg"):
        try:
            arr = jpeg_decoder(img_bytes)
        except Exception as e:
            log_and_continue(e)
            arr = None
        if arr is not None:
            return Image.fromarray(arr), meta
    try:
        img = Image.open(io.BytesIO(img_bytes))
        img.load()
    except Exception as e:
        log_and_continue(e)
        return None
    return img, meta
