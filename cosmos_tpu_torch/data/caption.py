"""Caption sampling and text cropping for recaptioned datasets (counterpart
of ``cosmos_tpu/data/caption.py``; the same ``random.Random`` calls in the
same order, so a seed gives the same captions).

The sample json carries 7 DreamLIP caption fields (raw_caption,
short/long {IB,SV,LLA}_captions) or pixelprose fields (original_caption,
caption).  'textcrop' mode builds 2 global captions by joining 1-5
randomly sampled sentences and k-2 local captions of one sentence each.
"""

from __future__ import annotations

import random as _random
import re
from typing import Dict, List

import numpy as np

DREAMLIP_FIELDS = (
    "raw_caption",
    "shortIB_captions",
    "shortSV_captions",
    "shortLLA_captions",
    "longIB_captions",
    "longSV_captions",
    "longLLA_captions",
)


def split_caption(text: str) -> List[str]:
    """Split on newline / </s> / '.' sentence markers."""
    return [cap.strip() for cap in re.split(r"\n|</s>|[.]", text) if cap.strip()]


def random_sample_from_list(
    captions: List[str], num: int, rng=_random
) -> List[str]:
    """Sample without replacement; when the pool is smaller, minimize
    duplicates by tiling."""
    n = len(captions)
    if n >= num:
        return rng.sample(captions, num)
    div, remain = divmod(num, n)
    return div * captions + rng.sample(captions, remain)


def _as_list(x) -> List[str]:
    if x is None:
        return []
    if isinstance(x, str):
        return [x]
    return list(x)


def sample_captions(
    text: Dict,
    k: int = 3,
    sampling_mode: str = "textcrop",
    rng=_random,
) -> List[str]:
    """Returns k caption strings for one sample."""
    if sampling_mode == "raw":
        assert k == 1
        # empty/absent raw_caption falls back to "" like the DreamLIP
        # pools below — divmod(k, 0) in random_sample_from_list is not a
        # useful way to report a caption-less sample
        return random_sample_from_list(
            _as_list(text.get("raw_caption")) or [""], k, rng
        )
    if sampling_mode == "raw_pixelprose":
        return [str(text.get("original_caption") or "")]

    if sampling_mode in ("random", "textcrop", "short", "long"):
        if sampling_mode == "short":
            fields = DREAMLIP_FIELDS[:4]
        elif sampling_mode == "long":
            fields = DREAMLIP_FIELDS[4:]
        else:
            fields = DREAMLIP_FIELDS
        pool: List[str] = []
        for f in fields:
            pool.extend(_as_list(text.get(f)))
        if not pool:
            pool = [""]
        if sampling_mode == "textcrop":
            assert k >= 2
            global_nums = [rng.randint(1, 5) for _ in range(2)]
            global_caps = [
                ". ".join(random_sample_from_list(pool, num, rng))
                for num in global_nums
            ]
            local_caps = random_sample_from_list(pool, k - 2, rng)
            return global_caps + local_caps
        return random_sample_from_list(pool, k, rng)

    if sampling_mode in ("random_pixelprose", "textcrop_pixelprose"):
        pool = _as_list(text.get("original_caption")) + split_caption(
            str(text.get("caption") or "")
        )
        if not pool:
            pool = [""]
        if sampling_mode == "textcrop_pixelprose":
            assert k >= 2
            global_nums = [rng.randint(1, 5) for _ in range(2)]
            global_caps = [
                ". ".join(random_sample_from_list(pool, num, rng))
                for num in global_nums
            ]
            local_caps = random_sample_from_list(pool, k - 2, rng)
            return global_caps + local_caps
        return random_sample_from_list(pool, k, rng)

    raise NotImplementedError(f"invalid caption sampling mode {sampling_mode}")


def default_caption(meta: Dict) -> str:
    """Best-available single eval caption for a sample's json/txt meta:
    raw_caption, else the pixelprose original_caption, else the first
    'caption' sentence, else "".  Val loaders use this so a
    pixelprose-style val shard doesn't silently evaluate against
    all-empty text (every field is str-coerced — nested json values
    must not crash the single-pass val loop)."""
    for field in ("raw_caption", "original_caption", "caption"):
        pool = _as_list(meta.get(field))
        if pool:
            first = pool[0]
            return first if isinstance(first, str) else str(first)
    return ""


def sample_and_tokenize(
    text: Dict, k: int, tokenizer, sampling_mode: str = "textcrop", rng=_random
) -> np.ndarray:
    """[k, context_length] int32 token ids."""
    return tokenizer(sample_captions(text, k, sampling_mode, rng))
