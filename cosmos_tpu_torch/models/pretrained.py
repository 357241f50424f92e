"""The pretrained-checkpoint registry and its offline resolution
(counterpart of ``cosmos_tpu/models/pretrained.py``).

The registry is the JAX package's: the released COSMOS checkpoints with
their published eval numbers, OpenAI's CLIP releases, Apple's MobileCLIP,
EVA02-CLIP and SigLIP, each with its preprocessing.  ``resolve_pretrained``
turns a tag into a file in the cache directory (``default_cache_dir``, the
JAX package's ``COSMOS_TPU_CACHE``) and never downloads: a file that is not
there, or fails the sha256 its URL carries, is refused naming the URL.  The
HF hub's own cache is not read.
"""

from __future__ import annotations

import hashlib
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional

COSMOS_HF_REPO = "sankim2/cosmos"

# ROADMAP's item, by title, for what needs the network
NEEDS_DOWNLOAD = 'queue 1, "Not queued": it needs a download'

# model name -> tag -> cfg
_PRETRAINED: Dict[str, Dict[str, Dict[str, Any]]] = {}

_OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
_OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)


def _cosmos_cfg(arch: str, dataset: str, metrics) -> Dict[str, Any]:
    fname = f"cosmos_vit{arch}_{dataset}.pt"
    return {
        "hf_repo": COSMOS_HF_REPO,
        "hf_filename": fname,
        "url": f"https://huggingface.co/{COSMOS_HF_REPO}/resolve/main/{fname}",
        "mean": _OPENAI_MEAN,
        "std": _OPENAI_STD,
        "cosmos": True,
        "metrics": dict(zip(
            ("coco_i2t_r1", "coco_t2i_r1", "flickr_i2t_r1", "flickr_t2i_r1",
             "imagenet_top1"), metrics)),
    }


# the published numbers of the COSMOS releases
_B16_METRICS = {
    "cc3m": (53.1, 40.1, 84.1, 68.6, 37.1),
    "cc12m": (64.2, 48.9, 91.4, 76.2, 51.4),
    "yfcc15m": (67.5, 50.9, 92.6, 79.6, 52.4),
    "merged30m": (68.0, 52.5, 92.9, 80.3, 57.6),
    "pixelprose": (62.4, 43.4, 89.9, 73.6, 59.6),
}
_B32_METRICS = {
    "cc3m": (47.6, 33.5, 74.3, 59.2, 33.0),
    "cc12m": (59.6, 43.0, 86.5, 69.8, 46.7),
    "yfcc15m": (64.5, 46.0, 90.2, 73.3, 48.1),
    "merged30m": (64.3, 48.4, 89.9, 76.1, 53.4),
    "pixelprose": (57.2, 38.9, 85.6, 66.3, 54.3),
}

_PRETRAINED["ViT-B-16"] = {
    f"cosmos_{ds}": _cosmos_cfg("b16", ds, m) for ds, m in _B16_METRICS.items()
}
_PRETRAINED["ViT-B-32"] = {
    f"cosmos_{ds}": _cosmos_cfg("b32", ds, m) for ds, m in _B32_METRICS.items()
}

# OpenAI's CLIP releases: TorchScript archives whose URL carries the sha256
_OPENAI_BASE = "https://openaipublic.azureedge.net/clip/models"
_OPENAI_CKPTS = {
    "RN50": "afeb0e10f9e5a86da6080e35cf09123aca3b358a0c3e3b6c78a7b63bc04b6762/RN50.pt",
    "RN101": "8fa8567bab74a42d41c5915025a8e4538c3bdbe8804a470a72f30b0d94fab599/RN101.pt",
    "RN50x4": "7e526bd135e493cef0776de27d5f42653e6b4c8bf9e0f653bb11773263205fdd/RN50x4.pt",
    "RN50x16": "52378b407f34354e150460fe41077663dd5b39c54cd0bfd2b27167a4a06ec9aa/RN50x16.pt",
    "RN50x64": "be1cfb55d75a9666199fb2206c106743da0f6468c9d327f3e0d0a543a9919d9c/RN50x64.pt",
    "ViT-B-32": "40d365715913c9da98579312b702a82c18be219cc2a73407c4526f58eba950af/ViT-B-32.pt",
    "ViT-B-16": "5806e77cd80f8b59890b7e101eabd078d9fb84e6937f9e85e4ecb61988df416f/ViT-B-16.pt",
    "ViT-L-14": "b8cca3fd41ae0c99ba7e8951adf17d267cdb84cd88be6f7c2e0eca1737a03836/ViT-L-14.pt",
    "ViT-L-14-336": "3035c92b350959924f9f00213499208652fc7ea050643e8b385c2dac08641f02/ViT-L-14-336px.pt",
}
for _name, _path in _OPENAI_CKPTS.items():
    _PRETRAINED.setdefault(_name, {})["openai"] = {
        "url": f"{_OPENAI_BASE}/{_path}",
        "mean": _OPENAI_MEAN,
        "std": _OPENAI_STD,
    }

# Apple's MobileCLIP releases: identity mean/std, bilinear resize
for _name, _tags in (
    ("MobileCLIP-S1", {"datacompdr": "s1"}),
    ("MobileCLIP-S2", {"datacompdr": "s2"}),
    ("MobileCLIP-B", {"datacompdr": "b", "datacompdr_lt": "blt"}),
):
    _PRETRAINED[_name] = {
        tag: {
            "url": ("https://docs-assets.developer.apple.com/ml-research/"
                    f"datasets/mobileclip/mobileclip_{_file}.pt"),
            "mean": (0.0, 0.0, 0.0),
            "std": (1.0, 1.0, 1.0),
            "interpolation": "bilinear",
            "resize_mode": "shortest",
        }
        for tag, _file in _tags.items()
    }

# EVA02-CLIP releases, on the HF hub only
for _name, _tag, _repo in (
    ("EVA02-B-16", "merged2b_s8b_b131k",
     "timm/eva02_base_patch16_clip_224.merged2b_s8b_b131k"),
    ("EVA02-L-14", "merged2b_s4b_b131k",
     "timm/eva02_large_patch14_clip_224.merged2b_s4b_b131k"),
):
    _PRETRAINED.setdefault(_name, {})[_tag] = {
        "hf_repo": _repo,
        "hf_filename": "open_clip_pytorch_model.bin",
        "mean": _OPENAI_MEAN,
        "std": _OPENAI_STD,
    }

# SigLIP webli releases, on the HF hub only: Inception mean/std, squash
for _name, _repo in (("ViT-B-16-SigLIP", "timm/ViT-B-16-SigLIP"),):
    _PRETRAINED.setdefault(_name, {})["webli"] = {
        "hf_repo": _repo,
        "hf_filename": "open_clip_pytorch_model.bin",
        "mean": (0.5, 0.5, 0.5),
        "std": (0.5, 0.5, 0.5),
        "interpolation": "bicubic",
        "resize_mode": "squash",
    }


def list_pretrained() -> List[str]:
    return [f"{model}:{tag}" for model, tags in _PRETRAINED.items()
            for tag in tags]


def list_pretrained_tags_by_model(model: str) -> List[str]:
    return list(_PRETRAINED.get(model, {}))


def get_pretrained_cfg(model: str, tag: str) -> Dict[str, Any]:
    return _PRETRAINED.get(model, {}).get(tag, {})


def list_pretrained_models_by_tag(tag: str) -> List[str]:
    """Models that have a checkpoint under ``tag``."""
    return [m for m, tags in _PRETRAINED.items() if tag in tags]


def is_pretrained_cfg(model: str, tag: str) -> bool:
    return bool(get_pretrained_cfg(model, tag))


def get_pretrained_url(model: str, tag: str) -> str:
    return get_pretrained_cfg(model, tag).get("url", "")


def default_cache_dir() -> str:
    return os.environ.get(
        "COSMOS_TPU_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "cosmos_tpu"),
    )


def _url_sha256(url: str) -> Optional[str]:
    """The sha256 an OpenAI release URL carries as a path segment."""
    m = re.search(r"/([0-9a-f]{40,64})/", url)
    return m.group(1) if m else None


def _sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            digest.update(block)
    return digest.hexdigest()


def cached_pretrained_path(cfg: Dict[str, Any],
                           cache_dir: Optional[str] = None) -> str:
    """The cached file of a registry entry: its ``file``, or
    ``cache_dir/<the URL's basename>`` when that exists and passes the
    URL's sha256.  Anything else needs a download and is refused."""
    if "file" in cfg:
        return cfg["file"]
    url = cfg.get("url")
    if not url:
        raise NotImplementedError(
            f"the checkpoint is on the HF hub only ({cfg.get('hf_repo')}/"
            f"{cfg.get('hf_filename')}); the port reads no HF-hub cache and "
            f"does not download (ROADMAP {NEEDS_DOWNLOAD}): pass a local "
            "path")
    target = Path(cache_dir or default_cache_dir()) / Path(
        url.split("?")[0]).name
    if not target.exists():
        raise NotImplementedError(
            f"{target} is not cached and downloads are not ported (ROADMAP "
            f"{NEEDS_DOWNLOAD}): fetch {url} there, or pass a local path")
    expected = _url_sha256(url)
    if expected and not _sha256(target).startswith(expected):
        raise NotImplementedError(
            f"{target} fails its sha256 ({expected}) and downloads are not "
            f"ported (ROADMAP {NEEDS_DOWNLOAD}): fetch {url} again")
    return str(target)


def resolve_pretrained(model_name: str, pretrained: str,
                       cache_dir: Optional[str] = None) -> str:
    """A path (returned as it is) or a registry tag -> a local file."""
    if os.path.exists(pretrained):
        return pretrained
    cfg = get_pretrained_cfg(model_name, pretrained)
    if not cfg:
        raise ValueError(
            f"unknown pretrained tag {pretrained!r} for {model_name}; "
            f"available: {list_pretrained_tags_by_model(model_name)}"
        )
    return cached_pretrained_path(cfg, cache_dir)
