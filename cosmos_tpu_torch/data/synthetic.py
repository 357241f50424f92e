"""Synthetic data on disk, made from a seed with numpy, in the layouts the
trainer and the evals read: webdataset tar shards whose samples carry an
image and a JSON with the seven DreamLIP caption fields, a COCO retrieval
directory, a CSV of (image path, caption) rows, ImageNet-style class
folders, a CIFAR-10 test batch, and the mmseg layouts of the segmentation
benchmarks.  For smoke runs and for tests; no counterpart in the JAX
package.

    write_shards("data/train-{i:04d}.tar", n_shards=8, samples_per_shard=96)
    write_csv("data/csv", n_rows=512)       # data/csv/train.csv, images/
    write_coco("data/coco", n_images=64)
    write_image_folder("data/imagenet/val", n_classes=1000, per_class=1)
    write_cifar10("data/classification/cifar10", n_images=2000)
    write_segmentation("data/seg", "voc", sizes=[(500, 375)] * 16)
"""

from __future__ import annotations

import io
import json
import os
import pickle
import tarfile
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence, Tuple

import numpy as np

from .caption import DREAMLIP_FIELDS

WORDS = (
    "a photo of the cat dog tree house car boat sky cloud river mountain red "
    "green blue tiny huge wooden plastic shiny old young running sitting "
    "under over near with beside street field beach forest city night day"
).split()


def _sentence(rng: np.random.Generator) -> str:
    return " ".join(rng.choice(WORDS, size=int(rng.integers(3, 12))))


def _caption(rng: np.random.Generator) -> str:
    """1-3 sentences."""
    return ". ".join(_sentence(rng) for _ in range(int(rng.integers(1, 4))))


def _image_bytes(rng: np.random.Generator, size: Tuple[int, int],
                 fmt: str) -> bytes:
    """A smooth random image (w, h) as PNG or JPEG bytes."""
    from PIL import Image

    w, h = size
    coarse = rng.integers(0, 208, (h // 32 + 2, w // 32 + 2, 3), np.uint8)
    img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
    arr = np.asarray(img) + rng.integers(0, 48, (h, w, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG" if fmt == "png" else "JPEG",
                              **({} if fmt == "png" else {"quality": 90}))
    return buf.getvalue()


def write_csv(root: str, n_rows: int, *, seed: int = 0, fmt: str = "png",
              sep: str = "\t", size_range: Tuple[int, int] = (64, 160)) -> str:
    """``<root>/train.csv`` (``.tsv`` for a tab ``sep``) with the trainer's
    default header, ``filepath`` and ``title``, and ``n_rows`` rows: the
    absolute path of an image under ``<root>/images`` (width and height
    drawn from ``size_range``, ``fmt`` 'png' or 'jpg') and a caption of 1-3
    sentences; row i draws from the seed (seed, i).  Returns the CSV's
    path."""
    import csv

    images = os.path.join(root, "images")
    os.makedirs(images, exist_ok=True)

    def write(i: int) -> Tuple[str, str]:
        rng = np.random.default_rng([seed, i])
        size = tuple(int(v) for v in rng.integers(*size_range, 2))
        path = os.path.abspath(os.path.join(images, f"{i:06d}.{fmt}"))
        with open(path, "wb") as f:
            f.write(_image_bytes(rng, size, fmt))
        return path, _caption(rng)

    with ThreadPoolExecutor(max_workers=8) as pool:
        rows = list(pool.map(write, range(n_rows)))
    path = os.path.join(root, "train.tsv" if sep == "\t" else "train.csv")
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=sep)
        w.writerow(["filepath", "title"])
        w.writerows(rows)
    return path


def _add(tf: tarfile.TarFile, name: str, data: bytes) -> None:
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def write_shards(pattern: str, n_shards: int, samples_per_shard: int, *,
                 seed: int = 0, fmt: str = "jpg",
                 size_range: Tuple[int, int] = (256, 640)) -> List[str]:
    """``n_shards`` tars named ``pattern.format(i=shard)``, each with
    ``samples_per_shard`` samples: an image of width and height drawn from
    ``size_range`` (``fmt`` 'jpg' or 'png') and a JSON with the seven
    DreamLIP caption fields of 1-3 sentences each; shard i draws from the
    seed (seed, i).  Returns the paths."""
    def write(s: int) -> str:
        rng = np.random.default_rng([seed, s])
        path = pattern.format(i=s)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with tarfile.open(path, "w") as tf:
            for j in range(samples_per_shard):
                key = f"{s:04d}{j:05d}"
                size = tuple(int(v) for v in rng.integers(
                    size_range[0], size_range[1] + 1, 2))
                meta = {f: [_caption(rng)] for f in DREAMLIP_FIELDS}
                _add(tf, f"{key}.{fmt}", _image_bytes(rng, size, fmt))
                _add(tf, f"{key}.json", json.dumps(meta).encode())
        return path

    # one thread a shard: PIL's encoders release the GIL
    with ThreadPoolExecutor(min(8, n_shards)) as pool:
        return list(pool.map(write, range(n_shards)))


def write_coco(root: str, n_images: int, *, captions_per_image: int = 5,
               seed: int = 0, fmt: str = "jpg",
               size_range: Tuple[int, int] = (256, 640)) -> str:
    """A COCO val layout under ``root``: ``annotations/
    captions_val2017.json`` and ``images/val2017/``.  Returns ``root``."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images", "val2017")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        name = f"{i:012d}.{fmt}"
        size = tuple(int(v) for v in rng.integers(
            size_range[0], size_range[1] + 1, 2))
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(_image_bytes(rng, size, fmt))
        images.append({"id": i, "file_name": name})
        for _ in range(captions_per_image):
            annotations.append({"id": len(annotations), "image_id": i,
                                "caption": _sentence(rng)})
    with open(os.path.join(root, "annotations", "captions_val2017.json"),
              "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return root


def _write_image(path: str, rng: np.random.Generator, size: Tuple[int, int],
                 fmt: str = "jpg") -> None:
    with open(path, "wb") as f:
        f.write(_image_bytes(rng, size, fmt))


def write_image_folder(root: str, n_classes: int, per_class: int, *,
                       seed: int = 0, numeric: bool = False,
                       size_range: Tuple[int, int] = (256, 500)) -> str:
    """Class folders under ``root`` (ImageNet val's layout: ``n%08d`` dirs,
    or ImageNetV2's ``0..n-1`` with ``numeric``), ``per_class`` JPEGs of
    width and height drawn from ``size_range`` in each; class c draws from
    the seed (seed, c).  Returns ``root``."""
    def write(c: int) -> None:
        rng = np.random.default_rng([seed, c])
        d = os.path.join(root, str(c) if numeric else f"n{c:08d}")
        os.makedirs(d, exist_ok=True)
        for j in range(per_class):
            size = tuple(int(v) for v in rng.integers(
                size_range[0], size_range[1] + 1, 2))
            _write_image(os.path.join(d, f"img_{j:04d}.jpg"), rng, size)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(n_classes)))
    return root


def write_cifar10(root: str, n_images: int, *, seed: int = 0) -> str:
    """``root/cifar-10-batches-py/test_batch``: the CIFAR-10 python pickle
    of ``n_images`` seeded 32×32 images and labels 0–9.  Returns ``root``."""
    rng = np.random.default_rng(seed)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d, exist_ok=True)
    batch = {b"data": rng.integers(0, 256, (n_images, 3 * 32 * 32), np.uint8),
             b"labels": [int(v) for v in rng.integers(0, 10, n_images)]}
    with open(os.path.join(d, "test_batch"), "wb") as f:
        pickle.dump(batch, f)
    return root


# the mmseg layouts of the segmentation benchmarks (the segmentation
# package's configs): image dir, label dir, split file or None
SEG_LAYOUTS = {
    "voc": ("JPEGImages", "SegmentationClass",
            "ImageSets/Segmentation/val.txt"),
    "ade20k": ("images/validation", "annotations/validation", None),
}


def write_segmentation(root: str, layout: str, sizes: Sequence[Tuple[int, int]],
                       *, n_labels: int = 21, seed: int = 0) -> str:
    """One benchmark's layout under ``root`` (``SEG_LAYOUTS``): a JPEG of
    each (width, height) in ``sizes`` and a PNG label map of blocks of
    labels 0..n_labels-1, with about 5% of the pixels 255 (ignored).
    Returns ``root``."""
    from PIL import Image

    img_dir, ann_dir, split = SEG_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, img_dir), exist_ok=True)
    os.makedirs(os.path.join(root, ann_dir), exist_ok=True)
    stems = []
    for i, (w, h) in enumerate(sizes):
        stem = f"{layout}_{i:06d}"
        stems.append(stem)
        _write_image(os.path.join(root, img_dir, f"{stem}.jpg"), rng, (w, h))
        blocks = rng.integers(0, n_labels, (h // 32 + 1, w // 32 + 1))
        label = np.kron(blocks, np.ones((32, 32), np.int64))[:h, :w]
        label[rng.random((h, w)) < 0.05] = 255
        Image.fromarray(label.astype(np.uint8)).save(
            os.path.join(root, ann_dir, f"{stem}.png"))
    if split:
        os.makedirs(os.path.dirname(os.path.join(root, split)), exist_ok=True)
        with open(os.path.join(root, split), "w") as f:
            f.write("\n".join(stems) + "\n")
    return root
