"""Readers for the 10 zero-shot classification eval sets (counterpart of
``cosmos_tpu/data/classification.py``), each on the set's own files, with
no torchvision:

  cifar10/cifar100 — python pickle batch files;
  food101          — images/ + meta/test.txt class/name lists;
  sun397           — ClassName.txt + Partitions/Testing_01.txt;
  fgvc_aircraft    — data/images + images_variant_test.txt;
  dtd              — images/<class>/ + labels/test1.txt;
  oxford_pets      — images/ + annotations/test.txt;
  flowers102       — jpg/ + imagelabels.mat + setid.mat (scipy);
  stanford_car     — cars_test/ + cars_test_annos_withlabels.mat (scipy);
  caltech101       — 101_ObjectCategories class folders.

Every reader returns a list of (image path or uint8 array, label index),
labels in the order of the prompt banks (``assets/classification_banks.json``);
``ClassificationDataset`` applies the eval transform.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

Sample = Tuple[Union[str, np.ndarray], int]


def _read_cifar(root: Path, is_cifar100: bool) -> List[Sample]:
    if is_cifar100:
        files = [root / "cifar-100-python" / "test"]
        label_key = b"fine_labels"
    else:
        files = [root / "cifar-10-batches-py" / "test_batch"]
        label_key = b"labels"
    samples: List[Sample] = []
    for f in files:
        with open(f, "rb") as fh:
            batch = pickle.load(fh, encoding="bytes")
        data = batch[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        for img, lab in zip(data, batch[label_key]):
            samples.append((img, int(lab)))
    return samples


def _read_food101(root: Path) -> List[Sample]:
    classes = sorted(
        (root / "meta" / "classes.txt").read_text().split()
    )
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for line in (root / "meta" / "test.txt").read_text().split():
        cls = line.split("/")[0]
        samples.append((str(root / "images" / f"{line}.jpg"), cls_idx[cls]))
    return samples


def _read_sun397(root: Path) -> List[Sample]:
    classes = [
        c.strip() for c in (root / "ClassName.txt").read_text().splitlines()
        if c.strip()
    ]
    cls_idx = {c: i for i, c in enumerate(classes)}
    part = root / "Partitions" / "Testing_01.txt"
    if not part.exists():
        part = root / "Testing_01.txt"
    samples = []
    for line in part.read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        cls = "/".join(line.split("/")[:-1])
        samples.append((str(root) + line, cls_idx[cls]))
    return samples


def _read_fgvc_aircraft(root: Path) -> List[Sample]:
    data = root / "data"
    classes = [
        c.strip() for c in (data / "variants.txt").read_text().splitlines()
        if c.strip()
    ]
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for line in (data / "images_variant_test.txt").read_text().splitlines():
        if not line.strip():
            continue
        img_id, variant = line.split(" ", 1)
        samples.append(
            (str(data / "images" / f"{img_id}.jpg"), cls_idx[variant.strip()])
        )
    return samples


def _read_dtd(root: Path) -> List[Sample]:
    classes = sorted(d.name for d in (root / "images").iterdir() if d.is_dir())
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for line in (root / "labels" / "test1.txt").read_text().split():
        cls = line.split("/")[0]
        samples.append((str(root / "images" / line), cls_idx[cls]))
    return samples


def _read_oxford_pets(root: Path) -> List[Sample]:
    samples = []
    names = set()
    rows = []
    for line in (root / "annotations" / "test.txt").read_text().splitlines():
        if not line.strip() or line.startswith("#"):
            continue
        img, class_id, *_ = line.split()
        name = "_".join(img.split("_")[:-1]).lower()
        names.add(name)
        rows.append((img, name))
    classes = sorted(names)
    cls_idx = {c: i for i, c in enumerate(classes)}
    for img, name in rows:
        samples.append((str(root / "images" / f"{img}.jpg"), cls_idx[name]))
    return samples


def _read_flowers102(root: Path) -> List[Sample]:
    from scipy.io import loadmat

    labels = loadmat(root / "imagelabels.mat")["labels"][0]
    setid = loadmat(root / "setid.mat")
    test_ids = setid["tstid"][0]
    samples = []
    for i in test_ids:
        samples.append(
            (str(root / "jpg" / f"image_{i:05d}.jpg"), int(labels[i - 1]) - 1)
        )
    return samples


def _read_stanford_car(root: Path) -> List[Sample]:
    from scipy.io import loadmat

    annos = loadmat(root / "cars_test_annos_withlabels.mat")["annotations"][0]
    samples = []
    for a in annos:
        label = int(a["class"][0][0]) - 1
        fname = str(a["fname"][0])
        samples.append((str(root / "cars_test" / fname), label))
    return samples


def _read_caltech101(root: Path) -> List[Sample]:
    base = root / "101_ObjectCategories"
    classes = sorted(
        d.name for d in base.iterdir()
        if d.is_dir() and d.name != "BACKGROUND_Google"
    )
    cls_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        for f in sorted((base / c).glob("*.jpg")):
            samples.append((str(f), cls_idx[c]))
    return samples


_READERS = {
    "cifar10": lambda r: _read_cifar(r, False),
    "cifar100": lambda r: _read_cifar(r, True),
    "food101": _read_food101,
    "sun397": _read_sun397,
    "aircraft": _read_fgvc_aircraft,
    "fgvc_aircraft": _read_fgvc_aircraft,
    "dtd": _read_dtd,
    "pets": _read_oxford_pets,
    "oxford_pets": _read_oxford_pets,
    "flowers": _read_flowers102,
    "flowers102": _read_flowers102,
    "stanford_car": _read_stanford_car,
    "caltech101": _read_caltech101,
}


class ClassificationDataset:
    """(transformed image, label) eval dataset for one benchmark."""

    def __init__(self, name: str, root: str,
                 transform: Optional[Callable] = None):
        if name not in _READERS:
            raise KeyError(
                f"unknown classification dataset {name}; have {sorted(_READERS)}"
            )
        self.samples = _READERS[name](Path(root))
        self.transform = transform

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        src, label = self.samples[idx]
        if isinstance(src, np.ndarray):
            img = Image.fromarray(src)
        else:
            img = Image.open(src).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, label
