"""Map-style datasets: COCO and Flickr retrieval pairs, the ImageNet class
folders and the synthetic train source (counterpart of
``cosmos_tpu/data/datasets.py``).

  - read_coco_pairs: ``annotations/captions_{split}2017.json`` -> a list of
    {image_id, image path, caption, caption_id};
  - read_flickr_pairs: ``flickr30k_{split}.json`` entries with an image path
    and a caption list;
  - map_img_cap: the image <-> caption id maps R@k needs;
  - ImageFolderDataset: torchvision ImageFolder's order (ImageNet val, and
    ImageNetV2's numeric class dirs);
  - CsvDataset: a CSV of (image path, caption) rows;
  - SyntheticDataset: an in-memory random image/caption source shaped like
    the recaptioned webdataset stream.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np


def read_coco_pairs(root_dir: str, split: str = "val") -> List[Dict]:
    split = "train" if split == "train" else "val"
    captions_file = os.path.join(
        root_dir, "annotations", f"captions_{split}2017.json"
    )
    images_dir = os.path.join(root_dir, "images", f"{split}2017")
    with open(captions_file) as f:
        coco = json.load(f)
    id_to_path = {
        im["id"]: os.path.join(images_dir, im["file_name"]) for im in coco["images"]
    }
    data = []
    cap_id = 0
    for ann in coco["annotations"]:
        if ann["image_id"] in id_to_path:
            data.append(
                {
                    "image_id": ann["image_id"],
                    "image": id_to_path[ann["image_id"]],
                    "caption": ann["caption"],
                    "caption_id": cap_id,
                }
            )
        cap_id += 1
    return data


def read_flickr_pairs(root_dir: str, split: str = "test") -> List[Dict]:
    base_dir = os.path.dirname(root_dir)
    captions_file = os.path.join(root_dir, f"flickr30k_{split}.json")
    with open(captions_file) as f:
        entries = json.load(f)
    data = []
    img_id = cap_id = 0
    for ann in entries:
        image_path = os.path.join(base_dir, ann["image"])
        captions = ann["caption"]
        if not isinstance(captions, list):
            captions = [captions]
        for caption in captions:
            data.append(
                {
                    "image": image_path,
                    "caption": caption,
                    "image_id": img_id,
                    "caption_id": cap_id,
                }
            )
            cap_id += 1
        img_id += 1
    return data


def map_img_cap(data_list: List[Dict]):
    img2txt: Dict[int, List[int]] = {}
    txt2img: Dict[int, List[int]] = {}
    for e in data_list:
        img2txt.setdefault(e["image_id"], []).append(e["caption_id"])
        txt2img.setdefault(e["caption_id"], []).append(e["image_id"])
    return img2txt, txt2img


@dataclass
class RetrievalData:
    """Pre-tokenized retrieval eval data (text list + unique image list)."""

    captions: np.ndarray          # [n_txt, 77] int32
    caption_ids: np.ndarray       # [n_txt]
    image_paths: List[str]        # unique, ordered
    image_ids: np.ndarray         # [n_img]
    img2txt: Dict[int, List[int]]
    txt2img: Dict[int, List[int]]

    @classmethod
    def load(cls, kind: str, root_dir: str, tokenizer, split: Optional[str] = None):
        if kind == "coco":
            data = read_coco_pairs(root_dir, split or "val")
        elif kind == "flickr":
            data = read_flickr_pairs(root_dir, split or "test")
        else:
            raise ValueError(kind)
        img2txt, txt2img = map_img_cap(data)
        captions = tokenizer([d["caption"] for d in data])
        caption_ids = np.asarray([d["caption_id"] for d in data])
        seen = {}
        for d in data:
            if d["image_id"] not in seen:
                seen[d["image_id"]] = d["image"]
        image_ids = np.asarray(list(seen.keys()))
        image_paths = list(seen.values())
        return cls(captions, caption_ids, image_paths, image_ids, img2txt, txt2img)


class ImageFolderDataset:
    """(transformed image, label) over class dirs in torchvision
    ImageFolder's order: dirs sorted by name, or by number when every dir
    name is an integer (ImageNetV2's ``0..999``, label = int(dirname));
    files sorted in each.  ``max_per_class`` keeps a seeded sample of each
    class's files."""

    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        max_per_class: Optional[int] = None,
        seed: int = 42,
    ):
        self.root = root
        self.transform = transform
        classes = [d.name for d in os.scandir(root) if d.is_dir()]
        if classes and all(c.isdigit() for c in classes):
            classes.sort(key=int)
        else:
            classes.sort()
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples: List[Tuple[str, int]] = []
        for c in classes:
            files = sorted(os.listdir(os.path.join(root, c)))
            if max_per_class is not None and len(files) > max_per_class:
                files = random.Random(seed).sample(files, max_per_class)
            self.samples.extend(
                (os.path.join(root, c, f), self.class_to_idx[c]) for f in files
            )

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        path, label = self.samples[idx]
        img = Image.open(path).convert("RGB")
        if self.transform is not None:
            img = self.transform(img)
        return img, label


class CsvDataset:
    """A CSV of (image path, caption) rows, read with ``csv.DictReader``
    under ``sep``; ``__getitem__`` gives (transformed image, tokens)."""

    def __init__(
        self,
        input_filename: str,
        transform,
        img_key: str = "filepath",
        caption_key: str = "title",
        sep: str = "\t",
        tokenizer=None,
    ):
        import csv

        self.images: List[str] = []
        self.captions: List[str] = []
        with open(input_filename, newline="") as f:
            for row in csv.DictReader(f, delimiter=sep):
                self.images.append(row[img_key])
                self.captions.append(row[caption_key])
        self.transform = transform
        self.tokenizer = tokenizer

    def __len__(self):
        return len(self.images)

    def __getitem__(self, idx):
        from PIL import Image

        img = Image.open(self.images[idx]).convert("RGB")
        img = self.transform(img)
        tokens = self.tokenizer([self.captions[idx]])[0]
        return img, tokens


class SyntheticDataset:
    """In-memory random image/caption source for smoke tests.

    Yields samples shaped like the recaptioned webdataset stream, so the
    whole multicrop+textcrop pipeline (and the train step) can run without
    any data on disk.
    """

    WORDS = (
        "a photo of cat dog tree house car boat sky cloud river mountain "
        "red green tiny huge wooden plastic shiny old"
    ).split()

    def __init__(self, num_samples: int = 1024, image_size: int = 256, seed: int = 0):
        self.num_samples = num_samples
        self.image_size = image_size
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx):
        from PIL import Image

        rng = np.random.default_rng(self.seed + idx)
        arr = rng.integers(
            0, 255, size=(self.image_size, self.image_size, 3), dtype=np.uint8
        )
        img = Image.fromarray(arr)
        r = random.Random(self.seed + idx)
        caps = [
            " ".join(r.choices(self.WORDS, k=r.randint(3, 10))) for _ in range(3)
        ]
        meta = {
            "raw_caption": [caps[0]],
            "shortIB_captions": [caps[1]],
            "shortSV_captions": [],
            "shortLLA_captions": [],
            "longIB_captions": [caps[2]],
            "longSV_captions": [],
            "longLLA_captions": [],
        }
        return img, meta
