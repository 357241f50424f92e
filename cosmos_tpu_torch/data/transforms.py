"""Image preprocessing: the multi-crop train augmentation and the eval
transform (counterpart of ``cosmos_tpu/data/transforms.py``).

  - ``MulticropAugmentation``: 2 global crops at the native resolution with
    scale (crop_scale, 1.0) and N local 96px crops with scale (0.05,
    crop_scale); all get flip + colour jitter (p=.8) + grayscale (p=.2);
    global crop 1 always Gaussian-blurs, global crop 2 blurs with p=.1 and
    solarizes with p=.2, locals blur with p=.5 (the DINO recipe).
  - ``EvalTransform``: bicubic resize of the shortest side + centre crop +
    normalise (or the 'longest' / 'squash' modes).
  - ``TrainTransform``: the single-crop train transform of runs without
    --use-imagecrop-aug.

PIL + numpy on the host, with the JAX package's random calls in the same
order, so the same ``random.Random`` gives the same arrays.  Outputs are HWC
arrays: uint8 for the train transforms when ``as_uint8`` (normalised on the
device in the train step), float32 otherwise.
"""

from __future__ import annotations

import math
import random as _random
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageFilter, ImageOps

from .constants import OPENAI_DATASET_MEAN, OPENAI_DATASET_STD

BICUBIC = Image.BICUBIC
# interpolation names; 'random' is a train-time augmentation in the
# reference and maps to bicubic for inference
_INTERPOLATIONS = {
    "bicubic": Image.BICUBIC,
    "bilinear": Image.BILINEAR,
    "nearest": Image.NEAREST,
    "random": Image.BICUBIC,
}


def _to_rgb(img: Image.Image) -> Image.Image:
    return img.convert("RGB")


def random_resized_crop(
    img: Image.Image,
    size: int,
    scale: Tuple[float, float],
    rng: _random.Random,
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0),
) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries then center fallback)."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = math.exp(rng.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            i = rng.randint(0, h - ch)
            j = rng.randint(0, w - cw)
            return img.resize((size, size), BICUBIC, box=(j, i, j + cw, i + ch))
    # fallback: center crop of the clamped aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        ch, cw = h, int(round(h * ratio[1]))
    else:
        cw, ch = w, h
    j, i = (w - cw) // 2, (h - ch) // 2
    return img.resize((size, size), BICUBIC, box=(j, i, j + cw, i + ch))


def color_jitter(
    img: Image.Image,
    rng: _random.Random,
    brightness: float = 0.4,
    contrast: float = 0.4,
    saturation: float = 0.2,
    hue: float = 0.1,
) -> Image.Image:
    from PIL import ImageEnhance

    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        hshift = rng.uniform(-hue, hue)

        def _hue(im: Image.Image) -> Image.Image:
            hsv = np.array(im.convert("HSV"), dtype=np.uint8)
            hsv[..., 0] = (hsv[..., 0].astype(np.int16)
                           + int(hshift * 255)) % 256
            return Image.fromarray(hsv, "HSV").convert("RGB")

        ops.append(_hue)
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def gaussian_blur(img: Image.Image, rng: _random.Random) -> Image.Image:
    return img.filter(
        ImageFilter.GaussianBlur(radius=rng.uniform(0.1, 2.0))
    )


def solarize(img: Image.Image) -> Image.Image:
    return ImageOps.solarize(img, threshold=128)


def normalize_to_array(
    img: Image.Image, mean: Sequence[float], std: Sequence[float]
) -> np.ndarray:
    x = np.asarray(img, dtype=np.float32) / 255.0
    return (x - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)


def _finalize(img: Image.Image, mean, std, as_uint8: bool) -> np.ndarray:
    """uint8 HWC passthrough (device-side normalization) or normalized f32."""
    if as_uint8:
        return np.asarray(img, dtype=np.uint8)
    return normalize_to_array(img, mean, std)


@dataclass
class MulticropAugmentation:
    """DINO-style 2-global + N-local crop augmentation."""

    mean: Sequence[float] = OPENAI_DATASET_MEAN
    std: Sequence[float] = OPENAI_DATASET_STD
    image_size: int = 224
    local_crops_number: int = 6
    global_crops_number: int = 2
    crop_scale: float = 0.14
    local_size: int = 96
    as_uint8: bool = False  # skip normalization; done on-device in the step

    def __post_init__(self):
        # fail at CONSTRUCTION: the per-call assert used to fire inside
        # the loader worker, whose per-sample except swallowed it into an
        # infinite produce-nothing warn loop at step 0 (the reference
        # asserts the same recipe invariant)
        if self.global_crops_number != 2:
            raise ValueError(
                "the multicrop recipe is fixed at 2 global crops "
                f"(got --global-crops-number {self.global_crops_number})"
            )

    def _common(self, img: Image.Image, rng: _random.Random) -> Image.Image:
        if rng.random() < 0.5:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if rng.random() < 0.8:
            img = color_jitter(img, rng)
        if rng.random() < 0.2:
            img = img.convert("L").convert("RGB")
        return img

    def __call__(
        self, img: Image.Image, rng: Optional[_random.Random] = None
    ) -> List[np.ndarray]:
        rng = rng or _random
        img = _to_rgb(img)
        crops: List[np.ndarray] = []

        g1 = random_resized_crop(
            img, self.image_size, (self.crop_scale, 1.0), rng
        )
        g1 = self._common(g1, rng)
        g1 = gaussian_blur(g1, rng)  # p=1.0 for the first global crop
        crops.append(_finalize(g1, self.mean, self.std, self.as_uint8))

        g2 = random_resized_crop(
            img, self.image_size, (self.crop_scale, 1.0), rng
        )
        g2 = self._common(g2, rng)
        if rng.random() < 0.1:
            g2 = gaussian_blur(g2, rng)
        if rng.random() < 0.2:
            g2 = solarize(g2)
        crops.append(_finalize(g2, self.mean, self.std, self.as_uint8))

        for _ in range(self.local_crops_number):
            lc = random_resized_crop(
                img, self.local_size, (0.05, self.crop_scale), rng
            )
            lc = self._common(lc, rng)
            if rng.random() < 0.5:
                lc = gaussian_blur(lc, rng)
            crops.append(_finalize(lc, self.mean, self.std, self.as_uint8))
        return crops


def shortest_resize_crop_geometry(w: int, h: int, size: int):
    """(new_w, new_h, crop_left, crop_top) — torchvision-exact.

    Resize(short_side) TRUNCATES the long side (``int(size*long/short)``,
    torchvision F.resize) and CenterCrop ROUNDS the offset
    (``int(round((n - size)/2.0))``, F.center_crop).  round()ing the
    resize / flooring the crop shifted content by 1px on most
    non-integral aspect ratios vs the reference eval pipeline."""
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    return nw, nh, int(round((nw - size) / 2.0)), int(round((nh - size) / 2.0))


@dataclass
class EvalTransform:
    """Eval preprocessing, by resize mode:
    'shortest' — bicubic shortest-side resize + center crop (default);
    'longest'  — longest-side resize + center pad to square;
    'squash'   — direct resize to (size, size)."""

    image_size: int = 224
    mean: Sequence[float] = OPENAI_DATASET_MEAN
    std: Sequence[float] = OPENAI_DATASET_STD
    resize_mode: str = "shortest"
    interpolation: str = "bicubic"   # MobileCLIP checkpoints use bilinear

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = _to_rgb(img)
        w, h = img.size
        size = self.image_size
        interp = _INTERPOLATIONS[self.interpolation]
        if self.resize_mode == "squash":
            img = img.resize((size, size), interp)
        elif self.resize_mode == "longest":
            s = size / max(w, h)
            nw, nh = round(w * s), round(h * s)
            img = img.resize((nw, nh), interp)
            canvas = Image.new("RGB", (size, size))
            canvas.paste(img, ((size - nw) // 2, (size - nh) // 2))
            img = canvas
        else:  # shortest
            nw, nh, left, top = shortest_resize_crop_geometry(w, h, size)
            img = img.resize((nw, nh), interp)
            img = img.crop((left, top, left + size, top + size))
        return normalize_to_array(img, self.mean, self.std)


@dataclass
class TrainTransform:
    """Plain single-crop train transform (RandomResizedCrop 0.9-1.0) for
    non-multicrop runs, with the --aug-cfg probability knobs
    (color_jitter_prob / gray_scale_prob)."""

    image_size: int = 224
    mean: Sequence[float] = OPENAI_DATASET_MEAN
    std: Sequence[float] = OPENAI_DATASET_STD
    scale: Tuple[float, float] = (0.9, 1.0)
    ratio: Tuple[float, float] = (3.0 / 4.0, 4.0 / 3.0)
    color_jitter: Optional[Sequence[float]] = None   # (b, c, s[, h])
    color_jitter_prob: Optional[float] = None
    gray_scale_prob: Optional[float] = None
    as_uint8: bool = False

    def __call__(
        self, img: Image.Image, rng: Optional[_random.Random] = None
    ) -> np.ndarray:
        rng = rng or _random
        img = random_resized_crop(
            _to_rgb(img), self.image_size, self.scale, rng, ratio=self.ratio
        )
        if self.color_jitter_prob and rng.random() < self.color_jitter_prob:
            cj = self.color_jitter or (0.4, 0.4, 0.2, 0.1)
            if not isinstance(cj, (tuple, list)):
                cj = (cj, cj, cj, 0.0)
            cj = tuple(cj) + (0.0,) * (4 - len(cj))
            img = color_jitter(img, rng, *cj)
        if self.gray_scale_prob and rng.random() < self.gray_scale_prob:
            img = img.convert("L").convert("RGB")
        return _finalize(img, self.mean, self.std, self.as_uint8)


def _parse_pair(v, default):
    if v is None:
        return default
    if isinstance(v, str):
        v = [float(x) for x in v.replace(",", " ").split()]
    if isinstance(v, (int, float)):
        return (float(v), float(v))
    return tuple(float(x) for x in v)


def eval_transform_from_args(args, image_size: int) -> "EvalTransform":
    """EvalTransform honoring the --image-mean / --image-std /
    --image-interpolation / --image-resize-mode overrides: the one place
    the trainer and the evals map those flags to a transform."""
    return EvalTransform(
        image_size=image_size,
        mean=tuple(getattr(args, "image_mean", None) or OPENAI_DATASET_MEAN),
        std=tuple(getattr(args, "image_std", None) or OPENAI_DATASET_STD),
        interpolation=getattr(args, "image_interpolation", None) or "bicubic",
        resize_mode=getattr(args, "image_resize_mode", None) or "shortest",
    )


def image_transform_train(image_size: int, mean=None, std=None, aug_cfg=None,
                          as_uint8: bool = False):
    aug_cfg = dict(aug_cfg or {})
    cj = aug_cfg.get("color_jitter")
    if isinstance(cj, str):
        cj = [float(x) for x in cj.replace(",", " ").split()]
    return TrainTransform(
        image_size=image_size,
        mean=mean or OPENAI_DATASET_MEAN,
        std=std or OPENAI_DATASET_STD,
        scale=_parse_pair(aug_cfg.get("scale"), (0.9, 1.0)),
        ratio=_parse_pair(aug_cfg.get("ratio"), (3.0 / 4.0, 4.0 / 3.0)),
        color_jitter=cj,
        color_jitter_prob=(
            float(aug_cfg["color_jitter_prob"])
            if aug_cfg.get("color_jitter_prob") is not None else None
        ),
        gray_scale_prob=(
            float(aug_cfg["gray_scale_prob"])
            if aug_cfg.get("gray_scale_prob") is not None else None
        ),
        as_uint8=as_uint8,
    )
