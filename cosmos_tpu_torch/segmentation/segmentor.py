"""Open-vocabulary semantic segmentation with a CLIP/COSMOS encoder
(counterpart of ``cosmos_tpu/segmentation/segmentor.py``):

  - prompt-ensembled query features: the 80 OpenAI templates per query
    word, each prompt L2-normalised, the mean normalised again;
  - synonym lines: one line per class, comma-separated synonyms each a
    query; the class takes the max over its synonyms' probabilities;
  - ``_forward_feature``: the vision tower's patch tokens (the last block
    under SCLIP's CSA with ``use_csa``) @ ``visual.proj``, normalised,
    @ the query features, as a [B, gh, gw, Q] grid;
  - sliding windows of 224² at stride 112, each window's logits resized to
    the window and averaged where windows overlap;
  - the logits resized to the label's shape, optional PAMR, then
    ``logit_scale``, softmax over queries, synonym max-merge, ``area_thd``
    pruning and ``prob_thd`` → background.

Everything from the normalised image to the label map runs on the model's
device; only the uint8 image comes in and the int32 labels go out.  Windows
go to the vision tower in chunks of ``window_chunk`` (8), the last one as it
is: JAX pads it with zero windows to keep one compiled program, which the
port does not need.  Resizes are bilinear with antialiasing, the function
``jax.image.resize(..., "bilinear")`` computes in both directions (the
window logits grow 14 → 224; the final logits shrink to the label's shape
whenever the dataset's resize enlarged the image).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from .pamr import pamr

_ASSETS = Path(__file__).resolve().parent.parent / "assets"


def load_seg_classnames(benchmark: str) -> List[str]:
    """A benchmark's class lines (``assets/seg_classnames.json``)."""
    banks = json.loads((_ASSETS / "seg_classnames.json").read_text())
    return banks[benchmark]


def get_cls_idx(name_lines: Sequence[str]) -> Tuple[List[str], List[int]]:
    """Split synonym lines into (query words, class index of each query)."""
    words: List[str] = []
    idx: List[int] = []
    for i, line in enumerate(name_lines):
        names = [n.strip() for n in line.split(",")]
        words.extend(names)
        idx.extend([i] * len(names))
    return words, idx


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of an NHWC tensor, antialiased when it
    shrinks (``jax.image.resize``'s "bilinear")."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                        mode="bilinear", align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class CLIPSegmentor:
    """``model``: a ``CLIP`` of this package, on the device the segmentor
    runs on, in eval mode."""

    def __init__(
        self,
        model,
        tokenizer,
        name_lines: Sequence[str],
        *,
        logit_scale: float = 40.0,
        prob_thd: float = 0.0,
        area_thd: Optional[float] = None,
        slide_stride: int = 112,
        slide_crop: int = 224,
        pamr_steps: int = 0,
        pamr_stride: Sequence[int] = (8, 16),
        use_csa: bool = False,
        image_mean: Sequence[float] = (0.48145466, 0.4578275, 0.40821073),
        image_std: Sequence[float] = (0.26862954, 0.26130258, 0.27577711),
        window_chunk: int = 8,
    ):
        from ..training.zero_shot import (build_zero_shot_classifier,
                                          load_imagenet_metadata,
                                          supports_eot_truncation)
        from ..models.vit import VisionTransformer

        if not isinstance(model.visual, VisionTransformer):
            # the JAX segmentor fails on these towers too: CSA raises in
            # them, and they have no visual.proj
            raise NotImplementedError(
                "segmentation needs the CLIP ViT tower (CSA and the "
                "token projection); this model's vision tower is "
                f"{type(model.visual).__name__}")
        self.model = model
        self.device = next(model.parameters()).device
        self.query_words, query_idx = get_cls_idx(name_lines)
        self.query_idx = torch.tensor(query_idx, device=self.device)
        self.num_queries = len(self.query_words)
        self.num_classes = max(query_idx) + 1
        self.logit_scale = logit_scale
        self.prob_thd = prob_thd
        self.area_thd = area_thd
        self.slide_stride = slide_stride
        self.slide_crop = slide_crop
        self.pamr_steps = pamr_steps
        self.pamr_stride = tuple(pamr_stride)
        self.use_csa = use_csa
        self.window_chunk = window_chunk
        self.mean = torch.tensor(image_mean, dtype=torch.float32,
                                 device=self.device)
        self.std = torch.tensor(image_std, dtype=torch.float32,
                                device=self.device)

        def enc_text(tokens):
            with torch.inference_mode():
                return model.encode_text(
                    torch.as_tensor(tokens, device=self.device))["text_features"]

        # [Q, D] float32
        self.query_features = build_zero_shot_classifier(
            enc_text, tokenizer, self.query_words,
            load_imagenet_metadata()["templates"], num_classes_per_batch=8,
            eot_truncate=supports_eot_truncation(model)).T.contiguous()

    # --- the vision tower ------------------------------------------------

    @torch.inference_mode()
    def _forward_feature(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] normalised -> per-patch query logits [B, gh, gw, Q]."""
        visual = self.model.visual
        _, tokens = visual(images, csa=self.use_csa)
        feats = tokens.float() @ visual.proj.float()
        feats = feats / torch.linalg.norm(feats, dim=-1, keepdim=True)
        logits = feats @ self.query_features.T
        patch = visual.patch_size
        return logits.reshape(images.shape[0], images.shape[1] // patch,
                              images.shape[2] // patch, -1)

    # --- orchestration ---------------------------------------------------

    def _normalize(self, image_u8: np.ndarray) -> torch.Tensor:
        x = torch.tensor(np.asarray(image_u8), device=self.device
                         ).float() / 255.0
        return (x - self.mean) / self.std

    @torch.inference_mode()
    def forward_slide(self, image_u8: np.ndarray) -> torch.Tensor:
        """Sliding-window logits over one [H, W, 3] uint8 image ->
        [H, W, Q] float32 on the device."""
        crop, stride = self.slide_crop, self.slide_stride
        img = self._normalize(image_u8)
        h_img, w_img = img.shape[:2]
        pad_h, pad_w = max(crop - h_img, 0), max(crop - w_img, 0)
        if pad_h or pad_w:
            img = F.pad(img, (0, 0, 0, pad_w, 0, pad_h))
        H, W = img.shape[:2]
        h_grids = max(H - crop + stride - 1, 0) // stride + 1
        w_grids = max(W - crop + stride - 1, 0) // stride + 1
        coords = []
        for hi in range(h_grids):
            for wi in range(w_grids):
                y2 = min(hi * stride + crop, H)
                x2 = min(wi * stride + crop, W)
                coords.append((y2 - crop, x2 - crop))
        preds = img.new_zeros(H, W, self.num_queries)
        count = img.new_zeros(H, W, 1)
        for i0 in range(0, len(coords), self.window_chunk):
            chunk = coords[i0:i0 + self.window_chunk]
            windows = torch.stack([img[y1:y1 + crop, x1:x1 + crop]
                                   for y1, x1 in chunk])
            logits = resize_bilinear(self._forward_feature(windows),
                                     (crop, crop))
            for (y1, x1), lg in zip(chunk, logits):
                preds[y1:y1 + crop, x1:x1 + crop] += lg
                count[y1:y1 + crop, x1:x1 + crop] += 1.0
        return (preds / count)[:h_img, :w_img]

    @torch.inference_mode()
    def seg_logits(self, image_u8: np.ndarray,
                   ori_shape: Optional[Tuple[int, int]] = None
                   ) -> torch.Tensor:
        """[H_ori, W_ori, Q] float32 logits on the device: the windows' (or
        one whole-image pass's) logits at the label's shape, refined by PAMR
        with ``pamr_steps``."""
        if self.slide_crop > 0:
            logits = self.forward_slide(image_u8)
        else:
            logits = resize_bilinear(
                self._forward_feature(self._normalize(image_u8)[None]),
                image_u8.shape[:2])[0]
        ori = tuple(ori_shape or image_u8.shape[:2])
        logits = resize_bilinear(logits[None], ori)
        if self.pamr_steps > 0:
            img_r = resize_bilinear(self._normalize(image_u8)[None], ori)
            logits = pamr(img_r, logits, num_iter=self.pamr_steps,
                          dilations=self.pamr_stride)
        return logits[0]

    def predict(self, image_u8: np.ndarray,
                ori_shape: Optional[Tuple[int, int]] = None) -> np.ndarray:
        """Full prediction for one image -> [H_ori, W_ori] int32 labels."""
        return self.postprocess(self.seg_logits(image_u8, ori_shape))

    @torch.inference_mode()
    def postprocess(self, seg_logits: Union[torch.Tensor, np.ndarray]
                    ) -> np.ndarray:
        """[H, W, Q] logits -> [H, W] int32 labels on the host."""
        x = torch.as_tensor(seg_logits, device=self.device).float()
        probs = torch.softmax(x * self.logit_scale, dim=-1)
        if self.num_classes != self.num_queries:
            # synonym max-merge
            idx = self.query_idx.expand_as(probs)
            probs = probs.new_zeros(probs.shape[:2] + (self.num_classes,)
                                    ).scatter_reduce_(-1, idx, probs, "amax")
        if self.area_thd is not None:
            # prune non-background classes that cover a small share of the
            # non-background pixels
            area = torch.bincount(probs.argmax(-1).flatten(),
                                  minlength=self.num_classes)[1:]
            keep = (area > self.area_thd * area.sum()).to(probs.dtype)
            probs[..., 1:] *= keep
        pred = probs.argmax(dim=-1)
        pred[probs.amax(dim=-1) < self.prob_thd] = 0
        return pred.to(torch.int32).cpu().numpy()
