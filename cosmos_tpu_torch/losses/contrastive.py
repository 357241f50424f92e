"""Contrastive and self-distillation losses (counterpart of
``cosmos_tpu/losses/contrastive.py:36-216``).

Features arrive views-leading, ``[V, B, D]`` (a ``[B, D]`` input is one
view).  ``ClipLoss`` is InfoNCE averaged over every (image view, text view)
pair, from one batched ``[Vi, Vt, B, B]`` contraction with a float32 result;
``COSMOSLoss`` adds the 4-term cross-modal distillation against the detached
teacher features.

Single process only: the all-gather with gradient and the rank-offset
labels of ``local_loss`` come with data parallelism.  ``local_loss`` is
accepted because with one process it changes nothing; a process group of
more than one rank raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch


def _as_views(x: torch.Tensor) -> torch.Tensor:
    """[B, D] -> [1, B, D]; [V, B, D] stays."""
    return x[None] if x.dim() == 2 else x


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean integer-label cross entropy over the leading dims; the
    log-softmax runs in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def _single_process() -> None:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "the contrastive losses are single-process: the feature "
            "all-gather across ranks is not ported yet")


@dataclasses.dataclass
class ClipLoss:
    local_loss: bool = False

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 output_dict: bool = False
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        _single_process()
        img = _as_views(image_features)
        txt = _as_views(text_features)
        # the features enter the product as float32, so the logits are the
        # float32 result of the compute-dtype features (the JAX package's
        # preferred_element_type=float32), never a rounded product cast up
        logits_per_image = logit_scale.float() * torch.einsum(
            "ibd,jkd->ijbk", img.float(), txt.float())   # [Vi, Vt, B, B]
        # one process: the text logits are the transpose of the image ones
        logits_per_text = logits_per_image.transpose(-1, -2)
        labels = torch.arange(img.shape[1], device=img.device)
        total = 0.5 * (
            _cross_entropy(logits_per_image,
                           labels.expand(logits_per_image.shape[:-1]))
            + _cross_entropy(logits_per_text,
                             labels.expand(logits_per_text.shape[:-1])))
        return {"contrastive_loss": total} if output_dict else total


@dataclasses.dataclass
class COSMOSLoss:
    local_loss: bool = False

    def __post_init__(self):
        self.clip_loss = ClipLoss(local_loss=self.local_loss)

    def __call__(
        self,
        s_image_features: torch.Tensor,       # [Vi, B, D] student, all crops
        s_text_features: torch.Tensor,        # [Vt, B, D] student, all captions
        logit_scale: torch.Tensor,
        t_image_features: torch.Tensor,       # [2, B, D] teacher
        t_text_features: torch.Tensor,        # [2, B, D] teacher
        distill_logit_scale: Optional[torch.Tensor] = None,
        s_img_crossmodal_features: Optional[torch.Tensor] = None,  # [Vi, B, D]
        s_txt_crossmodal_features: Optional[torch.Tensor] = None,  # [Vt, B, D]
        output_dict: bool = False,
    ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        s_img = _as_views(s_image_features)
        s_txt = _as_views(s_text_features)
        t_img = _as_views(t_image_features).detach()
        t_txt = _as_views(t_text_features).detach()
        s_img_cm = _as_views(s_img_crossmodal_features)
        s_txt_cm = _as_views(s_txt_crossmodal_features)
        if t_img.shape[0] != 2 or t_txt.shape[0] != 2:
            raise ValueError(
                "COSMOSLoss needs the teacher's 2 global image and caption "
                f"views, got {t_img.shape[0]} and {t_txt.shape[0]}")
        dscale = (distill_logit_scale if distill_logit_scale is not None
                  else logit_scale)
        distill = (self.clip_loss(s_img_cm, t_img, dscale)
                   + self.clip_loss(s_img_cm, t_txt, dscale)
                   + self.clip_loss(s_txt_cm, t_img, dscale)
                   + self.clip_loss(s_txt_cm, t_txt, dscale)) / 4.0
        # CLIP loss over the 2 global image crops x all caption views
        clip = self.clip_loss(s_img[:2], s_txt, logit_scale)
        if output_dict:
            return {"distill_loss": distill, "clip_loss": clip}
        return distill + clip
