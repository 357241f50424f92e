"""Contrastive and self-distillation losses (counterpart of
``cosmos_tpu/losses/contrastive.py``, all but ``CoCaLoss``).

Features arrive views-leading, ``[V, B, D]`` (a ``[B, D]`` input is one
view).  ``ClipLoss`` is InfoNCE averaged over every (image view, text view)
pair, from one batched ``[Vi, Vt, B, B]`` contraction with a float32 result;
``COSMOSLoss`` adds the 4-term cross-modal distillation against the detached
teacher features; ``DistillClipLoss`` adds a soft cross-entropy against a
frozen model's logits; ``SigLipLoss`` is the pairwise sigmoid loss of one
``[B, B]`` block with ``logit_bias``.  The last two read the first view
only, as the JAX package's do.

Single process only: the all-gather with gradient, the rank-offset labels
of ``local_loss`` and SigLIP's ring of negatives come with data
parallelism.  ``local_loss`` is accepted because with one process it
changes nothing; a process group of more than one rank raises.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F


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
            "all-gather across ranks and SigLIP's ring are not ported yet "
            "(ROADMAP queue 1, item 6)")


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


def _pair_logits(img: torch.Tensor, txt: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """``scale * img @ txt.T`` as float32 from [B, D] features."""
    return scale.float() * torch.matmul(img.float(), txt.float().T)


@dataclasses.dataclass
class DistillClipLoss(ClipLoss):
    """The CLIP loss of the first views plus a soft cross-entropy against
    the logits of a frozen model's features, which take no gradient."""

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 dist_image_features: torch.Tensor,
                 dist_text_features: torch.Tensor,
                 dist_logit_scale: torch.Tensor, output_dict: bool = False):
        _single_process()
        img = _as_views(image_features)[0]
        txt = _as_views(text_features)[0]
        d_img = _as_views(dist_image_features)[0].detach()
        d_txt = _as_views(dist_text_features)[0].detach()
        dist_logit_scale = dist_logit_scale.detach()
        li, lt = (_pair_logits(img, txt, logit_scale),
                  _pair_logits(txt, img, logit_scale))
        dli, dlt = (_pair_logits(d_img, d_txt, dist_logit_scale),
                    _pair_logits(d_txt, d_img, dist_logit_scale))
        labels = torch.arange(li.shape[0], device=li.device)
        contrastive = 0.5 * (_cross_entropy(li, labels)
                             + _cross_entropy(lt, labels))
        distill = 0.5 * (_soft_cross_entropy(dli, li)
                         + _soft_cross_entropy(dlt, lt))
        if output_dict:
            return {"contrastive_loss": contrastive, "distill_loss": distill}
        return contrastive, distill


def _soft_cross_entropy(teacher_logits: torch.Tensor,
                        student_logits: torch.Tensor) -> torch.Tensor:
    t = torch.softmax(teacher_logits, dim=1)
    s = torch.log_softmax(student_logits, dim=1)
    return -(t * s).sum(dim=1).mean(dim=0)


@dataclasses.dataclass
class SigLipLoss:
    """Pairwise sigmoid loss over one [B, B] block of the first views:
    ``-sum(log sigmoid(label * (scale * img @ txt.T + bias))) / B`` with
    label +1 on the diagonal and -1 elsewhere."""

    bidir: bool = True

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 logit_bias: Optional[torch.Tensor] = None,
                 output_dict: bool = False):
        _single_process()
        img = _as_views(image_features)[0]
        txt = _as_views(text_features)[0]
        logits = _pair_logits(img, txt, logit_scale)
        if logit_bias is not None:
            logits = logits + logit_bias.float()
        b = img.shape[0]
        labels = 2.0 * torch.eye(b, txt.shape[0], device=logits.device) - 1.0
        loss = -F.logsigmoid(labels * logits).sum() / b
        return {"contrastive_loss": loss} if output_dict else loss
