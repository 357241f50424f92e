"""Contrastive and self-distillation losses (counterpart of
``cosmos_tpu/losses/contrastive.py``).

Features arrive views-leading, ``[V, B, D]`` (a ``[B, D]`` input is one
view).  ``ClipLoss`` is InfoNCE averaged over every (image view, text view)
pair, from one batched ``[Vi, Vt, B, B]`` contraction with a float32 result;
``COSMOSLoss`` adds the 4-term cross-modal distillation against the detached
teacher features; ``DistillClipLoss`` adds a soft cross-entropy against a
frozen model's logits; ``CoCaLoss`` weighs ``ClipLoss`` and the
captioner's cross entropy over the labels that are not padding;
``SigLipLoss`` is the pairwise sigmoid loss of one
``[B, B]`` block with ``logit_bias``.  The last two read the first view
only, as the JAX package's do.

Under a ``torch.distributed`` process group each rank holds its block of
the global batch, as a device does under JAX's ``shard_map``: the CLIP
losses all-gather the features along the batch axis (with the gradient, or
without it and the local block spliced back), ``local_loss`` keeps this
rank's query rows against the gathered keys with rank-offset labels, and
SigLIP passes the text features round the ring of ranks, each hop adding a
block of negatives.  The loss of each rank is the one JAX's device
computes; the step averages the gradients across ranks.  Without a process
group nothing is gathered.

``group`` names the process group of the data axis (the default group
when None), as JAX's ``axis_name`` names the mesh axis.  On a multislice
mesh ``slice_group`` is the group across slices, and ``group`` the ranks
within this rank's slice: ``gather_scope='global'`` gathers within the
slice, then the slice-major concatenation of the slices' blocks across
them (the flat gather's order and loss); ``'slice'`` stops within the
slice, so the negatives stay slice-local (the step's gradient mean still
spans every rank).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel.distributed import is_initialized as _distributed
from ..parallel.distributed import world_size


def _as_views(x: torch.Tensor) -> torch.Tensor:
    """[B, D] -> [1, B, D]; [V, B, D] stays."""
    return x[None] if x.dim() == 2 else x


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean integer-label cross entropy over the leading dims; the
    log-softmax runs in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels[..., None])[..., 0].mean()


def _all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``[V, B, D]`` block of ``group``, concatenated in rank
    order along the batch axis: ``[V, N*B, D]``."""
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


class _GatherWithGrad(torch.autograd.Function):
    """``_all_gather`` whose backward is JAX's transpose of ``all_gather``:
    the cotangents summed across the group's ranks, this rank's block
    kept."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group=None) -> torch.Tensor:
        ctx.group = group
        ctx.block = (dist.get_rank(group) * x.shape[1], x.shape[1])
        return _all_gather(x, group)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        summed = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(summed, group=ctx.group)
        # in the cotangent's own layout, so that the backward below takes
        # the kernels it takes without a process group
        summed = torch.empty_like(grad).copy_(summed)
        start, b = ctx.block
        return summed[:, start:start + b], None


def _exchange(tensors: Sequence[torch.Tensor], send_to: Sequence[int],
              recv_from: Sequence[int]) -> List[torch.Tensor]:
    """Send ``tensors[k]`` to rank ``send_to[k]`` and receive the k-th
    result from rank ``recv_from[k]``, all in one batch of point-to-point
    operations (tag k)."""
    outs = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t.contiguous(), to, tag=k)
           for k, (t, to) in enumerate(zip(tensors, send_to))]
    ops += [dist.P2POp(dist.irecv, o, frm, tag=k)
            for k, (o, frm) in enumerate(zip(outs, recv_from))]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _NeighbourExchange(torch.autograd.Function):
    """``_exchange`` whose backward sends each result's gradient back to
    the rank it came from (the reference's ``NeighbourExchange`` and
    ``NeighbourExchangeBidir``; JAX's transpose of ``ppermute``)."""

    @staticmethod
    def forward(ctx, send_to: Tuple[int, ...], recv_from: Tuple[int, ...],
                *tensors: torch.Tensor):
        ctx.send_to, ctx.recv_from = send_to, recv_from
        return tuple(_exchange(tensors, send_to, recv_from))

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        # (unused results come as zeros: grads are materialised)
        back = _exchange(grads, ctx.recv_from, ctx.send_to)
        return (None, None, *back)


@dataclasses.dataclass
class ClipLoss:
    local_loss: bool = False
    # the exact gradient through the gather; False is the reference's
    # default, the no-grad gather with this rank's block spliced back
    gather_with_grad: bool = True
    # the data axis's process group (None: the default group) and, on a
    # multislice mesh, the group across slices (see the module's text)
    group: Any = None
    slice_group: Any = None
    gather_scope: str = "global"

    def __post_init__(self):
        # JAX's checks, with its messages
        if self.gather_scope not in ("global", "slice"):
            raise ValueError(
                f"gather_scope must be 'global' or 'slice', "
                f"got {self.gather_scope!r}")
        if self.slice_group is not None and not self.gather_with_grad:
            raise ValueError(
                "multislice (slice_axis) requires gather_with_grad=True")

    @property
    def _across_slices(self) -> bool:
        return self.slice_group is not None and self.gather_scope == "global"

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[V, B, D] -> [V, N*B, D] across the group's ranks (and, in the
        global scope of a multislice mesh, across slices)."""
        if self.gather_with_grad:
            gathered = _GatherWithGrad.apply(x, self.group)
            if self._across_slices:
                gathered = _GatherWithGrad.apply(gathered, self.slice_group)
            return gathered
        with torch.no_grad():
            gathered = _all_gather(x, self.group)
        if not self.local_loss:
            # this rank's block keeps its gradient
            start, b = dist.get_rank(self.group) * x.shape[1], x.shape[1]
            gathered = torch.cat([gathered[:, :start], x,
                                  gathered[:, start + b:]], dim=1)
        return gathered

    def _labels(self, n: int, device) -> torch.Tensor:
        """The positives of ``n`` query rows: offset by this rank's block
        (slice-major across slices) when the queries are local."""
        labels = torch.arange(n, device=device)
        if self.local_loss and _distributed():
            r = dist.get_rank(self.group)
            if self._across_slices:
                r += dist.get_world_size(self.group) * dist.get_rank(
                    self.slice_group)
            labels = labels + n * r
        return labels

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 output_dict: bool = False
                 ) -> Union[torch.Tensor, Dict[str, torch.Tensor]]:
        img = _as_views(image_features)
        txt = _as_views(text_features)
        local = self.local_loss and _distributed()
        if _distributed():
            all_img, all_txt = self._gather(img), self._gather(txt)
        else:
            all_img, all_txt = img, txt
        q_img = img if local else all_img
        # the features enter the product as float32, so the logits are the
        # float32 result of the compute-dtype features (the JAX package's
        # preferred_element_type=float32), never a rounded product cast up
        scale = logit_scale.float()
        logits_per_image = scale * torch.einsum(
            "ibd,jkd->ijbk", q_img.float(), all_txt.float())  # [Vi, Vt, Bq, Bk]
        if local:
            logits_per_text = scale * torch.einsum(
                "jbd,ikd->ijbk", txt.float(), all_img.float())
        else:
            # the queries are the keys: the text logits are the transpose
            logits_per_text = logits_per_image.transpose(-1, -2)
        labels = self._labels(q_img.shape[1], img.device)
        total = 0.5 * (
            _cross_entropy(logits_per_image,
                           labels.expand(logits_per_image.shape[:-1]))
            + _cross_entropy(logits_per_text,
                             labels.expand(logits_per_text.shape[:-1])))
        return {"contrastive_loss": total} if output_dict else total


@dataclasses.dataclass
class COSMOSLoss:
    local_loss: bool = False
    gather_with_grad: bool = True
    group: Any = None
    slice_group: Any = None
    gather_scope: str = "global"

    def __post_init__(self):
        self.clip_loss = ClipLoss(local_loss=self.local_loss,
                                  gather_with_grad=self.gather_with_grad,
                                  group=self.group,
                                  slice_group=self.slice_group,
                                  gather_scope=self.gather_scope)

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
class CoCaLoss:
    """CLIP's loss on the latents and the captioner's cross-entropy.

    Under a process group the caption CE is this rank's mean over its
    unpadded tokens, and the step's mean over the ranks averages those
    (JAX's data-parallel step).  ``global_tokens`` (JAX's GSPMD step, whose
    loss is the global batch's): the mean over the global batch's unpadded
    tokens, their count summed over ``group``; each rank returns its sum
    over that count times the group's size, so the mean over the ranks is
    the global mean."""

    caption_loss_weight: float = 2.0
    clip_loss_weight: float = 1.0
    pad_id: int = 0
    local_loss: bool = False
    gather_with_grad: bool = True
    group: Any = None
    slice_group: Any = None
    gather_scope: str = "global"
    global_tokens: bool = False

    def __post_init__(self):
        self.clip_loss = ClipLoss(local_loss=self.local_loss,
                                  gather_with_grad=self.gather_with_grad,
                                  group=self.group,
                                  slice_group=self.slice_group,
                                  gather_scope=self.gather_scope)

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logits: torch.Tensor,
                 labels: torch.Tensor, logit_scale: torch.Tensor,
                 output_dict: bool = False):
        """``logits`` [B, L, vocab], ``labels`` [B, L]: the weighted
        contrastive loss (0 at weight 0, no gather) and the weighted mean
        cross entropy over the labels that are not ``pad_id``."""
        clip_loss = torch.zeros((), device=logits.device)
        if self.clip_loss_weight:
            clip_loss = self.clip_loss_weight * self.clip_loss(
                image_features, text_features, logit_scale)
        logp = torch.log_softmax(logits.float(), dim=-1)
        picked = logp.gather(-1, labels[..., None])[..., 0]
        valid = (labels != self.pad_id).float()
        denom = valid.sum().clamp_min(1.0)
        if self.global_tokens and _distributed():
            total = valid.sum()
            dist.all_reduce(total, group=self.group)
            denom = total.clamp_min(1.0) / dist.get_world_size(self.group)
        caption_loss = (-(picked * valid).sum() / denom
                        * self.caption_loss_weight)
        if output_dict:
            return {"contrastive_loss": clip_loss,
                    "caption_loss": caption_loss}
        return clip_loss, caption_loss


@dataclasses.dataclass
class DistillClipLoss(ClipLoss):
    """The CLIP loss of the first views plus a soft cross-entropy against
    the logits of a frozen model's features, which take no gradient."""

    def _logits_pair(self, img: torch.Tensor, txt: torch.Tensor,
                     scale: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(image -> text, text -> image) logits of [B, D] features: the
        local or gathered queries against the gathered keys."""
        if not _distributed():
            return _pair_logits(img, txt, scale), _pair_logits(txt, img, scale)
        all_img, all_txt = self._gather(img[None])[0], self._gather(txt[None])[0]
        if not self.local_loss:
            img, txt = all_img, all_txt
        return _pair_logits(img, all_txt, scale), _pair_logits(txt, all_img,
                                                               scale)

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 dist_image_features: torch.Tensor,
                 dist_text_features: torch.Tensor,
                 dist_logit_scale: torch.Tensor, output_dict: bool = False):
        li, lt = self._logits_pair(_as_views(image_features)[0],
                                   _as_views(text_features)[0], logit_scale)
        dli, dlt = self._logits_pair(
            _as_views(dist_image_features)[0].detach(),
            _as_views(dist_text_features)[0].detach(),
            dist_logit_scale.detach())
        labels = self._labels(li.shape[0], li.device)
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
    """Pairwise sigmoid loss of the first views: each block adds
    ``-sum(log sigmoid(label * (scale * img @ txt.T + bias))) / B`` with
    label -1, and +1 on the diagonal of this rank's own block.  Under a
    process group the text features go round the ring of ranks (JAX's
    ``ppermute``: rank i sends to i + 1), one negatives-only block a hop;
    ``bidir`` sends both ways at once and covers the ring in half the
    hops, one last hop to the right when the other ranks are odd in
    number."""

    bidir: bool = True

    @staticmethod
    def _block(img: torch.Tensor, txt: torch.Tensor, scale: torch.Tensor,
               bias: Optional[torch.Tensor], negative_only: bool
               ) -> torch.Tensor:
        logits = _pair_logits(img, txt, scale)
        if bias is not None:
            logits = logits + bias.float()
        b = img.shape[0]
        labels = -torch.ones_like(logits)
        if not negative_only:
            labels = labels + 2.0 * torch.eye(b, txt.shape[0],
                                              device=logits.device)
        return -F.logsigmoid(labels * logits).sum() / b

    def __call__(self, image_features: torch.Tensor,
                 text_features: torch.Tensor, logit_scale: torch.Tensor,
                 logit_bias: Optional[torch.Tensor] = None,
                 output_dict: bool = False):
        img = _as_views(image_features)[0]
        txt = _as_views(text_features)[0]
        loss = self._block(img, txt, logit_scale, logit_bias, False)
        n = world_size()
        if n > 1:
            r = dist.get_rank()
            right, left = (r + 1) % n, (r - 1) % n

            def negatives(t: torch.Tensor) -> torch.Tensor:
                return self._block(img, t, logit_scale, logit_bias, True)

            if self.bidir:
                num_bidir, remainder = divmod(n - 1, 2)
                to_right = to_left = txt
                for _ in range(num_bidir):
                    recv_r, recv_l = _NeighbourExchange.apply(
                        (right, left), (left, right), to_right, to_left)
                    for t in (recv_r, recv_l):
                        loss = loss + negatives(t)
                    to_right, to_left = recv_r, recv_l
                if remainder:
                    (recv,) = _NeighbourExchange.apply((right,), (left,),
                                                       to_right)
                    loss = loss + negatives(recv)
            else:
                frm = txt
                for _ in range(n - 1):
                    (frm,) = _NeighbourExchange.apply((right,), (left,), frm)
                    loss = loss + negatives(frm)
        return {"contrastive_loss": loss} if output_dict else loss
