"""The COSMOS pre-training step (counterpart of
``cosmos_tpu/training/train.py``).

One call of the step function does, in the reference's order:

  - the student's COSMOS forward on every crop and caption view and the
    EMA teacher's forward on the 2 global crops and the first 2 caption
    views (``torch.no_grad``);
  - ``COSMOSLoss`` and its backward (every self-attention through K1 and
    K2 on the card);
  - the EMA update ``k + (1 - m)(q - k)`` from the PRE-update student;
  - AdamW with the gain/bias/LN/logit-scale weight-decay exemption, its LR
    taken from the schedule at the number of updates so far;
  - the clamps of ``logit_scale`` and ``distill_logit_scale`` to
    ``[0, ln 100]`` on the student and the teacher.

The batch is views-leading, as in the JAX package: ``global_images``
``[2, B, H, W, 3]``, ``local_images`` ``[n, B, h, w, 3]`` (optional),
``texts`` ``[k, B, L]``; uint8 images are normalised on the device.
Single process; gradient accumulation, patch dropout, frozen towers and the
other training modes (SigLIP, CoCa, distillation) are not ported yet.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..losses.contrastive import COSMOSLoss

LN100 = 4.605170185988092  # ln(100)
_NO_DECAY = ("ln", "bias", "logit_scale", "bn")


def wd_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: not for tensors
    of fewer than 2 dims, nor for names holding ``ln``, ``bias``,
    ``logit_scale`` or ``bn`` (the JAX package's rule, applied to the
    port's OpenCLIP names)."""
    return {name: p.ndim >= 2 and not any(t in name.lower()
                                          for t in _NO_DECAY)
            for name, p in model.named_parameters()}


class ScheduledAdamW(torch.optim.AdamW):
    """AdamW whose LR is ``lr_schedule(updates so far)`` at every step (0
    on the first update, the count optax's schedule sees), with optional
    global-norm gradient clipping before the update."""

    def __init__(self, params, lr_schedule: Callable[[int], float],
                 grad_clip_norm: Optional[float] = None, **kwargs: Any):
        super().__init__(params, lr=float(lr_schedule(0)), **kwargs)
        self.lr_schedule = lr_schedule
        self.grad_clip_norm = grad_clip_norm
        self.num_updates = 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = float(self.lr_schedule(self.num_updates))
        for group in self.param_groups:
            group["lr"] = lr
        if self.grad_clip_norm is not None:
            torch.nn.utils.clip_grad_norm_(
                [p for g in self.param_groups for p in g["params"]],
                self.grad_clip_norm)
        loss = super().step(closure)
        self.num_updates += 1
        return loss


def create_optimizer(
    model: nn.Module,
    lr_schedule: Callable[[int], float],
    beta1: float = 0.9,
    beta2: float = 0.98,
    eps: float = 1e-6,
    weight_decay: float = 0.2,
    grad_clip_norm: Optional[float] = None,
) -> ScheduledAdamW:
    """AdamW over two param groups, decayed (``wd_mask``) and not."""
    mask = wd_mask(model)
    named = list(model.named_parameters())
    groups = [
        {"params": [p for n, p in named if mask[n]],
         "weight_decay": weight_decay},
        {"params": [p for n, p in named if not mask[n]],
         "weight_decay": 0.0},
    ]
    return ScheduledAdamW(groups, lr_schedule, grad_clip_norm,
                          betas=(beta1, beta2), eps=eps)


@dataclasses.dataclass
class TrainStepConfig:
    cosmos: bool = True
    local_loss: bool = False
    momentum_teacher: float = 0.999
    fix_momentum: bool = True
    momentum_schedule: Optional[Callable[[int], float]] = None
    lr_schedule: Optional[Callable[[int], float]] = None  # for the metric
    input_dtype: torch.dtype = torch.float32
    image_mean: Tuple[float, ...] = (0.48145466, 0.4578275, 0.40821073)
    image_std: Tuple[float, ...] = (0.26862954, 0.26130258, 0.27577711)
    log_grad_norm: bool = False


@dataclasses.dataclass
class TrainState:
    step: int
    student: nn.Module
    teacher: nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model: nn.Module,
                       optimizer: torch.optim.Optimizer) -> TrainState:
    """Student, its EMA teacher (a copy that takes no gradient) and the
    optimizer."""
    teacher = copy.deepcopy(model).requires_grad_(False)
    return TrainState(step=0, student=model, teacher=teacher,
                      optimizer=optimizer)


def _clamp_logit_scales(model: nn.Module) -> None:
    for name in ("logit_scale", "distill_logit_scale"):
        p = getattr(model, name, None)
        if p is not None:
            p.clamp_(0.0, LN100)


def _views(x: torch.Tensor, v: int) -> torch.Tensor:
    """[V*B, ...] views-major -> [V, B, ...]."""
    return x.reshape(v, x.shape[0] // v, *x.shape[1:])


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                    cfg: TrainStepConfig
                    ) -> Callable[[TrainState, Dict[str, Any]],
                                  Dict[str, Any]]:
    """Returns ``step(state, batch) -> metrics``, which updates the state's
    student, teacher and optimizer in place and advances ``state.step``.

    Metrics: ``loss``, ``clip_loss``, ``distill_loss`` and ``logit_scale``
    as detached 0-d tensors on the model's device (reading one syncs the
    host), ``momentum`` and ``lr`` as floats, and ``grad_norm`` when
    ``cfg.log_grad_norm``."""
    if not cfg.cosmos:
        raise NotImplementedError(
            "only the COSMOS training step is ported (cfg.cosmos=True)")
    if getattr(model, "distill_logit_scale", None) is None:
        raise ValueError("the COSMOS step needs a model built with "
                         "cosmos=True, output_all=True, attentional_pool=True")
    loss_fn = COSMOSLoss(local_loss=cfg.local_loss)
    device = next(model.parameters()).device
    mean = torch.tensor(cfg.image_mean, dtype=torch.float32,
                        device=device) * 255.0
    inv_std = 1.0 / (torch.tensor(cfg.image_std, dtype=torch.float32,
                                  device=device) * 255.0)

    def prep_images(x) -> torch.Tensor:
        """uint8 [..., H, W, 3] -> normalised ``input_dtype``."""
        x = torch.as_tensor(x).to(device, non_blocking=True)
        if x.dtype == torch.uint8:
            return ((x.float() - mean) * inv_std).to(cfg.input_dtype)
        return x.to(cfg.input_dtype)

    def step(state: TrainState, batch: Dict[str, Any]) -> Dict[str, Any]:
        if state.student is not model or state.optimizer is not optimizer:
            raise ValueError("the train state holds another model or "
                             "optimizer than this step was made for")
        student, teacher, opt = model, state.teacher, optimizer
        g = torch.as_tensor(batch["global_images"])
        vg, b = g.shape[0], g.shape[1]
        g_flat = prep_images(g.reshape(vg * b, *g.shape[2:]))
        loc = batch.get("local_images")
        l_flat, vl = None, 0
        if loc is not None:
            loc = torch.as_tensor(loc)
            vl = loc.shape[0]
            l_flat = prep_images(loc.reshape(vl * b, *loc.shape[2:]))
        t = torch.as_tensor(batch["texts"]).to(device, non_blocking=True)
        k = t.shape[0]
        if k < 2:
            # the teacher distills against two global caption views
            raise ValueError(
                f"COSMOS training needs >= 2 caption views, got k={k}")
        t_flat = t.reshape(k * b, t.shape[2])

        opt.zero_grad(set_to_none=True)
        s_out = student(g_flat, t_flat, l_flat, batch_size=b)
        with torch.no_grad():
            t_out = teacher(g_flat, t_flat[:2 * b])
        losses = loss_fn(
            s_image_features=_views(s_out["image_features"], vg + vl),
            s_text_features=_views(s_out["text_features"], k),
            logit_scale=s_out["logit_scale"],
            t_image_features=_views(t_out["image_features"], 2),
            t_text_features=_views(t_out["text_features"], 2),
            distill_logit_scale=s_out["distill_logit_scale"],
            s_img_crossmodal_features=_views(
                s_out["img_crossmodal_features"], vg + vl),
            s_txt_crossmodal_features=_views(
                s_out["txt_crossmodal_features"], k),
            output_dict=True)
        total = losses["distill_loss"] + losses["clip_loss"]
        total.backward()

        params = [p for p in student.parameters()]
        metrics: Dict[str, Any] = {
            "loss": total.detach(),
            "clip_loss": losses["clip_loss"].detach(),
            "distill_loss": losses["distill_loss"].detach(),
            "logit_scale": s_out["logit_scale"].detach(),
        }
        if cfg.log_grad_norm:
            metrics["grad_norm"] = torch.linalg.vector_norm(torch.stack(
                [torch.linalg.vector_norm(p.grad.float())
                 for p in params if p.grad is not None]))

        if cfg.fix_momentum or cfg.momentum_schedule is None:
            momentum = float(cfg.momentum_teacher)
        else:
            momentum = float(cfg.momentum_schedule(state.step))
        with torch.no_grad():
            # EMA from the pre-update student: k + (1 - m)(q - k)
            torch._foreach_lerp_(list(teacher.parameters()), params,
                                 1.0 - momentum)
        opt.step()
        with torch.no_grad():
            _clamp_logit_scales(student)
            _clamp_logit_scales(teacher)

        metrics["momentum"] = momentum
        if cfg.lr_schedule is not None:
            metrics["lr"] = float(cfg.lr_schedule(state.step))
        state.step += 1
        return metrics

    return step
