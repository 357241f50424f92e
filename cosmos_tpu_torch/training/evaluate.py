"""Evaluation for the trainer and eval-only runs (counterpart of
``cosmos_tpu/training/evaluate.py``).

  - ``make_encoders``: the normalised image and text encoders and the raw
    text encoder of one model;
  - ``evaluate_model``: COCO/Flickr retrieval, ImageNet (val, V2) and the
    classification sets' zero-shot top-1/top-5 for one model;
  - ``evaluate_on_split``: the in-batch contrastive val loss and
    ``get_clip_metrics`` over a val split;
  - ``evaluate``: all of these for the student and the EMA teacher, at the
    cadences of --zeroshot-frequency / --retrieval-frequency and the
    narrowing of --eval-mode, appended to ``results.jsonl``.

Every forward runs in eval mode without autograd on the model's device, so
the self-attentions take K1 and never K2; a model that was in train mode is
put back in it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..data.datasets import RetrievalData
from ..data.loader import MapDatasetLoader
from ..data.transforms import EvalTransform, eval_transform_from_args
from .retrieval import evaluate_retrieval, get_clip_metrics
from .zero_shot import (CLASSIFICATION_DATASETS, supports_eot_truncation,
                        zero_shot_classification_eval, zero_shot_eval)

logger = logging.getLogger(__name__)


def make_encoders(model: torch.nn.Module
                  ) -> Tuple[Callable, Callable, Callable]:
    """(normalised image encoder, normalised text encoder, raw text
    encoder).  Each takes a numpy array or tensor, moves it to the model's
    device and runs under ``torch.inference_mode``; features come back as
    tensors on that device.  A CLIP encoder returns a dict, CoCa's the bare
    features."""
    device = next(model.parameters()).device

    def _run(method, normalize: bool, key: str):
        def call(x: Any) -> torch.Tensor:
            with torch.inference_mode():
                out = method(torch.as_tensor(x, device=device), normalize)
            return out[key] if isinstance(out, dict) else out
        return call

    return (
        _run(model.encode_image, True, "image_features"),
        _run(model.encode_text, True, "text_features"),
        _run(model.encode_text, False, "text_features"),
    )


@contextlib.contextmanager
def eval_mode(model: torch.nn.Module):
    """``model.eval()`` for the block, then the mode it had."""
    was_training = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was_training)


class RetrievalImageDataset:
    """(eval-transformed image, raw image id) pairs for one retrieval set."""

    def __init__(self, data: RetrievalData, image_size: int = 224,
                 transform=None):
        self.data = data
        self.transform = transform or EvalTransform(image_size=image_size)

    def __len__(self):
        return len(self.data.image_paths)

    def __getitem__(self, idx):
        from PIL import Image

        img = Image.open(self.data.image_paths[idx]).convert("RGB")
        return self.transform(img), self.data.image_ids[idx]


def evaluate_model(
    model: torch.nn.Module,
    data: Dict,
    *,
    tokenizer=None,
    prefix: str = "",
    batch_size: int = 256,
    image_size: int = 224,
    zero_shot: bool = True,
    retrieval: bool = True,
    eval_transform=None,
) -> Dict[str, float]:
    """Every eval ``data`` carries for one model: COCO/Flickr retrieval
    (R@1/5/10, mean and median rank both ways) when ``retrieval``; with
    ``zero_shot``, ImageNet's 1000-class and each classification set's
    prompt-bank classifier (``tokenizer`` needed), top-1 and top-5."""
    metrics: Dict[str, float] = {}
    enc_image, enc_text_norm, enc_text_raw = make_encoders(model)
    eot_truncate = supports_eot_truncation(model)
    with eval_mode(model):
        for name in ("coco-retrieval", "flickr-retrieval"):
            if not retrieval or name not in data:
                continue
            rd: RetrievalData = data[name]
            img_loader = MapDatasetLoader(
                RetrievalImageDataset(rd, image_size,
                                      transform=eval_transform), batch_size
            )
            m = evaluate_retrieval(
                enc_image, enc_text_norm, rd, img_loader,
                batch_size=batch_size,
                prefix=f"{prefix}{name.split('-')[0]}_",
                eot_truncate=eot_truncate,
            )
            metrics.update(m)
            logger.info(f"{name} [{prefix or 'student'}]: "
                        + json.dumps({k: round(v, 4) for k, v in m.items()}))
        if not zero_shot:
            return metrics
        if "imagenet-val" in data or "imagenet-v2" in data:
            m = zero_shot_eval(enc_image, enc_text_raw, tokenizer, data,
                               eot_truncate=eot_truncate)
            metrics.update({f"{prefix}{k}": v for k, v in m.items()})
            logger.info(f"imagenet [{prefix or 'student'}]: {m}")
        for name in CLASSIFICATION_DATASETS:
            if name in data:
                m = zero_shot_classification_eval(
                    enc_image, enc_text_raw, tokenizer, name, data[name],
                    eot_truncate=eot_truncate)
                metrics.update({f"{prefix}{k}": v for k, v in m.items()})
                logger.info(f"{name} [{prefix or 'student'}]: {m}")
    return metrics


def evaluate_on_split(
    model: torch.nn.Module,
    dataloader,
    *,
    keyword: str = "",
) -> Dict[str, float]:
    """Contrastive val loss and in-batch rank metrics over a val split.
    Features accumulate on the host; the in-batch CLIP loss uses per-batch
    diagonal labels, as the reference does."""
    device = next(model.parameters()).device
    all_img, all_txt = [], []
    cumulative_loss = 0.0
    num_samples = 0
    scale = 1.0
    with eval_mode(model), torch.no_grad():
        for images, texts in dataloader:
            out = model(torch.from_numpy(images).to(device),
                        torch.from_numpy(np.asarray(texts)).to(device))
            scale = float(out["logit_scale"])
            img_f32 = out["image_features"].float().cpu().numpy()
            txt_f32 = out["text_features"].float().cpu().numpy()
            all_img.append(img_f32)
            all_txt.append(txt_f32)
            logits = scale * img_f32 @ txt_f32.T
            b = logits.shape[0]

            def ce(lg):
                lg = lg - lg.max(axis=1, keepdims=True)
                logp = lg - np.log(np.exp(lg).sum(axis=1, keepdims=True))
                return -np.mean(np.diag(logp))

            cumulative_loss += 0.5 * (ce(logits) + ce(logits.T)) * b
            num_samples += b
    if num_samples == 0:
        return {}
    prefix = f"{keyword}_" if keyword else ""
    metrics = {
        f"{prefix}{k}": v
        for k, v in get_clip_metrics(
            np.concatenate(all_img), np.concatenate(all_txt), scale
        ).items()
    }
    metrics[f"{prefix}clip_val_loss"] = float(cumulative_loss / num_samples)
    metrics[f"{prefix}num_samples"] = num_samples
    return metrics


def evaluate(
    student: torch.nn.Module,
    teacher: Optional[torch.nn.Module],
    data: Dict,
    epoch: int,
    args,
    tokenizer,
) -> Dict[str, float]:
    """Student and EMA-teacher evaluation: val loss on the val and
    train-eval splits, zero-shot classification at --zeroshot-frequency
    and retrieval at --retrieval-frequency (each also at the last epoch);
    --eval-mode retrieval / classification keeps only that family.
    ``teacher=None`` or --no-eval-teacher: the student only."""
    metrics: Dict[str, float] = {"epoch": epoch}
    zs_freq = getattr(args, "zeroshot_frequency", 1)
    rt_freq = getattr(args, "retrieval_frequency", 1)
    epochs = getattr(args, "epochs", epoch)
    zero_shot = bool(zs_freq) and (epoch % zs_freq == 0 or epoch == epochs)
    retrieval = bool(rt_freq) and (epoch % rt_freq == 0 or epoch == epochs)
    mode = getattr(args, "eval_mode", "")
    if mode == "retrieval":
        zero_shot = False
    elif mode == "classification":
        retrieval = False
    if not getattr(args, "eval_teacher", True):
        teacher = None
    models = [("", student)] + ([("ema_", teacher)] if teacher is not None
                                else [])
    for split, kw in (("val", ""), ("train_eval", "train_eval")):
        if split not in data:
            continue
        for prefix, model in models:
            keyword = (f"ema_{kw}" if kw else "ema") if prefix else kw
            metrics.update(evaluate_on_split(model, data[split],
                                             keyword=keyword))
    if retrieval or zero_shot:
        eval_transform = eval_transform_from_args(
            args, student.cfg.vision_cfg.image_size)
        for prefix, model in models:
            metrics.update(evaluate_model(
                model, data, tokenizer=tokenizer, prefix=prefix,
                batch_size=args.batch_size, zero_shot=zero_shot,
                retrieval=retrieval, eval_transform=eval_transform))
    if getattr(args, "checkpoint_path", None):
        results_file = os.path.join(
            os.path.dirname(args.checkpoint_path), "results.jsonl"
        )
        os.makedirs(os.path.dirname(results_file), exist_ok=True)
        with open(results_file, "a") as f:
            f.write(json.dumps(metrics) + "\n")
    return metrics
