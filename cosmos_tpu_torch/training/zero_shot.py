"""Zero-shot classification: the prompt-ensembled classifier, top-k
accuracy, ImageNet and the 10 classification sets, and EOT truncation of
token batches (counterpart of ``cosmos_tpu/training/zero_shot.py``).

Text and image features come from the encoders as tensors on the model's
device; the classifier is built and applied there in float32, and only the
logits of each image batch go to the host for the top-k counts.  The prompt
banks are this package's own copies of the JAX package's assets
(``assets/imagenet_zeroshot.json``, ``assets/classification_banks.json``).
"""

from __future__ import annotations

import functools
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

_ASSETS = Path(__file__).resolve().parent.parent / "assets"


@functools.lru_cache(maxsize=1)
def load_imagenet_metadata() -> Dict:
    """The 1000 ImageNet class names, the 80 OpenAI templates and the 7
    simple ones (cached: student and teacher ask for it every eval)."""
    return json.loads((_ASSETS / "imagenet_zeroshot.json").read_text())


@functools.lru_cache(maxsize=1)
def load_classification_banks() -> Dict:
    """Templates and labels per classification set."""
    return json.loads((_ASSETS / "classification_banks.json").read_text())


# the eval dataset names the trainer evaluates, and the loader module names
# that alias them
CLASSIFICATION_DATASETS = (
    "food101", "cifar10", "cifar100", "sun397", "stanford_car",
    "aircraft", "dtd", "pets", "flowers", "caltech101",
)
_BANK_ALIASES = {
    "fgvc_aircraft": "aircraft",
    "oxford_pets": "pets",
    "flowers102": "flowers",
}


def bank_key(dataset_name: str) -> str:
    return _BANK_ALIASES.get(dataset_name, dataset_name)


def supports_eot_truncation(model) -> bool:
    """True when the model's text tower is the native causal + argmax-EOT
    one, for which ``truncate_to_eot`` is exact."""
    tcfg = getattr(getattr(model, "cfg", None), "text_cfg", None)
    return bool(tcfg is not None
                and getattr(tcfg, "eot_truncation_exact", False))


def truncate_to_eot(tokens: Any, multiple: int = 16) -> Any:
    """Slice a padded [N, L] token batch (numpy array or tensor) at
    max(eot)+1, rounded up to ``multiple``.

    Exact for causal + argmax-EOT towers: positions <= eot attend only to
    positions <= eot, and truncation at >= eot+1 keeps the argmax-EOT pool
    position."""
    l_eff = int(tokens.argmax(-1).max()) + 1
    l_eff = min(-(-l_eff // multiple) * multiple, tokens.shape[1])
    return tokens[:, :l_eff]


def _normalized(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.norm(feats, dim=-1, keepdim=True)


def build_zero_shot_classifier(
    encode_text_fn: Callable[[np.ndarray], torch.Tensor],
    tokenizer,
    classnames: Sequence[str],
    templates: Sequence[Any],
    num_classes_per_batch: int = 10,
    eot_truncate: bool = False,
) -> torch.Tensor:
    """[D, n_classes] float32 classifier on the encoder's device.

    ``encode_text_fn``: tokens [N, L] -> unnormalised text features [N, D].
    ``templates``: format strings with a '{}' placeholder, or callables.
    Each call encodes ``num_classes_per_batch`` classes × every template
    (EOT-truncated to a multiple of 16 when ``eot_truncate``); per prompt
    L2-normalise, mean over the templates, normalise again."""
    fmt = [(t if callable(t) else t.format) for t in templates]
    weights = []
    for start in range(0, len(classnames), num_classes_per_batch):
        batch = classnames[start:start + num_classes_per_batch]
        tokens = tokenizer([f(c) for c in batch for f in fmt])
        if eot_truncate:
            tokens = truncate_to_eot(tokens)
        feats = _normalized(encode_text_fn(tokens).float())
        feats = feats.reshape(len(batch), len(fmt), -1).mean(dim=1)
        weights.append(_normalized(feats))
    return torch.cat(weights, dim=0).T


def build_zero_shot_classifier_legacy(
    encode_text_fn: Callable[[np.ndarray], torch.Tensor],
    tokenizer,
    classnames: Sequence[str],
    templates: Sequence[Any],
) -> torch.Tensor:
    """One class a call (the reference keeps it for the order of old
    results)."""
    return build_zero_shot_classifier(encode_text_fn, tokenizer, classnames,
                                      templates, num_classes_per_batch=1)


def accuracy(logits: np.ndarray, target: np.ndarray,
             topk: Sequence[int] = (1,)) -> List[float]:
    """Top-k correct counts."""
    pred = np.argsort(-logits, axis=-1)
    return [
        float((pred[:, :k] == target[:, None]).any(axis=1).sum()) for k in topk
    ]


def run_classification_eval(
    encode_image_fn: Callable[[Any], torch.Tensor],
    classifier: torch.Tensor,
    dataloader,
) -> Tuple[float, float]:
    """Top-1 and top-5 accuracy of ``100 * normalised image features @
    classifier`` over (images, targets) batches, divided by the number of
    images.  A ragged last batch is encoded as it is (JAX pads it to one
    compiled shape; the padded rows never count)."""
    top1 = top5 = n = 0.0
    for images, target in dataloader:
        feats = _normalized(encode_image_fn(images).float())
        logits = (100.0 * feats @ classifier).cpu().numpy()
        a1, a5 = accuracy(logits, np.asarray(target), topk=(1, 5))
        top1 += a1
        top5 += a5
        n += logits.shape[0]
    return top1 / n, top5 / n


def zero_shot_eval(
    encode_image_fn: Callable,
    encode_text_fn: Callable,
    tokenizer,
    data: Dict,
    use_simple_templates: bool = False,
    eot_truncate: bool = False,
) -> Dict[str, float]:
    """ImageNet (val and V2) top-1/top-5 with the 1000-class classifier."""
    results: Dict[str, float] = {}
    meta = load_imagenet_metadata()
    templates = (meta["simple_templates"] if use_simple_templates
                 else meta["templates"])
    classifier = build_zero_shot_classifier(
        encode_text_fn, tokenizer, meta["classnames"], templates,
        eot_truncate=eot_truncate,
    )
    for split, key in (("imagenet-val", "imagenet-zeroshot-val-top1"),
                       ("imagenet-v2", "imagenetv2-zeroshot-val-top1")):
        if split in data:
            top1, top5 = run_classification_eval(
                encode_image_fn, classifier, data[split])
            results[key] = top1
            results[key.replace("top1", "top5")] = top5
    return results


def zero_shot_classification_eval(
    encode_image_fn: Callable,
    encode_text_fn: Callable,
    tokenizer,
    dataset_name: str,
    dataloader,
    eot_truncate: bool = False,
) -> Dict[str, float]:
    """One classification set through its prompt and label bank; metric
    names ``{dataset_name}-zeroshot-val-top1/top5``, as the reference's."""
    banks = load_classification_banks()
    key = bank_key(dataset_name)
    if key not in banks["templates"]:
        raise KeyError(
            f"no prompt bank for {dataset_name}; have "
            f"{sorted(banks['templates'])[:10]}..."
        )
    classifier = build_zero_shot_classifier(
        encode_text_fn, tokenizer, banks["labels"][key],
        banks["templates"][key], eot_truncate=eot_truncate,
    )
    top1, top5 = run_classification_eval(encode_image_fn, classifier,
                                          dataloader)
    return {
        f"{dataset_name}-zeroshot-val-top1": top1,
        f"{dataset_name}-zeroshot-val-top5": top5,
    }


def __getattr__(name: str):
    """``OPENAI_IMAGENET_TEMPLATES``, ``SIMPLE_IMAGENET_TEMPLATES`` and
    ``IMAGENET_CLASSNAMES``, read from the asset on first use."""
    key = {"OPENAI_IMAGENET_TEMPLATES": "templates",
           "SIMPLE_IMAGENET_TEMPLATES": "simple_templates",
           "IMAGENET_CLASSNAMES": "classnames"}.get(name)
    if key is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return tuple(load_imagenet_metadata()[key])
