"""cosmos_tpu_torch: the PyTorch and CUDA port of cosmos_tpu for NVIDIA
Hopper (H100).

The JAX package ``cosmos_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX.  Plain tensor code is
PyTorch, and each Pallas kernel of ``cosmos_tpu`` on a ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``ops/csrc/``.  Entry points
run on the card unless the caller passes ``device="cpu"``.  Ported: the
serving path (``create_model``, the encoders), the training step in the
COSMOS, plain CLIP, SigLIP, distillation and CoCa modes with accumulation, remat
and LiT locking (``create_optimizer``, ``create_train_state``,
``make_train_step``, ``COSMOSLoss``), the host data pipeline (``data/``,
with the native tar streaming and DCT-scaled JPEG decode of
``data/native.py``, built with g++ from ``data/csrc/``), the trainer
(``python -m cosmos_tpu_torch.training.main``), the native ViT in every
configuration of the JAX package's (SigLIP's MAP-pooled, no-CLS tower and
the ``ViT-B-16-SigLIP`` config among them), the timm-family and
ModifiedResNet vision towers with their configs, and the weights in: every
local checkpoint format and cached pretrained tag the JAX package's
``create_model(pretrained=...)`` reads (``load_checkpoint``,
``load_openai_model``, the registry, big_vision SigLIP files), and CoCa
(``CoCa``, ``CoCaLoss``, caption generation in ``models.coca``).  What
needs a download (HF tokenizers and towers, the hub) is refused.

The names below are the JAX package's public names.  They are imported on
first use, so that the data loader's worker processes, which import
``cosmos_tpu_torch.data``, never import torch.  A name whose feature is not
ported raises ``NotImplementedError`` naming its ROADMAP item.
"""

import importlib

_EXPORTS = {
    # factory
    "create_model": ".models.factory",
    "create_model_and_transforms": ".models.factory",
    "create_model_from_pretrained": ".models.factory",
    "create_loss": ".models.factory",
    "get_tokenizer": ".models.factory",
    "load_checkpoint": ".models.checkpoint",
    "resolve_dtype": ".models.factory",
    "state_dict_from_jax_params": ".models.convert",
    # model classes and configs; one CLIP class serves the custom-text layout
    "CLIP": ".models.clip",
    "CustomTextCLIP": (".models.clip", "CLIP"),
    "CoCa": ".models.coca",
    "CLIPCfg": ".models.config",
    "VisionCfg": ".models.config",
    "TextCfg": ".models.config",
    "CLIPVisionCfg": (".models.config", "VisionCfg"),
    "CLIPTextCfg": (".models.config", "TextCfg"),
    "list_models": ".models.config",
    "add_model_config": ".models.config",
    "get_model_config": ".models.config",
    # model utilities
    "convert_weights_to_lp": ".utils",
    "convert_weights_to_fp16": ".utils",
    "trace_model": ".models.trace",
    "get_cast_dtype": ".training.precision",
    "get_input_dtype": ".training.precision",
    "get_model_preprocess_cfg": ".models.factory",
    "set_model_preprocess_cfg": ".models.factory",
    "get_model_tokenize_cfg": ".models.factory",
    # OpenAI's releases and the pretrained registry
    "load_openai_model": ".models.openai",
    "list_openai_models": ".models.openai",
    "list_pretrained": ".models.pretrained",
    "list_pretrained_models_by_tag": ".models.pretrained",
    "list_pretrained_tags_by_model": ".models.pretrained",
    "get_pretrained_cfg": ".models.pretrained",
    "get_pretrained_url": ".models.pretrained",
    "is_pretrained_cfg": ".models.pretrained",
    # losses
    "ClipLoss": ".losses.contrastive",
    "DistillClipLoss": ".losses.contrastive",
    "COSMOSLoss": ".losses.contrastive",
    "CoCaLoss": ".losses.contrastive",
    "SigLipLoss": ".losses.contrastive",
    # training
    "create_optimizer": ".training.train",
    "create_train_state": ".training.train",
    "make_train_step": ".training.train",
    # tokenizer
    "SimpleTokenizer": ".data.tokenizer",
    "tokenize": ".data.tokenizer",
    "decode": ".data.tokenizer",
    # transforms and constants
    "image_transform": ".data.transforms",
    "AugmentationCfg": ".data.transforms",
    "OPENAI_DATASET_MEAN": ".data.constants",
    "OPENAI_DATASET_STD": ".data.constants",
    # zero-shot classifier and its metadata
    "build_zero_shot_classifier": ".training.zero_shot",
    "build_zero_shot_classifier_legacy": ".training.zero_shot",
    "OPENAI_IMAGENET_TEMPLATES": ".training.zero_shot",
    "SIMPLE_IMAGENET_TEMPLATES": ".training.zero_shot",
    "IMAGENET_CLASSNAMES": ".training.zero_shot",
}

# the JAX package's names whose feature is not ported: ROADMAP item
_NEEDS_NETWORK = 'queue 1, "Not queued": it needs a download or an upload'
_UNPORTED = {
    "download_pretrained": _NEEDS_NETWORK,
    "download_pretrained_from_url": _NEEDS_NETWORK,
    "push_to_hf_hub": _NEEDS_NETWORK,
    "push_pretrained_to_hf_hub": _NEEDS_NETWORK,
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _UNPORTED:
        raise NotImplementedError(
            f"cosmos_tpu_torch.{name} is not ported (ROADMAP "
            f"{_UNPORTED[name]})")
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module, attr = _EXPORTS[name] if isinstance(_EXPORTS[name], tuple) \
        else (_EXPORTS[name], name)
    return getattr(importlib.import_module(module, __name__), attr)


def __dir__():
    return sorted(__all__)
