"""cosmos_tpu_torch: the PyTorch and CUDA port of cosmos_tpu for NVIDIA
Hopper (H100).

The JAX package ``cosmos_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX.  Plain tensor code is
PyTorch, and each Pallas kernel of ``cosmos_tpu`` on a ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``ops/csrc/``.  Entry points
run on the card unless the caller passes ``device="cpu"``.  Ported: the
serving path (``create_model``, the encoders), the training step in the
COSMOS, plain CLIP, SigLIP and distillation modes with accumulation, remat
and LiT locking (``create_optimizer``, ``create_train_state``,
``make_train_step``, ``COSMOSLoss``), the host data pipeline (``data/``), the trainer
(``python -m cosmos_tpu_torch.training.main``) and the timm-family and
ModifiedResNet vision towers with their configs.

The names below are imported on first use, so that the data loader's worker
processes, which import ``cosmos_tpu_torch.data``, never import torch.
"""

import importlib

_EXPORTS = {
    "COSMOSLoss": ".losses.contrastive",
    "create_model": ".models.factory",
    "create_optimizer": ".training.train",
    "create_train_state": ".training.train",
    "load_checkpoint": ".models.convert",
    "make_train_step": ".training.train",
    "resolve_dtype": ".models.factory",
    "state_dict_from_jax_params": ".models.convert",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
