"""cosmos_tpu_torch: the PyTorch and CUDA port of cosmos_tpu for NVIDIA
Hopper (H100).

The JAX package ``cosmos_tpu`` is the reference this port is tested
against; this package imports neither it nor JAX.  Plain tensor code is
PyTorch, and each Pallas kernel of ``cosmos_tpu`` on a ported path is a
hand-written CUDA kernel for ``sm_90a`` under ``ops/csrc/``.  Entry points
run on the card unless the caller passes ``device="cpu"``.  The serving
path (``create_model``, the encoders) and the COSMOS pre-training step
(``create_optimizer``, ``create_train_state``, ``make_train_step``,
``COSMOSLoss``) are ported.
"""

from .losses.contrastive import COSMOSLoss
from .models.convert import load_checkpoint, state_dict_from_jax_params
from .models.factory import create_model, resolve_dtype
from .training.train import (create_optimizer, create_train_state,
                             make_train_step)

__all__ = [
    "COSMOSLoss",
    "create_model",
    "create_optimizer",
    "create_train_state",
    "load_checkpoint",
    "make_train_step",
    "resolve_dtype",
    "state_dict_from_jax_params",
]
