"""The fused-LayerNorm kernels (counterpart of
``cosmos_tpu/ops/experimental``), each behind a toggle that is off by
default, as in the JAX package:

- ``layer_norm.fused_layer_norm``: K3 forward (``csrc/layer_norm_fwd.cu``)
  and K4 backward (``csrc/layer_norm_bwd.cu``); ``models.layers.FUSED_LN``.
- ``layer_norm.hybrid_layer_norm``: plain forward, K4 backward;
  ``models.layers.HYBRID_LN``.
- ``ln_matmul.ln_matmul``: K5 (``csrc/ln_matmul.cu``), LayerNorm fused into
  the packed QKV projection; ``create_model(..., fuse_ln=True)``.
- ``mlp_block.mlp_block``: K6 (``csrc/mlp_block.cu``), LayerNorm, c_fc, the
  activation and c_proj in one kernel; ``create_model(..., fuse_ln=True)``.

The JAX package measured these as slower than XLA's fusions in its TPU
step; how they behave in the H100 step is measured by ``chip_smoke.py``
(``PERF.md``).  Every wrapper launches its kernel on a CUDA tensor or
raises, and takes its plain PyTorch version only for CPU tensors.

The package re-exports nothing, so that ``from ...ops.experimental import
ln_matmul`` is the module (with its launch count), not the function of the
same name.
"""
