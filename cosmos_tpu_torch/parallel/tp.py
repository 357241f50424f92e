"""Tensor parallelism over the 'model' axis of a ('data', 'model') mesh
(counterpart of ``cosmos_tpu/parallel/tp.py``).

Megatron-style placement, as JAX's ``tp_spec`` gives it: column-parallel
input projections (the output features split, bias with them),
row-parallel output projections (the input features split, bias
replicated so that it adds once after the partial sums' reduction), every
other parameter replicated.  torch's ``Linear.weight`` is ``[out, in]``:
JAX's column-parallel kernel ``P(None, 'model')`` is ``Shard(0)`` here and
its row-parallel ``P('model', None)`` is ``Shard(1)``.

JAX's partitioner derives the collectives from the placement alone; here
the sharded parameters are DTensors on the model axis's 1-D sub-mesh and
hooks on their modules place the activations:

  - a column-parallel ``Linear`` takes its (replicated) input as a
    replicated DTensor and returns its output sharded on the features: as
    a DTensor where the consumer is elementwise and then row-parallel (the
    MLPs) or the packed attention (whose kernel K1 has the batch-only
    sharding rule of ``ops/fused_attention.py``: the qkv columns are
    all-gathered in front of it), else all-gathered to the whole local
    tensor (EVA02's separate q/k/v, its SwiGLU before the hidden
    LayerNorm, the attention pool, the head, and an HF T5 tower's ``q``,
    whose heads the attention reshapes: JAX's rule makes it the one
    sharded leaf of an HF tower);
  - ``MultiheadAttention``'s packed ``in_proj_weight``/``in_proj_bias``
    (raw parameters, no ``Linear``) are column-parallel in the same way;
    so are the separate ``q_proj_weight``/``k_proj_weight``/
    ``v_proj_weight`` of a pooler whose keys are wider than its queries
    (CoCa at unequal widths; JAX's rule for its ``q_proj``/``k_proj``/
    ``v_proj`` kernels, though JAX has no such pooler), beside an
    ``in_proj_bias`` that stays ``Shard(0)`` over its packed ``3D`` (its
    shards then cut across the q|k|v thirds: that cross-attention takes
    its weights and bias whole, ``models/attention.py`` ``_qkv_weights``);
  - under ``fuse_ln`` the blocks hand their weights to K5 and K6 with no
    ``Linear`` in between, so no hook fires: the operators' own DTensor
    rules (``ops/experimental/ln_matmul.py``, ``mlp_block.py``) run each
    kernel on the rank's local shard;
  - a row-parallel ``Linear`` takes a feature-sharded input (a replicated
    one is sliced locally) and returns the reduced, replicated output as a
    local tensor;
  - GPT-2's ``Conv1D`` weights are ``[in, out]``, the transpose of Flax's
    ``[out, in]`` kernels, on which JAX's rule splits ``c_fc``'s input
    features (and its bias's output features) and ``c_proj``'s output
    features: the same tensor dims are sharded here (``tp_spec`` gives 0
    and 1, as for a Linear, since both layouts are transposed), and the
    layer computes with the whole tensors, no hook.

So every activation between the parallel layers is an ordinary tensor,
whole on every rank of the model group.  The data axis is the trainer's:
each model group holds one block of the batch, the losses gather over the
data axis's group and the gradients average over it (``training/train.py``).
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..models.attention import MultiheadAttention
from ..models.hf_gpt2 import Conv1D
from ..models.layers import Linear, Mlp
from .mesh import DATA_AXIS, MODEL_AXIS, axis_group, batch_sharding

# JAX's module names whose kernel is column-parallel (output-feature split)
# or row-parallel (input-feature split); the packed in-projection is the
# named special case in tp_spec
_COL_KERNELS = ("c_fc", "q", "kv", "q_proj", "k_proj", "v_proj",
                "w1", "w2", "head_fc1")
_ROW_KERNELS = ("c_proj", "out_proj", "out", "w3", "head_fc2")
# the port's timm names inside a timm ViT or EVA02 trunk block -> JAX's
# (``models/convert.py`` maps the same way); EVA02's ``fc2`` is JAX's
# ``w3`` and the ViT's its ``c_proj``, row-parallel both
_TRUNK_BLOCK = re.compile(r"visual\.trunk\.blocks\.\d+\.")
# a MultiheadAttention's separate projections (its keys wider than its
# queries): JAX's q_proj/k_proj/v_proj kernels
_SEPARATE_QKV = ("q_proj_weight", "k_proj_weight", "v_proj_weight")
_TRUNK_NAMES = {"qkv": "in_proj", "proj": "out_proj", "fc1": "c_fc",
                "fc2": "c_proj", "fc1_g": "w1", "fc1_x": "w2"}


def _jax_names(name: str) -> Tuple[str, str]:
    """(module, leaf) of a port parameter name in JAX's terms."""
    *mods, leaf = name.split(".")
    parent = mods[-1] if mods else ""
    if _TRUNK_BLOCK.match(name):
        parent = _TRUNK_NAMES.get(parent, parent)
    elif name.startswith("visual.head.mlp."):
        parent = "head_" + parent
    if parent == "in_proj":
        return parent, {"weight": "in_proj_kernel",
                        "bias": "in_proj_bias"}[leaf]
    if leaf == "in_proj_weight":
        return parent, "in_proj_kernel"
    if leaf in _SEPARATE_QKV:
        return leaf[:-len("_weight")], "kernel"
    return parent, "kernel" if leaf == "weight" else leaf


def tp_spec(name: str, shape) -> Optional[int]:
    """The dim of the port's parameter ``name`` sharded over the model
    axis (0 for a column-parallel weight or bias, 1 for a row-parallel
    weight), None for a replicated one: JAX's ``tp_spec`` on the same
    parameter, through the weight bridge's names."""
    if len(shape) == 0:
        return None
    parent, leaf = _jax_names(name)
    if leaf in ("in_proj_kernel", "in_proj_bias"):
        return 0
    if parent in _COL_KERNELS:
        if (leaf == "kernel" and len(shape) == 2) or leaf == "bias":
            return 0
    if parent in _ROW_KERNELS and leaf == "kernel" and len(shape) == 2:
        return 1
    return None


def tp_param_placements(model: nn.Module) -> Dict[str, Optional[int]]:
    """Parameter name -> ``tp_spec``."""
    return {n: tp_spec(n, p.shape) for n, p in model.named_parameters()}


# (parent class, child name) of the column-parallel layers whose consumer
# takes the feature-sharded DTensor: an elementwise activation and then the
# row-parallel projection, or the packed attention
def _keep_sharded(parent: nn.Module, child: str) -> bool:
    from ..models.timm_model import _Mlp
    from ..models.vit import TimmAttention, TimmMlp

    return ((isinstance(parent, Mlp) and child == "c_fc")
            or (isinstance(parent, (TimmMlp, _Mlp)) and child == "fc1")
            or (isinstance(parent, TimmAttention) and child == "qkv"))


def _distribute(module: nn.Module, name: str, mesh, placement) -> None:
    from torch.distributed.tensor import distribute_tensor

    p = getattr(module, name)
    d = nn.Parameter(distribute_tensor(p.detach(), mesh, [placement],
                                       src_data_rank=None),
                     requires_grad=p.requires_grad)
    setattr(module, name, d)


def _replicated_input(mesh) -> Callable:
    from torch.distributed.tensor import DTensor, Replicate

    def hook(module, args):
        x = args[0]
        if isinstance(x, DTensor):
            x = x.redistribute(mesh, [Replicate()])
        else:
            x = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        return (x, *args[1:])
    return hook


def _sharded_input(mesh) -> Callable:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    def hook(module, args):
        x = args[0]
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        return (x.redistribute(mesh, [Shard(x.ndim - 1)]), *args[1:])
    return hook


def _whole_output(module, args, out):
    return out.full_tensor()


def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Place ``model``'s parameters tensor-parallel over ``mesh``'s model
    axis (``tp_spec``), in place, and hook its parallel layers; returns
    ``model``.  Every rank must hold the same weights before the call (the
    local shards are cut from them without communication)."""
    from torch.distributed.tensor import Replicate, Shard

    sub = mesh[MODEL_AXIS] if MODEL_AXIS in (mesh.mesh_dim_names or ()) \
        else mesh
    parents = {}
    for pname, parent in model.named_modules():
        for cname, child in parent.named_children():
            parents[id(child)] = (parent, cname)
    for mname, module in model.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(module, MultiheadAttention):
            leaves = ("in_proj_bias",) + (
                _SEPARATE_QKV if module.in_proj_weight is None
                else ("in_proj_weight",))
            for leaf in leaves:
                if tp_spec(prefix + leaf, getattr(module, leaf).shape) == 0:
                    _distribute(module, leaf, sub, Shard(0))
        elif isinstance(module, Conv1D):
            for leaf in ("weight", "bias"):
                dim = tp_spec(prefix + leaf, getattr(module, leaf).shape)
                if dim is not None:
                    _distribute(module, leaf, sub, Shard(dim))
        elif isinstance(module, Linear):
            dim = tp_spec(prefix + "weight", module.weight.shape)
            if dim is None:
                continue
            if dim == 0:
                _distribute(module, "weight", sub, Shard(0))
                if module.bias is not None:
                    _distribute(module, "bias", sub, Shard(0))
                module.register_forward_pre_hook(_replicated_input(sub))
                parent, cname = parents.get(id(module), (None, ""))
                if parent is None or not _keep_sharded(parent, cname):
                    module.register_forward_hook(_whole_output)
            else:
                _distribute(module, "weight", sub, Shard(1))
                if module.bias is not None:
                    _distribute(module, "bias", sub, Replicate())
                module.register_forward_pre_hook(_sharded_input(sub))
                module.register_forward_hook(_whole_output)
    model.tp_mesh = sub
    return model


def make_tp_encoders(model: nn.Module, mesh
                     ) -> Tuple[nn.Module, Callable, Callable]:
    """(model, enc_image, enc_text): ``model`` placed tensor-parallel over
    the model axis (in place), and its normalised encoders over the global
    batch, which every rank passes whole: the batch, padded with zeros to a
    multiple of the data axis, is split over it, each model group encodes
    its block, and the blocks are all-gathered over the data axis and the
    padding sliced off.  The encoders take a CLIP's dict of features or
    CoCa's bare ones."""
    import torch.distributed as dist

    shard_params_tp(model, mesh)
    index, dp = batch_sharding(mesh)
    group = axis_group(mesh, DATA_AXIS)

    def _padded(fn: Callable) -> Callable:
        @torch.no_grad()
        def call(x: torch.Tensor) -> torch.Tensor:
            n = x.shape[0]
            pad = (-n) % dp
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            b = x.shape[0] // dp
            out = fn(x[index * b:(index + 1) * b]).contiguous()
            if dp > 1:
                parts = [torch.empty_like(out) for _ in range(dp)]
                dist.all_gather(parts, out, group=group)
                out = torch.cat(parts)
            return out[:n]
        return call

    def features(out, key: str) -> torch.Tensor:
        return out[key] if isinstance(out, dict) else out

    def enc_image(images: torch.Tensor) -> torch.Tensor:
        return features(model.encode_image(images, normalize=True),
                        "image_features")

    def enc_text(tokens: torch.Tensor) -> torch.Tensor:
        return features(model.encode_text(tokens, normalize=True),
                        "text_features")

    return model, _padded(enc_image), _padded(enc_text)
