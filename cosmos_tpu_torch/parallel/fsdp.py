"""FSDP / ZeRO-3 sharding of the parameters, gradients, Adam moments and
EMA teacher over the 'data' axis (counterpart of
``cosmos_tpu/parallel/fsdp.py``).

JAX places each leaf above a size threshold sharded over the data axis and
lets its partitioner derive the ZeRO collectives.  Here the same placement
goes to FSDP2's ``fully_shard``: once per residual block of each tower and
once at the root, each parameter sharded on the dim JAX's rule picks
(``shard_placement_fn``).  FSDP2 all-gathers a block's weights in front of
its forward and backward and reduce-scatters the gradients back to the
shards, averaged over the data axis; the optimizer and the EMA update run
on the local shards.

The leaves JAX leaves replicated (under ``FSDP_MIN_SIZE`` bytes-worth of
elements, 0-d, or with no evenly divisible dim) stay out of FSDP
(``ignored_params``): every rank holds them whole, and the train step
averages their gradients over the data axis as the data-parallel step
does.

On a ('data', 'model') mesh the placement composes with tensor
parallelism (``fsdp_tp_spec``): each parameter first takes its Megatron
placement on the model axis (``parallel/tp.py``), then the largest dim
that placement leaves free is sharded over the data axis, JAX's
``fsdp_tp_param_shardings``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from torch import nn

from .mesh import DATA_AXIS, MODEL_AXIS
from .tp import shard_params_tp, tp_spec

# leaves smaller than this stay replicated: sharding a 768-float LN scale
# saves nothing and costs a collective
FSDP_MIN_SIZE = 2 ** 16


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def fsdp_spec(shape: Sequence[int], n_shards: int,
              min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The dim of a leaf of ``shape`` sharded over the data axis: the
    largest evenly divisible one (the first of equal sizes), None for a
    leaf that stays replicated (0-d, under ``min_size`` elements, or with
    no divisible dim).  JAX's ``fsdp_spec``."""
    if len(shape) == 0 or _numel(shape) < min_size:
        return None
    for d in sorted(range(len(shape)), key=lambda d: shape[d], reverse=True):
        if shape[d] % n_shards == 0:
            return d
    return None


def fsdp_tp_spec(name: str, shape: Sequence[int], n_data: int, tp: int,
                 min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The data-axis dim of the port's parameter ``name`` on a
    ('data', 'model') mesh: the largest dim its tensor-parallel placement
    (``tp_spec``) leaves free and ``n_data`` divides, or None; the size
    test applies to the per-model-shard size.  JAX's ``fsdp_tp_spec``."""
    base = tp_spec(name, shape)
    per_shard = _numel(shape) // (tp if base is not None else 1)
    if len(shape) == 0 or per_shard < min_size:
        return None
    free = [d for d in range(len(shape)) if d != base]
    for d in sorted(free, key=lambda d: shape[d], reverse=True):
        if shape[d] % n_data == 0:
            return d
    return None


def _linear_weights(model: nn.Module) -> set:
    """ids of the 2-d weights JAX holds transposed: the ``[out, in]``
    Linear weights and in-projections, packed or separate, whose kernels
    are ``[in, out]``, and GPT-2's ``[in, out]`` Conv1D weights, whose
    Flax kernels are ``[out, in]``."""
    from ..models.attention import MultiheadAttention
    from ..models.hf_gpt2 import Conv1D
    from ..models.layers import Linear

    out = set()
    for m in model.modules():
        if isinstance(m, (Linear, Conv1D)):
            out.add(id(m.weight))
        elif isinstance(m, MultiheadAttention):
            if m.in_proj_weight is not None:
                out.add(id(m.in_proj_weight))
            else:
                out.update(id(w) for w in (m.q_proj_weight, m.k_proj_weight,
                                           m.v_proj_weight))
    return out


def fsdp_placements(model: nn.Module, n_data: int, tp: int = 1,
                    min_size: int = FSDP_MIN_SIZE
                    ) -> Dict[str, Optional[int]]:
    """Parameter name -> its data-axis dim (None: replicated), by JAX's
    rule on JAX's layout: a Linear weight's dims are taken in JAX's
    ``[in, out]`` order, so the same dim of the same tensor is split."""
    flip = _linear_weights(model)
    out = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        t = id(p) in flip and len(shape) == 2
        if tp > 1:
            d = fsdp_tp_spec(name, shape, n_data, tp, min_size)
            if t and d is not None and tp_spec(name, shape) is None:
                # no model-axis dim: JAX's layout decides, as below
                d = fsdp_spec(shape[::-1], n_data, min_size)
                d = None if d is None else 1 - d
        else:
            d = fsdp_spec(shape[::-1] if t else shape, n_data, min_size)
            if t and d is not None:
                d = 1 - d
        out[name] = d
    return out


def _blocks(model: nn.Module):
    """The residual blocks of every tower: the members of each
    ``resblocks``/``blocks`` list, of CoCa's decoder's ``cross_attn``, and
    an HF encoder's layers (BERT's ``encoder.layer``, DistilBERT's
    ``transformer.layer``, T5's ``encoder.block``; not the two sublayers of
    a T5 block, its ``layer``; ALBERT's layer groups, each run several
    times in a forward: FSDP2 gathers such a unit at every call and sums
    its gradients over the calls before it reduce-scatters them; GPT-2's
    ``h``, OPT's ``decoder.layers`` and the Llama family's ``layers``)."""
    from ..models.hf_albert import AlbertLayerGroup
    from ..models.hf_bert import BertLayer
    from ..models.hf_distilbert import TransformerBlock
    from ..models.hf_gpt2 import GPT2Block
    from ..models.hf_llama import LlamaDecoderLayer
    from ..models.hf_opt import OPTDecoderLayer
    from ..models.hf_t5 import T5Block

    for name, m in model.named_modules():
        if isinstance(m, (BertLayer, TransformerBlock, AlbertLayerGroup,
                          T5Block, GPT2Block, OPTDecoderLayer,
                          LlamaDecoderLayer)):
            yield m
        elif isinstance(m, nn.ModuleList) and name.split(".")[-1] in (
                "resblocks", "blocks", "cross_attn"):
            yield from m


def shard_params_fsdp(model: nn.Module, mesh,
                      min_size: int = FSDP_MIN_SIZE) -> nn.Module:
    """Shard ``model`` in place over ``mesh``'s data axis (and, on a
    ('data', 'model') mesh, tensor-parallel over its model axis first);
    returns it.  Every rank must hold the same weights before the call."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    names = mesh.mesh_dim_names
    tp = mesh[MODEL_AXIS].size() if MODEL_AXIS in names else 1
    data = mesh[DATA_AXIS] if len(names) > 1 else mesh
    if tp > 1:
        shard_params_tp(model, mesh)
    dims = fsdp_placements(model, data.size(), tp, min_size)
    by_id = {id(p): dims[n] for n, p in model.named_parameters()}
    ignored = {p for n, p in model.named_parameters() if dims[n] is None}
    kw = dict(mesh=data, ignored_params=ignored,
              shard_placement_fn=lambda p: Shard(by_id[id(p)]))
    for block in list(_blocks(model)):
        fully_shard(block, **kw)
    fully_shard(model, **kw)
    return model


def is_fsdp_managed(p) -> bool:
    """Whether FSDP shards ``p`` over the data axis (and so reduces its
    gradient)."""
    from torch.distributed.tensor import DTensor

    return isinstance(p, DTensor) and DATA_AXIS in (
        p.device_mesh.mesh_dim_names or ())
