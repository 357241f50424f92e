"""Device meshes over the ranks of a process group (counterpart of the
mesh half of ``cosmos_tpu/parallel/mesh.py`` and of
``cosmos_tpu/parallel/tp.py`` ``create_tp_mesh``).

One process drives one card, so a mesh position is a rank.  Three shapes,
built with ``torch.distributed.device_mesh.init_device_mesh`` over every
rank of the default process group:

  - ``("data",)``: data parallelism (and FSDP over it);
  - ``("data", "model")``: ``dp`` model groups of ``tp`` ranks each, for
    tensor parallelism (``parallel/tp.py``);
  - ``("slice", "data")``: the multislice factoring, ``n_slices`` slices of
    ``per_slice`` ranks, for the hierarchical gather of the contrastive
    losses.

The order is positional, rank ``r`` at ``divmod(r, minor size)``: ranks of
one model group (or of one slice) are consecutive.  JAX orders its devices
by the torus topology (``mesh_utils``); one host of cards has no such
topology to follow.  The mesh's sub-groups (``mesh.get_group(name)``) carry
the collectives of each axis; the device type is the trainer's, ``cuda``
(NCCL, or gloo over CUDA tensors) or ``cpu`` (gloo).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch.distributed as dist

DATA_AXIS = "data"
# multislice: the leading mesh axis that crosses slices; DATA_AXIS is then
# the axis within each slice
SLICE_AXIS = "slice"
MODEL_AXIS = "model"


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _init(device_type: str, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh

    n = 1
    for s in shape:
        n *= s
    if n != _world():
        raise ValueError(
            f"mesh {'x'.join(map(str, shape))} needs {n} devices, have "
            f"{_world()} (the port's mesh spans every rank, one a card)")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh axes the batch dim shards over: ('slice', 'data') on a
    multislice mesh, ('data',) otherwise."""
    names = mesh.mesh_dim_names
    return (SLICE_AXIS, DATA_AXIS) if SLICE_AXIS in names else (DATA_AXIS,)


def create_mesh(num_devices: Optional[int] = None,
                device_type: str = "cuda"):
    """1-D data mesh over all ranks (``num_devices``, when given, must be
    their number)."""
    n = _world() if num_devices is None else num_devices
    return _init(device_type, (n,), (DATA_AXIS,))


def create_tp_mesh(dp: int, tp: int, device_type: str = "cuda"):
    """(dp, tp) mesh with axes ('data', 'model')."""
    if dp * tp > _world():
        raise ValueError(
            f"mesh {dp}x{tp} needs {dp * tp} devices, have {_world()}")
    return _init(device_type, (dp, tp), (DATA_AXIS, MODEL_AXIS))


def create_multislice_mesh(n_slices: int, per_slice: Optional[int] = None,
                           device_type: str = "cuda"):
    """('slice', 'data') mesh factoring the ranks by slice."""
    world = _world()
    if per_slice is None:
        if world % n_slices:
            raise ValueError(
                f"{world} devices do not factor into {n_slices} slices")
        per_slice = world // n_slices
    if n_slices * per_slice > world:
        raise ValueError(
            f"mesh {n_slices}x{per_slice} needs {n_slices * per_slice} "
            f"devices, have {world}")
    return _init(device_type, (n_slices, per_slice), (SLICE_AXIS, DATA_AXIS))


def batch_sharding(mesh) -> Tuple[int, int]:
    """(index, count) of this rank's block of the global batch: its
    position on the data axes (slice-major on a multislice mesh).  The
    ranks of one model group share a block."""
    index, count = 0, 1
    for name in data_axes(mesh):
        size = mesh.size(mesh.mesh_dim_names.index(name))
        index = index * size + mesh.get_local_rank(name)
        count *= size
    return index, count


def axis_group(mesh, name: str):
    """The process group of this rank along ``name``, None when the mesh
    has no such axis."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return None
    return mesh.get_group(name)
