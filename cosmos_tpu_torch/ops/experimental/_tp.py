"""Tensor-parallel plumbing shared by K5's and K6's wrappers.

Under tensor parallelism (``parallel/tp.py``) a fused block hands its
DTensor weights straight to the wrappers, with no ``Linear`` and so no
hook in between.  The wrappers then run each kernel through its operator's
DTensor rule on the rank's local shard, and do the model axis's one
reduction themselves: the helpers here wrap the replicated inputs, read
the local shards and sum float32 partials over the model group.
"""

from __future__ import annotations

from typing import List

import torch


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local tensor; any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def replicated(t: torch.Tensor, mesh) -> torch.Tensor:
    """A whole local tensor, the same on every rank, as a replicated
    DTensor on ``mesh`` (no communication)."""
    from torch.distributed.tensor import DTensor, Replicate

    return DTensor.from_local(t.contiguous(), mesh, [Replicate()],
                              run_check=False)


def like(t: torch.Tensor, param: torch.Tensor) -> torch.Tensor:
    """``t``, this rank's part of ``param``'s gradient, placed as
    ``param`` is (``t`` as it is where ``param`` is no DTensor)."""
    from torch.distributed.tensor import DTensor

    if not is_dtensor(param):
        return t
    return DTensor.from_local(t, param.device_mesh, param.placements,
                              run_check=False, shape=param.shape,
                              stride=param.stride())


def local_columns(grad: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the last dim of ``grad`` (a DTensor of any
    placement on ``mesh``, or a whole local tensor)."""
    from torch.distributed.tensor import Shard

    if is_dtensor(grad):
        return grad.redistribute(mesh, [Shard(grad.ndim - 1)]).to_local()
    n, i = mesh.size(), mesh.get_local_rank()
    return grad.chunk(n, dim=-1)[i]


def sum_over(mesh, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The sums over ``mesh``'s group of float32 ``tensors`` that each
    rank holds a partial of, in one all-reduce."""
    import torch.distributed as dist

    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.get_group())
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return out
