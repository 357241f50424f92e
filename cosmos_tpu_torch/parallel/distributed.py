"""The process group of data-parallel training (counterpart of
``cosmos_tpu/parallel/mesh.py``).

One process drives one card, as the rest of the port does.  JAX's step
runs under ``shard_map`` over the data axis of a device mesh; here each
rank runs the step on its own block of the global batch, and the losses
and the step reach the other ranks through ``torch.distributed``'s
default process group: NCCL on the card, gloo on the CPU.

The world comes from torchrun's environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from the JAX
trainer's three flags and their environment names
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``).  Without
either, nothing is initialised and every function below is the identity:
a one-process run takes no collective.  Under a process group, even one
of a single rank, the collectives run.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def _world(coordinator_address: Optional[str], num_processes: Optional[int],
           process_id: Optional[int]
           ) -> Optional[Tuple[str, int, int, Optional[int]]]:
    """(init method, rank, world size, local rank or None) of this process,
    or None without a world.  The JAX flags come first, then torchrun's
    environment, then the JAX flags' environment names."""
    env = os.environ
    if coordinator_address is None and "RANK" in env and "WORLD_SIZE" in env:
        return ("env://", int(env["RANK"]), int(env["WORLD_SIZE"]),
                int(env.get("LOCAL_RANK", env["RANK"])))
    coordinator_address = coordinator_address or env.get(
        "COORDINATOR_ADDRESS")
    if not coordinator_address:
        if (num_processes or 1) > 1 or process_id:
            raise ValueError(
                "--num-processes/--process-id need --coordinator-address "
                "(or run under torchrun)")
        return None
    if num_processes is None:
        num_processes = int(env.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(env.get("PROCESS_ID", "0"))
    return f"tcp://{coordinator_address}", process_id, num_processes, None


def init_distributed(device=None, coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     alone: bool = False) -> Tuple[int, int]:
    """Join the world this process was started in; returns (rank, world
    size), (0, 1) without a world.  ``device`` is the trainer's: None (the
    card) or ``"cpu"``.  On the card the rank takes ``cuda:LOCAL_RANK`` (or
    its rank modulo the cards of the host) and NCCL, whose failure to
    start raises; on the CPU, gloo.  ``backend`` overrides the choice (gloo
    over CUDA tensors where NCCL cannot run, as for two ranks on one
    card).  ``alone``: without a world, start a process group of this one
    rank (on an in-memory store), for the meshes that need one.  An
    existing process group is kept."""
    if is_initialized():
        return dist.get_rank(), dist.get_world_size()
    spec = _world(coordinator_address, num_processes, process_id)
    if spec is None and not alone:
        return 0, 1
    init_method, rank_, world, local = spec or (None, 0, 1, None)
    kind = "cuda" if device is None else torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    kwargs: Dict[str, Any] = {}
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        if local is None:
            local = rank_ % torch.cuda.device_count()
        torch.cuda.set_device(local)
        if backend == "nccl":
            # binding the device starts NCCL now, so a failure raises here
            kwargs["device_id"] = torch.device("cuda", local)
    if init_method is None:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = init_method
    dist.init_process_group(backend, rank=rank_, world_size=world, **kwargs)
    return rank_, world


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """``src``'s picklable ``obj`` on every rank (the reference's
    ``broadcast_object``): where each rank must agree on a choice made from
    the file system, such as the checkpoint ``--resume latest`` names."""
    if not is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src)
    return box[0]


@torch.no_grad()
def _flat_collective(tensors: Sequence[torch.Tensor],
                     collective: Callable[[torch.Tensor], None],
                     group=None) -> None:
    """``collective`` over one flat buffer per dtype, copied back into
    ``tensors`` in place.  Under NCCL the buffer lives on this rank's card
    whatever the tensors' devices."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    nccl = dist.get_backend(group) == "nccl"
    for group in groups.values():
        dev = group[0].device
        if nccl and dev.type != "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        flat = torch.cat([t.reshape(-1).to(dev) for t in group])
        collective(flat)
        for t, part in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(part.view_as(t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Average floating-point ``tensors`` across the ranks of ``group``
    (the default group when None) in place (JAX's ``pmean``: the sum, then
    divided by the group's size), one collective per dtype."""
    if not is_initialized() or not tensors:
        return
    world = dist.get_world_size(group)

    def mean(flat: torch.Tensor) -> None:
        dist.all_reduce(flat, group=group)
        flat.div_(world)

    _flat_collective(tensors, mean, group)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0) -> None:
    """``src``'s values of ``tensors`` on every rank, in place, one
    collective per dtype."""
    if not is_initialized() or not tensors:
        return
    _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))


def barrier() -> None:
    if is_initialized():
        dist.barrier()


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()
