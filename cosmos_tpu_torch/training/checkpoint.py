"""Training checkpoints in the reference's ``.pt`` layout (counterpart of
``cosmos_tpu/training/checkpoint.py``, which writes Orbax directories
instead).

``<checkpoint_path>/epoch_{n}.pt`` holds ``{"epoch": n, "name": ...,
"student": state_dict, "teacher": state_dict, "optimizer":
optimizer.state_dict(), "step": ..., "num_updates": ...}``: the reference
trainer's dict, plus the two counts the schedules read (the teacher
momentum reads ``TrainState.step``, the LR ``ScheduledAdamW.num_updates``,
neither of which is in ``optimizer.state_dict()``), so a resumed run does
not restart its warm-up.  The state dicts carry every parameter
(``logit_bias`` of a SigLIP model among them); the optimizer's holds the
trainable parameters only (LiT-locked ones are not in the optimizer); the
frozen model of ``--distill-model`` is not in the file.  The JAX
package's ``models/checkpoint.py`` ``load_checkpoint`` reads these files,
and so does this package's ``models/checkpoint.py`` ``load_checkpoint``.  Every file is written to a
temporary name and then ``os.replace``d.  In a data-parallel run every rank
holds the same state, and the trainer saves from rank 0 alone.

A state sharded over a mesh (FSDP, tensor parallelism) is saved in the
same layout: every rank joins the gather of the whole state
(``host_state``, JAX's counterpart of that name; ``torch.distributed.
checkpoint``'s ``get_state_dict`` with ``full_state_dict``), and rank 0
writes it.  ``restore_checkpoint`` cuts a whole state into the shards of
the state it restores into (``set_state_dict``), so a checkpoint of any
mode resumes in any other.
"""

from __future__ import annotations

import logging
import os
import re
from pathlib import Path
from typing import Dict, Optional

import torch

logger = logging.getLogger(__name__)

LATEST_NAME = "epoch_latest.pt"
_EPOCH_FILE = re.compile(r"epoch_(\d+)\.pt")


def checkpoint_file(checkpoint_path: str, epoch: int) -> Path:
    return Path(checkpoint_path) / f"epoch_{epoch}.pt"


def _cpu(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in state_dict.items()}


def _atomic_save(obj, path: Path) -> None:
    tmp = path.with_name(path.name + ".tmp")
    torch.save(obj, tmp)
    os.replace(tmp, path)


def is_sharded(state) -> bool:
    """Whether any parameter of the state's student is a DTensor."""
    from torch.distributed.tensor import DTensor

    return any(isinstance(p, DTensor) for p in state.student.parameters())


def _whole_groups(groups, model) -> list:
    """Param groups (their ``params`` parameter names) merged back into
    the groups a sharded optimizer cut them from (``train.WHOLE_GROUP``),
    each in the model's parameter order, as the unsharded optimizer holds
    them."""
    from .train import WHOLE_GROUP

    pos = {n: i for i, (n, _) in enumerate(model.named_parameters())}
    whole = {}
    for i, g in enumerate(groups):
        w = whole.setdefault(g.get(WHOLE_GROUP, i), dict(
            {k: v for k, v in g.items() if k != WHOLE_GROUP}, params=[]))
        w["params"] += g["params"]
    return [dict(w, params=sorted(w["params"], key=pos.__getitem__))
            for _, w in sorted(whole.items())]


def _indexed(osd: Dict, model) -> Dict:
    """An optimizer state dict keyed by parameter name (``torch.
    distributed.checkpoint``'s) -> keyed by position in the whole groups,
    as the unsharded ``Optimizer.state_dict()`` keys it; the inverse of
    ``_named``."""
    groups = _whole_groups(osd["param_groups"], model)
    index = {n: i for i, n in enumerate(
        n for g in groups for n in g["params"])}
    return {"state": {index[n]: v for n, v in osd["state"].items()},
            "param_groups": [dict(g, params=[index[n] for n in g["params"]])
                             for g in groups]}


def _named(osd: Dict, optimizer, model) -> Dict:
    """The file's optimizer state dict -> keyed by parameter name, in
    ``optimizer``'s groups (settings from the whole group each was cut
    from)."""
    from .train import WHOLE_GROUP

    names = {id(p): n for n, p in model.named_parameters()}
    ours = [dict(g, params=[names[id(p)] for p in g["params"]])
            for g in optimizer.param_groups]
    order = [n for g in _whole_groups(ours, model) for n in g["params"]]
    saved = osd["param_groups"]
    return {"state": {order[i]: v for i, v in osd["state"].items()},
            "param_groups": [
                dict(saved[g.get(WHOLE_GROUP, i)], **{
                    k: v for k, v in g.items()
                    if k in ("params", WHOLE_GROUP)})
                for i, g in enumerate(ours)]}


def host_state(state, optimizer: bool = True) -> Dict:
    """The whole student, teacher and (with ``optimizer``) optimizer state
    of a sharded ``state`` on the CPU, in the file's layout.  A collective:
    every rank calls it at the same point; rank 0 gets the tensors, the
    others empty dicts."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_model_state_dict, get_state_dict)

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    out = {"teacher": get_model_state_dict(state.teacher, options=opts)}
    if optimizer:
        out["student"], osd = get_state_dict(state.student, state.optimizer,
                                             options=opts)
        out["optimizer"] = _indexed(osd, state.student) if osd else {}
    else:
        out["student"] = get_model_state_dict(state.student, options=opts)
    return out


def save_checkpoint(
    state,
    checkpoint_path: str,
    epoch: int,
    *,
    name: str = "",
    save_latest: bool = False,
    delete_previous: bool = False,
    write: bool = True,
) -> str:
    """Write ``epoch_{epoch}.pt`` (and ``epoch_latest.pt`` when
    ``save_latest``); with ``delete_previous``, remove ``epoch_{epoch-1}.pt``.
    ``state`` is a ``train.TrainState``.  A sharded state is gathered first
    (every rank calls this; only where ``write`` is set does one write)."""
    if "://" in str(checkpoint_path):
        raise ValueError(
            f"--checkpoint-path {checkpoint_path!r}: only local paths are "
            "ported; --remote-sync copies them to a remote")
    if is_sharded(state):
        whole = host_state(state)
    else:
        whole = {"student": _cpu(state.student.state_dict()),
                 "teacher": _cpu(state.teacher.state_dict()),
                 "optimizer": state.optimizer.state_dict()}
    path = checkpoint_file(checkpoint_path, epoch)
    if not write:
        return str(path)
    base = Path(checkpoint_path)
    base.mkdir(parents=True, exist_ok=True)
    ckpt = {
        "epoch": epoch,
        "name": name,
        **whole,
        "step": state.step,
        "num_updates": state.optimizer.num_updates,
    }
    _atomic_save(ckpt, path)
    if save_latest:
        _atomic_save(ckpt, base / LATEST_NAME)
    if delete_previous:
        prev = checkpoint_file(checkpoint_path, epoch - 1)
        if prev.exists():
            prev.unlink()
    logger.info(f"saved checkpoint {path}")
    return str(path)


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s.lower())]


def get_latest_checkpoint(checkpoint_path: str) -> Optional[str]:
    """``epoch_latest.pt`` if it exists, else the last ``epoch_{n}.pt`` in
    natural order (the reference's rule), else None."""
    base = Path(checkpoint_path)
    latest = base / LATEST_NAME
    if latest.exists():
        return str(latest)
    found = sorted((p.name for p in base.glob("epoch_*.pt")
                    if _EPOCH_FILE.fullmatch(p.name)), key=_natural_key)
    return str(base / found[-1]) if found else None


def restore_checkpoint(state, path: str) -> int:
    """Load student, teacher, optimizer and the schedules' counts into
    ``state`` (in place, on its devices); returns the completed-epoch count
    the file was saved at."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if is_sharded(state):
        from torch.distributed.checkpoint.state_dict import (
            StateDictOptions, set_model_state_dict, set_state_dict)

        opts = StateDictOptions(full_state_dict=True, strict=True)
        named = _named(ckpt["optimizer"], state.optimizer, state.student)
        set_state_dict(state.student, state.optimizer,
                       model_state_dict=ckpt["student"],
                       optim_state_dict=named, options=opts)
        set_model_state_dict(state.teacher, ckpt["teacher"], options=opts)
        # the groups' settings as the file holds them (the sharded load
        # turns the betas tuple into a list)
        for group, saved in zip(state.optimizer.param_groups,
                                named["param_groups"]):
            group.update({k: v for k, v in saved.items() if k != "params"})
    else:
        state.student.load_state_dict(ckpt["student"], strict=True)
        state.teacher.load_state_dict(ckpt["teacher"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
    state.optimizer.num_updates = int(ckpt["num_updates"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
