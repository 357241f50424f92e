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
and so does this package's ``models/convert.py`` ``load_checkpoint``.  Every file is written to a
temporary name and then ``os.replace``d.  In a data-parallel run every rank
holds the same state, and the trainer saves from rank 0 alone.
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


def save_checkpoint(
    state,
    checkpoint_path: str,
    epoch: int,
    *,
    name: str = "",
    save_latest: bool = False,
    delete_previous: bool = False,
) -> str:
    """Write ``epoch_{epoch}.pt`` (and ``epoch_latest.pt`` when
    ``save_latest``); with ``delete_previous``, remove ``epoch_{epoch-1}.pt``.
    ``state`` is a ``train.TrainState``."""
    if "://" in str(checkpoint_path):
        raise ValueError(
            f"--checkpoint-path {checkpoint_path!r}: only local paths are "
            "ported; --remote-sync copies them to a remote")
    base = Path(checkpoint_path)
    base.mkdir(parents=True, exist_ok=True)
    ckpt = {
        "epoch": epoch,
        "name": name,
        "student": _cpu(state.student.state_dict()),
        "teacher": _cpu(state.teacher.state_dict()),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "num_updates": state.optimizer.num_updates,
    }
    path = checkpoint_file(checkpoint_path, epoch)
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
    state.student.load_state_dict(ckpt["student"], strict=True)
    state.teacher.load_state_dict(ckpt["teacher"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.optimizer.num_updates = int(ckpt["num_updates"])
    state.step = int(ckpt["step"])
    return int(ckpt["epoch"])
