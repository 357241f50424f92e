"""EOT truncation of caption batches (part of
``cosmos_tpu/training/zero_shot.py``; the prompt-bank classifier and the
tokenizer come with the data slice)."""

from __future__ import annotations

from typing import Any


def supports_eot_truncation(model) -> bool:
    """True when the model's text tower is the native causal + argmax-EOT
    one, for which ``truncate_to_eot`` is exact."""
    tcfg = getattr(getattr(model, "cfg", None), "text_cfg", None)
    return bool(tcfg is not None
                and getattr(tcfg, "eot_truncation_exact", False))


def truncate_to_eot(tokens: Any, multiple: int = 16) -> Any:
    """Slice a padded [N, L] token batch (numpy array or tensor) at
    max(eot)+1, rounded up to ``multiple``.

    Exact for causal + argmax-EOT towers: positions <= eot attend only to
    positions <= eot, and truncation at >= eot+1 keeps the argmax-EOT pool
    position."""
    l_eff = int(tokens.argmax(-1).max()) + 1
    l_eff = min(-(-l_eff // multiple) * multiple, tokens.shape[1])
    return tokens[:, :l_eff]
