"""Encoders for evaluation (part of ``cosmos_tpu/training/evaluate.py``)."""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch


def make_encoders(model: torch.nn.Module
                  ) -> Tuple[Callable, Callable, Callable]:
    """(normalised image encoder, normalised text encoder, raw text
    encoder).  Each takes a numpy array or tensor, moves it to the model's
    device and runs under ``torch.inference_mode``; features come back as
    tensors on that device."""
    device = next(model.parameters()).device

    def _run(method, normalize: bool, key: str):
        def call(x: Any) -> torch.Tensor:
            with torch.inference_mode():
                return method(torch.as_tensor(x, device=device),
                              normalize)[key]
        return call

    return (
        _run(model.encode_image, True, "image_features"),
        _run(model.encode_text, True, "text_features"),
        _run(model.encode_text, False, "text_features"),
    )
