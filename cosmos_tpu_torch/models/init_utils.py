"""Parameter re-initialisation (counterpart of
``cosmos_tpu/models/init_utils.py``).

``--init-last-layer`` redraws the LAST transformer block of both towers
with OpenCLIP's init stds: the packed in-projection N(0, w^-0.5), the
attention out-projection and c_proj N(0, w^-0.5 (2L)^-0.5), c_fc
N(0, (2w)^-0.5); biases and LayerNorms stay.  The reference calls it on
the student and on the teacher apart, so each gets its own draw: pass each
its own generator.
"""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def reinit_last_transformer_layer(model: nn.Module,
                                  generator: torch.Generator) -> None:
    """Redraw, in place, the last block of the vision tower
    (``visual.transformer``) and of the text tower (``transformer``), in
    that order, from ``generator`` (a CPU generator: the same draw on every
    device)."""
    if not hasattr(model.visual, "transformer"):
        # the JAX package's fails on these trees too (no visual/transformer)
        raise ValueError("--init-last-layer needs the native ViT image "
                         "tower; this tower has no transformer blocks")
    if getattr(model, "text_cfg", None) is not None and model.text_cfg.is_hf:
        # nor has an HF tower's tree a text/transformer in JAX's
        raise ValueError("--init-last-layer needs the native text tower; "
                         "an HF text tower has no resblocks")
    for tower in (model.visual.transformer, model.transformer):
        blocks = tower.resblocks
        block = blocks[-1]
        width = block.attn.dim
        proj_std = width ** -0.5 * (2 * len(blocks)) ** -0.5
        for weight, std in ((block.attn.in_proj_weight, width ** -0.5),
                            (block.attn.out_proj.weight, proj_std),
                            (block.mlp.c_fc.weight, (2 * width) ** -0.5),
                            (block.mlp.c_proj.weight, proj_std)):
            draw = torch.randn(weight.shape, generator=generator) * std
            weight.copy_(draw.to(weight.device, weight.dtype))
