"""OpenAI CLIP checkpoints (counterpart of ``cosmos_tpu/models/openai.py``):
the architecture read from the state dict's shapes (a ViT or a
ModifiedResNet, widths, depths, context length, vocabulary) and the
weights loaded into a QuickGELU model.
"""

from __future__ import annotations

import logging
import re
from typing import Any, Dict, List, Union

import torch

logger = logging.getLogger(__name__)


def config_from_openai_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A model config dict inferred from an OpenAI/OpenCLIP state dict."""
    shape = lambda k: tuple(sd[k].shape)  # noqa: E731
    if "visual.proj" in sd:
        vision_width, _, _, patch_size = shape("visual.conv1.weight")
        vision_layers = len([k for k in sd if re.fullmatch(
            r"visual\.transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)])
        grid = int((shape("visual.positional_embedding")[0] - 1) ** 0.5)
        vision_cfg = {
            "image_size": int(grid * patch_size),
            "patch_size": int(patch_size),
            "width": int(vision_width),
            "layers": int(vision_layers),
            "head_width": 64 if vision_width % 64 == 0 else int(vision_width),
        }
    else:
        # ModifiedResNet: blocks per stage, stem width, attnpool grid
        counts = [len({k.split(".")[2] for k in sd
                       if k.startswith(f"visual.layer{b}.")})
                  for b in (1, 2, 3, 4)]
        output_width = int(round(
            (shape("visual.attnpool.positional_embedding")[0] - 1) ** 0.5))
        vision_cfg = {
            "image_size": int(output_width * 32),
            "width": int(shape("visual.layer1.0.conv1.weight")[0]),
            "layers": tuple(int(c) for c in counts),
        }
    text_width = shape("ln_final.weight")[0]
    text_layers = len([k for k in sd if re.fullmatch(
        r"transformer\.resblocks\.\d+\.attn\.in_proj_weight", k)])
    return {
        "embed_dim": int(shape("text_projection")[1]),
        "quick_gelu": True,  # OpenAI models use QuickGELU
        "vision_cfg": vision_cfg,
        "text_cfg": {
            "context_length": int(shape("positional_embedding")[0]),
            "vocab_size": int(shape("token_embedding.weight")[0]),
            "width": int(text_width),
            "heads": int(max(1, text_width // 64)),
            "layers": int(text_layers),
        },
    }


def list_openai_models() -> List[str]:
    """Model names with an ``openai`` pretrained tag."""
    from .pretrained import list_pretrained_models_by_tag

    return list_pretrained_models_by_tag("openai")


def load_openai_model(path: str, precision: str = "fp32", *,
                      device: Union[str, torch.device, None] = None):
    """An OpenAI release (a TorchScript archive or a plain state dict) as a
    QuickGELU ``CLIP`` on ``device`` (the card unless ``"cpu"``), its
    weights in float32 (the releases store float16) and ``precision`` the
    compute dtype.  The JAX package returns ``(model, params)``; here the
    module holds its weights."""
    from .checkpoint import read_checkpoint, torch_state_dict_to_model
    from .clip import CLIP
    from .config import CLIPCfg, TextCfg, VisionCfg, _filter_fields
    from .factory import init_weights, resolve_device, resolve_dtype

    dev = resolve_device(device)
    sd = read_checkpoint(path)
    raw = config_from_openai_state_dict(sd)
    cfg = CLIPCfg(
        embed_dim=raw["embed_dim"],
        vision_cfg=VisionCfg(**_filter_fields(VisionCfg, raw["vision_cfg"])),
        text_cfg=TextCfg(**_filter_fields(TextCfg, raw["text_cfg"])),
        quick_gelu=True,
    )
    with torch.device("cpu"):
        model = CLIP(cfg, dtype=resolve_dtype(precision))
    init_weights(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.load_state_dict(torch_state_dict_to_model(model, sd),
                              strict=True)
    return model.to(dev).eval()
