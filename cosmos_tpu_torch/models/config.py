"""Model architecture configs (counterpart of ``cosmos_tpu/models/config.py``).

The JSON registry lives in ``configs/`` beside this file; ``build_clip_cfg``
keeps the JAX package's override semantics: ``attentional_pool``,
``add_zero_attn`` and ``output_all`` go to both towers, ``vision_*`` and
``text_*`` keys to one tower, anything else to the top level.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Optional

_CONFIG_DIR = Path(__file__).parent / "configs"


@dataclasses.dataclass
class VisionCfg:
    image_size: int = 224
    patch_size: int = 16
    width: int = 768
    layers: Any = 12
    head_width: int = 64
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    patch_dropout: float = 0.0
    attentional_pool: bool = False
    attn_pooler_queries: int = 256
    attn_pooler_heads: int = 8
    add_zero_attn: bool = False
    no_ln_pre: bool = False
    pos_embed_type: str = "learnable"
    final_ln_after_pool: bool = False
    pool_type: str = "tok"
    output_all: bool = False
    class_token: bool = True
    patch_bias: bool = False
    no_proj: bool = False
    timm_model_name: Optional[str] = None

    @property
    def heads(self) -> int:
        return self.width // self.head_width


@dataclasses.dataclass
class TextCfg:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    attentional_pool: bool = False
    attn_pooler_heads: int = 8
    add_zero_attn: bool = False
    embed_cls: bool = False
    pad_id: int = 0
    no_causal_mask: bool = False
    final_ln_after_pool: bool = False
    pool_type: str = "argmax"
    proj_bias: bool = False
    output_all: bool = False
    hf_model_name: Optional[str] = None

    @property
    def eot_truncation_exact(self) -> bool:
        """The gate for EOT-slicing this tower's text inputs.  Truncating a
        caption at >= eot+1 preserves its pooled feature iff attention is
        causal and pooling is argmax-EOT: HF towers, embed_cls towers and
        SigLIP-style towers (no_causal_mask / last-pool) must encode at
        full context."""
        return (not self.hf_model_name
                and not self.embed_cls
                and not self.no_causal_mask
                and self.pool_type == "argmax")


@dataclasses.dataclass
class CLIPCfg:
    embed_dim: int = 512
    vision_cfg: VisionCfg = dataclasses.field(default_factory=VisionCfg)
    text_cfg: TextCfg = dataclasses.field(default_factory=TextCfg)
    multimodal_cfg: Optional[Dict[str, Any]] = None
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592600175  # ln(1/0.07)
    init_logit_bias: Optional[float] = None
    custom_text: bool = False


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


def list_models() -> list:
    return sorted(p.stem for p in _CONFIG_DIR.glob("*.json"))


def get_model_config(name: str) -> Optional[Dict[str, Any]]:
    path = _CONFIG_DIR / f"{name.replace('/', '-')}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def build_clip_cfg(
    model_name: str,
    overrides: Optional[Dict[str, Any]] = None,
) -> CLIPCfg:
    """Load a named JSON config and apply runtime overrides."""
    raw = get_model_config(model_name)
    if raw is None:
        raise ValueError(
            f"Model config for {model_name} not found; available: {list_models()}"
        )
    raw = dict(raw)
    vision_d = dict(raw.get("vision_cfg", {}))
    text_d = dict(raw.get("text_cfg", {}))
    for key, val in (overrides or {}).items():
        if key in ("attentional_pool", "add_zero_attn", "output_all"):
            vision_d[key] = val
            text_d[key] = val
        elif key.startswith("vision_"):
            vision_d[key[len("vision_"):]] = val
        elif key.startswith("text_"):
            text_d[key[len("text_"):]] = val
        else:
            raw[key] = val
    return CLIPCfg(
        embed_dim=raw["embed_dim"],
        vision_cfg=VisionCfg(**_filter_fields(VisionCfg, vision_d)),
        text_cfg=TextCfg(**_filter_fields(TextCfg, text_d)),
        multimodal_cfg=raw.get("multimodal_cfg"),
        quick_gelu=raw.get("quick_gelu", False),
        init_logit_scale=raw.get("init_logit_scale", CLIPCfg.init_logit_scale),
        init_logit_bias=raw.get("init_logit_bias"),
        custom_text=raw.get("custom_text", False),
    )
