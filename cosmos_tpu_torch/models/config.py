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
    # an int: the ViT's depth; a list of 4: ModifiedResNet's stage depths
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
    # a timm-family trunk with a pool and projection head (models/
    # timm_model.py); the other vision fields then do not apply
    timm_model_name: Optional[str] = None
    timm_pool: str = "avg"            # 'avg' | 'token'
    timm_proj: str = "linear"         # 'linear' | 'mlp' | 'none'
    timm_proj_bias: bool = False
    timm_drop: float = 0.0
    timm_drop_path: float = 0.0       # stochastic depth (ConvNeXt trunks)

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
    # an HF text tower (``models/hf_model.py``): ``hf_model_config`` is an
    # offline dict with ``model_type`` and the config's fields, or
    # ``hf_model_name`` a local directory (its config.json and weights);
    # ``hf_tokenizer_name`` a local tokenizer directory
    # (``data/hf_tokenizer.py``); hub names are refused (downloads)
    hf_model_name: Optional[str] = None
    hf_tokenizer_name: Optional[str] = None
    hf_model_pretrained: bool = True
    hf_proj_type: Optional[str] = None
    hf_pooler_type: Optional[str] = None
    hf_model_config: Optional[Dict[str, Any]] = None

    @property
    def is_hf(self) -> bool:
        return bool(self.hf_model_name or self.hf_model_config)

    @property
    def eot_truncation_exact(self) -> bool:
        """The gate for EOT-slicing this tower's text inputs.  Truncating a
        caption at >= eot+1 preserves its pooled feature iff attention is
        causal and pooling is argmax-EOT: HF towers, embed_cls towers and
        SigLIP-style towers (no_causal_mask / last-pool) must encode at
        full context.  The JAX package's gate, copied as it is: it reads
        ``hf_model_name`` only, so an HF tower given by ``hf_model_config``
        alone passes it there and here (``ROADMAP.md`` §3)."""
        return (not self.hf_model_name
                and not self.embed_cls
                and not self.no_causal_mask
                and self.pool_type == "argmax")


@dataclasses.dataclass
class MultimodalCfg:
    """CoCa's multimodal text decoder (``models/coca.py``)."""
    context_length: int = 76
    width: int = 512
    heads: int = 8
    layers: int = 12
    mlp_ratio: float = 4.0
    ls_init_value: Optional[float] = None
    attn_pooler_heads: int = 8


@dataclasses.dataclass
class CLIPCfg:
    embed_dim: int = 512
    vision_cfg: VisionCfg = dataclasses.field(default_factory=VisionCfg)
    text_cfg: TextCfg = dataclasses.field(default_factory=TextCfg)
    # set for a CoCa config, which create_model builds as models.coca.CoCa
    multimodal_cfg: Optional[MultimodalCfg] = None
    quick_gelu: bool = False
    init_logit_scale: float = 2.6592600175  # ln(1/0.07)
    init_logit_bias: Optional[float] = None
    custom_text: bool = False


def _filter_fields(cls, d: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: v for k, v in d.items() if k in names}


# configs registered at run time (``add_model_config``)
_EXTRA_CONFIGS: Dict[str, Dict[str, Any]] = {}


def list_models() -> list:
    names = {p.stem for p in _CONFIG_DIR.glob("*.json")}
    names.update(_EXTRA_CONFIGS)
    return sorted(names)


def add_model_config(path) -> None:
    """Register model config JSON file(s) at run time: a ``<name>.json``
    file or a directory of them."""
    p = Path(path)
    files = sorted(p.glob("*.json")) if p.is_dir() else [p]
    for f in files:
        with open(f) as fh:
            _EXTRA_CONFIGS[f.stem] = json.load(fh)


def get_model_config(name: str) -> Optional[Dict[str, Any]]:
    key = name.replace("/", "-")
    if key in _EXTRA_CONFIGS:
        return dict(_EXTRA_CONFIGS[key])
    path = _CONFIG_DIR / f"{key}.json"
    if not path.exists():
        return None
    with open(path) as f:
        return json.load(f)


def is_coca_config(name: str) -> bool:
    """Whether the registered config ``name`` is CoCa's: it has a
    ``multimodal_cfg``, and ``create_model`` builds it as ``CoCa``."""
    return bool((get_model_config(name) or {}).get("multimodal_cfg"))


def is_coca(model) -> bool:
    """Whether ``model`` was built from a CoCa config (see
    ``is_coca_config``)."""
    return getattr(getattr(model, "cfg", None), "multimodal_cfg",
                   None) is not None


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
    mm_d = raw.get("multimodal_cfg")
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
        multimodal_cfg=(
            MultimodalCfg(**_filter_fields(MultimodalCfg, mm_d)) if mm_d
            else None),
        quick_gelu=raw.get("quick_gelu", False),
        init_logit_scale=raw.get("init_logit_scale", CLIPCfg.init_logit_scale),
        init_logit_bias=raw.get("init_logit_bias"),
        custom_text=raw.get("custom_text", False),
    )
