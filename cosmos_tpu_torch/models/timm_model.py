"""The timm-family vision tower (counterpart of
``cosmos_tpu/models/timm_model.py:41-248``): a trunk (the timm ViT, EVA02,
ConvNeXt or FastViT/MCi) and OpenCLIP's pool/projection head, selected by
the config's ``timm_*`` fields.

Names are OpenCLIP's ``TimmModel``: ``trunk.<the trunk's names>`` and
``head.proj`` (``linear``) or ``head.mlp.fc1/fc2`` (``mlp``); ``none`` has
no head.  The refusals are the JAX package's: CSA, ``token`` pooling on the
trunks without a CLS token, head dropout, and stochastic depth on every
trunk but ConvNeXt.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .convert import cvnets_block, np_, rename_
from .convnext import CONVNEXT_CONFIGS, ConvNeXt
from .eva import EVA_CONFIGS, Eva
from .fastvit import FASTVIT_CONFIGS, FastVit
from .layers import Linear, gelu
from .vit import TimmVisionTransformer

# timm model name -> trunk geometry (the JAX package's TIMM_VIT_CONFIGS)
TIMM_VIT_CONFIGS: Dict[str, Dict] = {
    "vit_small_patch16_224": dict(patch_size=16, width=384, layers=12, heads=6),
    "vit_small_patch32_224": dict(patch_size=32, width=384, layers=12, heads=6),
    "vit_base_patch16_224": dict(patch_size=16, width=768, layers=12, heads=12),
    "vit_base_patch32_224": dict(patch_size=32, width=768, layers=12, heads=12),
    "vit_base_patch16_384": dict(patch_size=16, width=768, layers=12, heads=12,
                                 image_size=384),
    "vit_large_patch16_224": dict(patch_size=16, width=1024, layers=24, heads=16),
    "vit_large_patch14_224": dict(patch_size=14, width=1024, layers=24, heads=16),
    "vit_huge_patch14_224": dict(patch_size=14, width=1280, layers=32, heads=16),
    # MobileCLIP-B's image tower: ViT-B/16 with the MCi conv stem and a
    # patch-only position table added before the CLS token
    "vit_base_mci_224": dict(
        patch_size=16, width=768, layers=12, heads=12,
        stem_channels=(192, 384, 768), stem_kernels=(4, 2, 2),
        no_embed_class=True),
}


def register_timm_vit(name: str, *, patch_size: int, width: int, layers: int,
                      heads: int, image_size: int = 224,
                      stem_channels=None, stem_kernels=(4, 2, 2),
                      no_embed_class: bool = False) -> None:
    """Register another plain or MCi-stem timm ViT geometry."""
    TIMM_VIT_CONFIGS[name] = dict(
        patch_size=patch_size, width=width, layers=layers, heads=heads,
        image_size=image_size, no_embed_class=no_embed_class)
    if stem_channels is not None:
        TIMM_VIT_CONFIGS[name].update(stem_channels=tuple(stem_channels),
                                      stem_kernels=tuple(stem_kernels))


class _LinearHead(nn.Module):
    def __init__(self, width: int, embed_dim: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.proj = Linear(width, embed_dim, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class _Mlp(nn.Module):
    def __init__(self, width: int, embed_dim: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.fc1 = Linear(width, 2 * embed_dim, dtype=dtype)
        self.fc2 = Linear(2 * embed_dim, embed_dim, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


class _MlpHead(nn.Module):
    """OpenCLIP's ``Mlp(width, 2 embed_dim, embed_dim)`` head."""

    def __init__(self, width: int, embed_dim: int, bias: bool,
                 dtype: torch.dtype):
        super().__init__()
        self.mlp = _Mlp(width, embed_dim, bias, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class TimmModel(nn.Module):
    """A timm trunk and its pool/projection head: ``(pooled [B, embed_dim],
    tokens [B, N, width])`` like the other vision towers."""

    def __init__(self, model_name: str, embed_dim: int,
                 image_size: int = 224, pool: str = "avg",
                 proj: str = "linear", proj_bias: bool = False,
                 drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32,
                 use_flash: Optional[bool] = None, remat: bool = False,
                 remat_policy: str = ""):
        super().__init__()
        known = (TIMM_VIT_CONFIGS, CONVNEXT_CONFIGS, EVA_CONFIGS,
                 FASTVIT_CONFIGS)
        if not any(model_name in c for c in known):
            raise NotImplementedError(
                f"timm trunk {model_name!r}: plain ViTs "
                f"({sorted(TIMM_VIT_CONFIGS)}), the ConvNeXt family "
                f"({sorted(CONVNEXT_CONFIGS)}), the EVA02 family "
                f"({sorted(EVA_CONFIGS)}) and the FastViT/MCi family "
                f"({sorted(FASTVIT_CONFIGS)}) are ported; register other "
                "geometries with register_timm_vit / register_convnext / "
                "register_eva / register_fastvit")
        if pool not in ("avg", "token", ""):
            raise ValueError(f"timm_pool {pool!r}: use 'avg' or 'token'")
        if drop:
            raise NotImplementedError(
                "timm_drop (head dropout) is not wired into the head; pass "
                "timm_drop=0, as the released CLIP configs do")
        self.patch_dropout = 0.0
        blocks = dict(dtype=dtype, remat=remat, remat_policy=remat_policy)
        if model_name in CONVNEXT_CONFIGS:
            if pool == "token":
                raise ValueError(
                    "timm_pool 'token': ConvNeXt has no CLS token; use "
                    "'avg' (the global average pool and head norm)")
            self.trunk = ConvNeXt(model_name, drop_path_rate=drop_path,
                                  **blocks)
        elif model_name in FASTVIT_CONFIGS:
            if pool == "token":
                raise ValueError(
                    "timm_pool 'token': FastViT/MCi has no CLS token; use "
                    "'avg' (conv_exp and the global average pool)")
            if drop_path:
                raise NotImplementedError(
                    "timm_drop_path on a FastViT trunk is not wired; the "
                    "deploy-form trunk is for inference and fine-tuning")
            self.trunk = FastVit(model_name, **blocks)
        elif model_name in EVA_CONFIGS:
            if drop_path:
                raise NotImplementedError(
                    "timm_drop_path on an EVA02 trunk is not wired; the "
                    "released EVA02-CLIP towers fine-tune with drop_path=0")
            self.trunk = Eva(model_name,
                             pool="avg" if pool == "avg" else "token",
                             **blocks)
        else:
            if drop_path:
                raise NotImplementedError(
                    "timm_drop_path on a plain-ViT trunk is not wired; the "
                    "released ViT CLIP recipes train with drop_path=0")
            g = TIMM_VIT_CONFIGS[model_name]
            self.trunk = TimmVisionTransformer(
                image_size=g.get("image_size", image_size),
                patch_size=g["patch_size"], width=g["width"],
                layers=g["layers"], num_heads=g["heads"],
                stem_channels=g.get("stem_channels"),
                stem_kernels=g.get("stem_kernels", (4, 2, 2)),
                no_embed_class=g.get("no_embed_class", False),
                pool_type="avg" if pool == "avg" else "tok",
                use_flash=use_flash, **blocks)
        width = self.trunk.num_features
        if proj == "linear":
            self.head = _LinearHead(width, embed_dim, proj_bias, dtype)
        elif proj == "mlp":
            self.head = _MlpHead(width, embed_dim, proj_bias, dtype)
        elif proj in ("none", ""):
            self.head = None
        else:
            raise ValueError(f"timm_proj {proj!r}")

    def forward(self, images: torch.Tensor, csa: bool = False,
                patch_drop=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """``patch_drop`` is taken and ignored, as JAX's adapter ignores
        its patch-dropout rng."""
        if csa:
            raise NotImplementedError(
                "CSA segmentation needs the CLIP ViT tower")
        pooled, tokens = self.trunk(images)
        if self.head is not None:
            pooled = self.head(pooled)
        return pooled, tokens


# --- timm checkpoint conversion (cosmos_tpu/models/timm_model.py:253-417) --
#
# The trunk's names are timm's, so a bare timm state dict loads by name;
# what is left is finding the geometry and reshaping two leaves.

def infer_timm_vit_name(sd: Dict) -> str:
    """Match a timm ViT state dict to a registered geometry by its shapes."""
    w = int(sd["cls_token"].reshape(-1).shape[0])
    p = int(sd["patch_embed.proj.weight"].shape[-1])
    layers = 1 + max(int(k.split(".")[1]) for k in sd
                     if k.startswith("blocks."))
    for name, g in TIMM_VIT_CONFIGS.items():
        if "stem_channels" in g:
            continue    # MCi-stem hybrids have no patch_embed.proj
        if g["width"] == w and g["patch_size"] == p and g["layers"] == layers:
            return name
    raise KeyError(
        f"no registered timm ViT geometry matches width={w} patch={p} "
        f"layers={layers}; add one via register_timm_vit"
    )


_VIT_BLOCK_KEYS = ("norm1.weight", "norm1.bias", "attn.qkv.weight",
                   "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
                   "norm2.weight", "norm2.bias", "mlp.fc1.weight",
                   "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias")


def convert_timm_vit(sd: Dict, model_name: str) -> Dict[str, torch.Tensor]:
    """A timm ViT state dict as the trunk's state dict (names below
    ``visual.trunk.``); an in1k classifier head is dropped, a CLIP
    projection head is loaded by ``convert._maybe_load_timm_head``."""
    g = TIMM_VIT_CONFIGS[model_name]
    w = g["width"]
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias",
            "norm.weight", "norm.bias"]
    keys += [f"blocks.{i}.{k}" for i in range(g["layers"])
             for k in _VIT_BLOCK_KEYS]
    out = rename_(sd, [(k, k) for k in keys])
    out["cls_token"] = torch.as_tensor(sd["cls_token"]).reshape(1, 1, w)
    out["pos_embed"] = torch.as_tensor(sd["pos_embed"]).reshape(1, -1, w)
    return out


def infer_mci_vit_name(sd: Dict, prefix: str = "") -> str:
    """Match an Apple hybrid-ViT (CVNets) state dict to a registered
    MCi-stem geometry by width and block count."""
    w = int(sd[f"{prefix}cls_token"].reshape(-1).shape[0])
    head = f"{prefix}transformer."
    layers = 1 + max(
        int(k[len(head):].split(".")[0]) for k in sd
        if k.startswith(head) and ".pre_norm_mha." in k
    )
    for name, g in TIMM_VIT_CONFIGS.items():
        if "stem_channels" in g and g["width"] == w and g["layers"] == layers:
            return name
    raise KeyError(
        f"no registered MCi-stem ViT geometry matches width={w} "
        f"layers={layers}; add one via register_timm_vit(stem_channels=...)"
    )


def convert_mobileclip_vit(sd: Dict, model_name: str, prefix: str = ""
                           ) -> Dict[str, torch.Tensor]:
    """Apple MobileCLIP-B's hybrid-ViT image trunk (CVNets layout, its conv
    stem in train form with BatchNorm) as the trunk's state dict, the stem's
    BatchNorms folded into the convs (``fastvit._fuse_conv_bn``)."""
    from .fastvit import _fuse_conv_bn

    g = TIMM_VIT_CONFIGS[model_name]
    w = g["width"]
    stem_ch = (3,) + tuple(g["stem_channels"])
    out: Dict[str, torch.Tensor] = {}
    for i, _k in enumerate(g.get("stem_kernels", (4, 2, 2))):
        p = f"{prefix}patch_emb.{i}.block"
        if f"{p}.norm.weight" in sd:
            wt, bias = _fuse_conv_bn(sd, p, norm="norm")
        else:
            wt = np_(sd[f"{p}.conv.weight"])      # OIHW
            bias = np_(sd[f"{p}.conv.bias"])
        if wt.shape[0] != stem_ch[i + 1] or wt.shape[1] != stem_ch[i]:
            raise ValueError(
                f"MobileCLIP-B stem conv {i}: expected "
                f"[{stem_ch[i + 1]},{stem_ch[i]},k,k], got {wt.shape} — "
                f"geometry mismatch with {model_name}")
        out[f"stem{i}.weight"] = torch.from_numpy(np.ascontiguousarray(wt))
        out[f"stem{i}.bias"] = torch.from_numpy(np.ascontiguousarray(bias))
    out["cls_token"] = torch.as_tensor(sd[f"{prefix}cls_token"]).reshape(
        1, 1, w)
    pe = None
    for k in ("pos_embed.pos_embed.pos_embed", "pos_embed.pos_embed",
              "pos_embed"):
        if f"{prefix}{k}" in sd:
            pe = torch.as_tensor(sd[f"{prefix}{k}"]).reshape(-1, w)
            break
    if pe is None:
        raise KeyError(
            "MobileCLIP-B positional embedding not found "
            f"({prefix}pos_embed[.pos_embed[.pos_embed]])")
    grid = g.get("image_size", 224) // g["patch_size"]
    if pe.shape[0] != grid * grid:
        raise ValueError(
            f"MobileCLIP-B pos embed has {pe.shape[0]} rows; expected a "
            f"patch-only table of {grid * grid} (CVNets ViT adds the pos "
            "embed before the CLS token — a row for CLS means a different "
            "tower variant)")
    out["pos_embed"] = pe[None]
    for i in range(g["layers"]):
        b = f"{prefix}transformer.{i}"
        if f"{b}.pre_norm_mha.0.weight" not in sd:
            raise KeyError(
                f"MobileCLIP-B transformer block {i} not found under "
                f"{b}.pre_norm_mha.* — trunk has fewer blocks than "
                f"{model_name} expects")
        out.update(cvnets_block(sd, b, f"blocks.{i}"))
    out.update(rename_(sd, [
        ("norm.weight", f"{prefix}post_transformer_norm.weight"),
        ("norm.bias", f"{prefix}post_transformer_norm.bias")]))
    return out
