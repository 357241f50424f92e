"""CLIP dual encoder with the COSMOS cross-modality heads (counterpart of
``cosmos_tpu/models/clip.py``).

Feature layout is views-major, as in the JAX package: V views of batch B
are ``[V*B, ...]`` with view v at rows ``[v*B, (v+1)*B)``.

``text_bucket > 0`` turns on the length-bucketed text tower of the COSMOS
training forward (``_bucketed_text_pooled``); ``fuse_ln=True`` runs the
towers' blocks with their pre-LayerNorms fused into the QKV projection (K5)
and the MLP (K6); ``remat`` recomputes each block in the backward
(``remat_policy`` names what it keeps, ``transformer.REMAT_POLICIES``);
``use_flash=False`` keeps every self-attention off K1 and K2.  A config with
``init_logit_bias`` (SigLIP) has ``logit_bias``; one with
``vision_cfg.patch_dropout > 0`` drops patch tokens in the forwards that
pass a ``patch_drop`` generator (the student's training forwards).

The vision tower is the native ViT (any configuration of the JAX
package's: SigLIP's no-CLS, MAP-pooled, unprojected tower among them), a
timm-family tower (``timm_model_name``:
the timm ViT, EVA02, ConvNeXt or FastViT/MCi, ``models/timm_model.py``) or
ModifiedResNet (list-valued ``layers``), dispatched as the JAX package
dispatches them.  The last two take plain CLIP/SigLIP only: the COSMOS
heads need the native ViT's cross-attention pooler.

The text tower is the native one, whose parts sit at the model's top level
as in OpenCLIP's CLIP (``models/text.py``), or, for a ``text_cfg`` with
``hf_model_config``, an HF encoder under ``text`` (``models/hf_model.py``;
OpenCLIP's ``CustomTextCLIP`` names, ``text.transformer.*`` and
``text.proj.*``), which takes plain CLIP/SigLIP only: it has no
cross-attention pooler for the COSMOS heads.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .attention import AttentionalCrossPooler
from .config import CLIPCfg
from .hf_model import build_hf_text_tower
from .layers import Linear, get_act_fn, l2_normalize
from .modified_resnet import ModifiedResNet
from .text import add_text_tower, encode_tokens, init_text_tower
from .timm_model import TimmModel
from .vit import VisionTransformer


class CLIP(nn.Module):
    """``cosmos=True`` adds ``distill_logit_scale``; ``output_all`` adds the
    token mappings; the two cross poolers (``visual.attn_cross_pool``,
    ``text_attn_cross_pool``) exist with cosmos, output_all and
    attentional_pool together, the case in which the JAX package's
    cross-modal forward creates them."""

    def __init__(self, cfg: CLIPCfg, cosmos: bool = False,
                 dtype: torch.dtype = torch.float32, act_approx: bool = False,
                 text_bucket: int = 0, fuse_ln: bool = False,
                 remat: bool = False, remat_policy: str = "",
                 use_flash: Optional[bool] = None):
        super().__init__()
        v, t = cfg.vision_cfg, cfg.text_cfg
        if cfg.multimodal_cfg is not None:
            raise ValueError("the port builds CLIP configs only (no CoCa)")
        self.cfg = cfg
        self.cosmos = cosmos
        self.dtype = dtype
        self.text_bucket = text_bucket
        self.output_all = v.output_all
        cross_pool = cosmos and v.output_all and v.attentional_pool
        blocks = dict(dtype=dtype, fuse_ln=fuse_ln, remat=remat,
                      remat_policy=remat_policy, use_flash=use_flash)
        if cfg.quick_gelu:
            act = get_act_fn("quick_gelu")
        else:
            act = get_act_fn("gelu_tanh" if act_approx else "gelu")
        token_width = v.width
        if v.timm_model_name:
            # the tower dispatch of cosmos_tpu/models/clip.py:78-125
            if cosmos or v.attentional_pool or v.output_all:
                raise ValueError(
                    "timm vision towers support plain CLIP/SigLIP training "
                    "and inference only; --cosmos/--output-all/"
                    "--attentional-pool need the native ViT tower")
            self.visual = TimmModel(
                v.timm_model_name, cfg.embed_dim, image_size=v.image_size,
                pool=v.timm_pool, proj=v.timm_proj,
                proj_bias=v.timm_proj_bias, drop=v.timm_drop,
                drop_path=v.timm_drop_path, dtype=dtype, use_flash=use_flash,
                remat=remat, remat_policy=remat_policy)
        elif isinstance(v.layers, (tuple, list)):
            if cross_pool:
                # the JAX package's COSMOS forward asserts the tower's
                # cross-attention pooler, which ModifiedResNet has not
                raise ValueError(
                    "the COSMOS cross-modal heads need the native ViT "
                    "tower's cross-attention pooler; ModifiedResNet has none")
            self.visual = ModifiedResNet(
                tuple(v.layers), cfg.embed_dim, heads=v.width * 32 // 64,
                image_size=v.image_size, width=v.width, dtype=dtype)
            token_width = self.visual.num_features
        else:
            if cross_pool and (v.pool_type not in ("tok", "avg", "map") or (
                    v.no_proj and v.width != cfg.embed_dim)):
                # the JAX package's init traces the cross-modal heads and
                # fails there on these towers
                raise ValueError(
                    "the COSMOS cross-modal heads need one pooled image "
                    f"feature of the embedding width {cfg.embed_dim}; pool "
                    f"{v.pool_type!r} with no_proj={v.no_proj} at width "
                    f"{v.width} gives none")
            self.visual = VisionTransformer(
                image_size=v.image_size, patch_size=v.patch_size,
                width=v.width, layers=v.layers, num_heads=v.heads,
                mlp_ratio=v.mlp_ratio, output_dim=cfg.embed_dim,
                ls_init_value=v.ls_init_value, no_ln_pre=v.no_ln_pre,
                pool_type=v.pool_type, class_token=v.class_token,
                patch_bias=v.patch_bias, no_proj=v.no_proj,
                pos_embed_type=v.pos_embed_type,
                final_ln_after_pool=v.final_ln_after_pool,
                cross_pool=cross_pool,
                attn_pooler_heads=v.attn_pooler_heads,
                add_zero_attn=v.add_zero_attn, act_fn=act,
                patch_dropout=v.patch_dropout, **blocks)
        if t.is_hf:
            if cross_pool:
                # the JAX package's HF tower has no cross-attention pooler
                # (``attn_cross_pool = None``) and its init fails there
                raise ValueError(
                    "the COSMOS cross-modal heads need the native text "
                    "tower's cross-attention pooler; an HF text tower has "
                    "none (build without cosmos + output_all + "
                    "attentional_pool)")
            self.text_cfg = t
            self.text = build_hf_text_tower(t, cfg.embed_dim, dtype)
            text_width = self.text.width
        else:
            add_text_tower(self, t, cfg.embed_dim, act, **blocks)
            text_width = t.width
        self.text_attn_cross_pool = (
            AttentionalCrossPooler(cfg.embed_dim, t.attn_pooler_heads,
                                   t.add_zero_attn, dtype)
            if cross_pool else None)
        self.logit_scale = nn.Parameter(torch.empty(()))
        self.distill_logit_scale = (
            nn.Parameter(torch.empty(())) if cosmos else None)
        self.logit_bias = (nn.Parameter(torch.empty(()))
                           if cfg.init_logit_bias is not None else None)
        if self.output_all:
            self.image_token_mapping = Linear(token_width, cfg.embed_dim,
                                              dtype=dtype)
            self.text_token_mapping = Linear(text_width, cfg.embed_dim,
                                             dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        if not self.text_cfg.is_hf:
            init_text_tower(self, generator)
        nn.init.constant_(self.logit_scale, self.cfg.init_logit_scale)
        if self.distill_logit_scale is not None:
            nn.init.constant_(self.distill_logit_scale,
                              self.cfg.init_logit_scale)
        if self.logit_bias is not None:
            nn.init.constant_(self.logit_bias, self.cfg.init_logit_bias)

    # --- encoders ----------------------------------------------------------

    def _encode_text(self, text: torch.Tensor):
        """(pooled, tokens) of the text tower."""
        if self.text_cfg.is_hf:
            return self.text(text)
        return encode_tokens(self, text, self.dtype)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     csa: bool = False) -> Dict[str, torch.Tensor]:
        pooled, tokens = self.visual(images, csa=csa)
        out = {"image_features": l2_normalize(pooled) if normalize else pooled}
        if self.output_all:
            out["image_tokens"] = self.image_token_mapping(tokens)
        else:
            out["image_tokens_raw"] = tokens
        return out

    def encode_text(self, text: torch.Tensor, normalize: bool = False
                    ) -> Dict[str, torch.Tensor]:
        pooled, tokens = self._encode_text(text)
        out = {"text_features": l2_normalize(pooled) if normalize else pooled}
        if self.output_all:
            out["text_tokens"] = self.text_token_mapping(tokens)
        return out

    def get_logits(self, images: torch.Tensor, text: torch.Tensor):
        img = self.encode_image(images, normalize=True)["image_features"]
        txt = self.encode_text(text, normalize=True)["text_features"]
        logits_per_image = self.logit_scale.exp() * img @ txt.T
        if self.logit_bias is not None:
            logits_per_image = logits_per_image + self.logit_bias
        return logits_per_image, logits_per_image.T

    # --- full forward --------------------------------------------------------

    def _bucketed_text_pooled(self, toks: torch.Tensor,
                              l_short: int) -> torch.Tensor:
        """Pooled text features of caption views that need no token outputs,
        with the shortest 3/4 run at ``l_short`` tokens when every one of
        them fits (row order of ``toks`` kept).

        Exact: under the causal mask and argmax-EOT pooling, truncating a
        caption at >= eot+1 keeps its pooled feature.  The JAX package
        picks the branch on the device (``nn.cond``); here the fit test is
        one ``.item()``, a host sync per training forward."""
        n = toks.shape[0]
        eot = toks.argmax(dim=-1)
        order = torch.argsort(eot, stable=True)
        ns = (n * 3) // 4
        short_idx, long_idx = order[:ns], order[ns:]
        # sorted ascending: the short bucket's largest EOT is its last entry
        fits = bool(eot[short_idx[-1]].item() + 1 <= l_short)
        short_toks = toks[short_idx]
        if fits:
            short_toks = short_toks[:, :l_short]
        f_short = self._encode_text(short_toks)[0]
        f_long = self._encode_text(toks[long_idx])[0]
        feats = torch.cat([f_short, f_long], dim=0)
        return feats[torch.argsort(order)]                 # undo the sort

    def forward(
        self,
        global_images: Optional[torch.Tensor] = None,  # [2B, H, W, 3]
        texts: Optional[torch.Tensor] = None,          # [kB, L]
        local_images: Optional[torch.Tensor] = None,   # [nB, h, w, 3]
        batch_size: Optional[int] = None,
        patch_drop: Optional[torch.Generator] = None,
    ) -> Dict[str, torch.Tensor]:
        """COSMOS forward.  With ``batch_size=None`` it is the teacher/eval
        forward: features are normalised and no cross-modal heads run.
        ``patch_drop``: the generator of the vision tower's patch dropout
        (drawn from in the order of the tower calls: globals, then locals);
        without it no token is dropped."""
        out: Dict[str, torch.Tensor] = {"logit_scale": self.logit_scale.exp()}
        if self.distill_logit_scale is not None:
            out["distill_logit_scale"] = self.distill_logit_scale.exp()
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        is_norm = not (self.output_all and batch_size is not None)

        img_features = img_tokens = None
        if global_images is not None:
            g_pooled, g_tokens = self.visual(global_images,
                                             patch_drop=patch_drop)
            feats = [g_pooled]
            if local_images is not None and local_images.numel():
                feats.append(self.visual(local_images,
                                         patch_drop=patch_drop)[0])
            img_features = torch.cat(feats, dim=0)
            if self.output_all:
                # only the global crops' tokens are kept
                img_tokens = self.image_token_mapping(g_tokens)
            if is_norm:
                img_features = l2_normalize(img_features)

        txt_features = txt_tokens = None
        if texts is not None:
            b_ = batch_size if batch_size is not None else 0
            bucket = (
                self.text_bucket > 0
                and b_ > 0
                # views 0-1 (the teacher's targets and the pooler's token
                # context) stay full length; at least one more view buckets
                and texts.shape[0] >= 3 * b_
                and texts.shape[0] % b_ == 0
                and self.text_bucket < texts.shape[1]
                # the exactness argument needs causal attention and argmax
                # pooling: the gate of the eval-side EOT truncation
                and self.text_cfg.eot_truncation_exact
                and texts.shape[0] - 2 * b_ >= 4
            )
            if bucket:
                head_features, t_tokens = self._encode_text(
                    texts[:2 * b_])
                rest_features = self._bucketed_text_pooled(
                    texts[2 * b_:], self.text_bucket)
                txt_features = torch.cat([head_features, rest_features])
            else:
                txt_features, t_tokens = self._encode_text(texts)
            if self.output_all:
                # bucketed: token features of the 2 global views only, all
                # that the pooler reads ([:B])
                txt_tokens = self.text_token_mapping(t_tokens)
            if is_norm:
                txt_features = l2_normalize(txt_features)

        if self.cosmos and batch_size is not None and self.output_all:
            if self.text_attn_cross_pool is None:
                raise ValueError(
                    "the COSMOS forward needs the cross-attention poolers: "
                    "build with attentional_pool=True")
            if img_features is None or txt_features is None:
                raise ValueError(
                    "the COSMOS forward needs both images and texts")
            b = batch_size

            # the V view-queries of each sample attend to that sample's
            # context (first global crop / first caption view) as one
            # [B, V, D] attention
            def pool(pooler, ctx, queries):
                v = queries.shape[0] // b
                q = queries.reshape(v, b, -1).transpose(0, 1)
                return pooler(ctx, q).transpose(0, 1).reshape(v * b, -1)

            txt_pooled = pool(self.text_attn_cross_pool, txt_tokens[:b],
                              img_features)
            img_pooled = pool(self.visual.attn_cross_pool, img_tokens[:b],
                              txt_features)
            out["img_crossmodal_features"] = l2_normalize(
                img_features + txt_pooled)
            out["txt_crossmodal_features"] = l2_normalize(
                txt_features + img_pooled)
            img_features = l2_normalize(img_features)
            txt_features = l2_normalize(txt_features)

        out["image_features"] = img_features
        out["text_features"] = txt_features
        if img_tokens is not None:
            out["image_tokens"] = img_tokens
        if txt_tokens is not None:
            out["text_tokens"] = txt_tokens
        return out
