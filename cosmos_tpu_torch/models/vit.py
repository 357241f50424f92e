"""Vision transformer towers (counterpart of ``cosmos_tpu/models/vit.py``).

Input layout is NHWC ``[B, H, W, 3]``, as in the JAX package.  The patchify
conv (stride == kernel) is an unfold plus one matmul: the same function as
the conv, and it keeps cuDNN's TF32 convolution out of the float32 path.

``VisionTransformer`` is the CLIP tower, with OpenCLIP's names.
``TimmVisionTransformer`` is the same network in the configuration the JAX
package's timm adapter builds (``cosmos_tpu/models/timm_model.py:189-208``:
biased patch embedding, no pre-LayerNorm, a final norm over every token, no
projection, ``tok`` or ``avg`` pooling, optionally the MCi conv stem and a
patch-only position table added before the CLS token), with timm's names, so
that OpenCLIP's ``TimmModel`` checkpoints load as they are.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AttentionalCrossPooler, packed_self_attention
from .layers import Conv2d, LayerNorm, Linear, gelu, lecun_normal_, \
    patch_dropout
from .transformer import Transformer, remat_context_fn, run_block


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    src_grid: Tuple[int, int],
    dst_grid: Tuple[int, int],
    num_prefix: int = 1,
    antialias: bool = False,
) -> torch.Tensor:
    """Bicubic-resize the patch part of a [prefix+N, D] position embedding
    (``F.interpolate(mode="bicubic", align_corners=False)``, the function
    the JAX package's interpolation matrices reproduce; ``antialias`` is
    timm's resampling, which the EVA02 trunk takes)."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos_embed
    prefix, patch = pos_embed[:num_prefix], pos_embed[num_prefix:]
    d = pos_embed.shape[-1]
    grid = patch.float().reshape(1, src_grid[0], src_grid[1], d)
    resized = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(dst_grid),
                            mode="bicubic", align_corners=False,
                            antialias=antialias)
    resized = resized.permute(0, 2, 3, 1).reshape(-1, d).to(pos_embed.dtype)
    return torch.cat([prefix, resized], dim=0)


def patchify(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor], dtype: torch.dtype
             ) -> torch.Tensor:
    """A conv whose stride is its kernel k, [B, H, W, C] -> [B, H/k, W/k,
    O], as an unfold and one matmul in ``dtype``; ``weight`` is torch's
    ``[O, C, k, k]``."""
    b, h, w, c = x.shape
    k = weight.shape[-1]
    x = x.reshape(b, h // k, k, w // k, k, c).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, h // k, w // k, k * k * c)
    # OIHW -> HWIO -> [k*k*C, O], the row order of the unfold
    kernel = weight.permute(2, 3, 1, 0).reshape(k * k * c, -1)
    y = torch.matmul(x.to(dtype), kernel.to(dtype))
    return y if bias is None else y + bias.to(dtype)


def pool_tokens(x: torch.Tensor, pool_type: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pooled, patch tokens) of [B, 1 + N, D]: the CLS token (``tok``) or
    the mean of the patch tokens (``avg``)."""
    if pool_type == "avg":
        return x[:, 1:].mean(dim=1), x[:, 1:]
    return x[:, 0], x[:, 1:]


class VisionTransformer(nn.Module):
    """CLS-token ViT with learned position embedding and 'tok' pooling.

    ``cross_pool`` adds the COSMOS image-token cross pooler
    (``attn_cross_pool``) at ``output_dim``; ``patch_dropout`` is the share
    of patch tokens a forward given a ``patch_drop`` generator drops;
    ``pool_type`` is ``tok`` or ``avg``.  ``proj_in`` is the width of the
    vector ``proj`` projects: the tower's own (the default), or, in CoCa,
    the attentional pooler's, which projects the pooled latent itself and
    calls ``tokens``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, output_dim: int = 512,
                 ls_init_value: Optional[float] = None,
                 no_ln_pre: bool = False, pool_type: str = "tok",
                 cross_pool: bool = False,
                 attn_pooler_heads: int = 8, add_zero_attn: bool = False,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 patch_dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False,
                 remat: bool = False, remat_policy: str = "",
                 use_flash: Optional[bool] = None,
                 proj_in: Optional[int] = None):
        super().__init__()
        self.image_size = image_size
        self.patch_dropout = patch_dropout
        self.patch_size = patch_size
        self.width = width
        self.dtype = dtype
        self.pool_type = pool_type
        grid = image_size // patch_size
        self.grid_size = (grid, grid)
        # holds the OpenCLIP-layout [width, 3, p, p] weight; patchify() runs
        # it as a matmul, the conv itself is never called
        self.conv1 = nn.Conv2d(3, width, patch_size, patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1, width))
        self.ln_pre = nn.Identity() if no_ln_pre else LayerNorm(width)
        self.transformer = Transformer(width, layers, num_heads, mlp_ratio,
                                       ls_init_value, act_fn, dtype, fuse_ln,
                                       remat, remat_policy, use_flash)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(proj_in or width, output_dim))
        self.attn_cross_pool = (
            AttentionalCrossPooler(output_dim, attn_pooler_heads,
                                   add_zero_attn, dtype)
            if cross_pool else None)

    def init_weights(self, generator: torch.Generator) -> None:
        scale = self.width ** -0.5
        lecun_normal_(self.conv1.weight, generator)
        for p in (self.class_embedding, self.positional_embedding, self.proj):
            nn.init.normal_(p, std=scale, generator=generator)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, gh*gw, width] via unfold + one matmul."""
        return patchify(images, self.conv1.weight, self.conv1.bias,
                        self.dtype).reshape(images.shape[0], -1, self.width)

    def forward(self, images: torch.Tensor, csa: bool = False,
                patch_drop: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (pooled [B, output_dim], tokens [B, N, width]).  ``csa``:
        the last block runs correlative self-attention (segmentation).
        ``patch_drop``: drop patch tokens after the position embedding,
        drawing from this generator (training only; the reference's
        PatchDropout is the identity in eval)."""
        pooled, tokens = pool_tokens(self.tokens(images, csa, patch_drop),
                                     self.pool_type)
        pooled = torch.matmul(pooled.to(self.dtype), self.proj.to(self.dtype))
        return pooled, tokens

    def tokens(self, images: torch.Tensor, csa: bool = False,
               patch_drop: Optional[torch.Generator] = None) -> torch.Tensor:
        """Every token after ``ln_post``, the CLS token first:
        [B, 1 + N, width]."""
        b, h, w, _ = images.shape
        x = self.patchify(images)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        pe = interpolate_pos_embed(
            self.positional_embedding, self.grid_size,
            (h // self.patch_size, w // self.patch_size))
        x = x + pe.to(x.dtype)
        if self.patch_dropout > 0.0 and patch_drop is not None:
            x = patch_dropout(x, self.patch_dropout, patch_drop)
        x = self.ln_pre(x)
        x = self.transformer(x, csa_last_block=csa)
        return self.ln_post(x)


class _PatchEmbed(nn.Module):
    """timm's ``patch_embed`` (its ``proj`` conv, run by ``patchify``)."""

    def __init__(self, patch_size: int, width: int):
        super().__init__()
        self.proj = Conv2d(3, width, patch_size, patch_size)


class TimmAttention(nn.Module):
    """timm's packed-QKV attention (``qkv``, ``proj``), routed as
    ``MultiheadAttention`` routes self-attention: K1 where the gate admits
    the geometry."""

    def __init__(self, width: int, num_heads: int,
                 dtype: torch.dtype = torch.float32,
                 use_flash: Optional[bool] = None):
        super().__init__()
        self.num_heads, self.use_flash = num_heads, use_flash
        self.qkv = Linear(width, 3 * width, dtype=dtype)
        self.proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(packed_self_attention(
            self.qkv(x), self.num_heads, use_flash=self.use_flash))


class TimmMlp(nn.Module):
    def __init__(self, width: int, hidden: int,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_fn = act_fn
        self.fc1 = Linear(width, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act_fn(self.fc1(x)))


class TimmBlock(nn.Module):
    """Pre-LN attention and pre-LN MLP with timm's names."""

    def __init__(self, width: int, num_heads: int,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32,
                 use_flash: Optional[bool] = None):
        super().__init__()
        self.norm1 = LayerNorm(width)
        self.attn = TimmAttention(width, num_heads, dtype, use_flash)
        self.norm2 = LayerNorm(width)
        self.mlp = TimmMlp(width, 4 * width, act_fn, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class TimmVisionTransformer(nn.Module):
    """The timm-ViT trunk: ``(pooled [B, width], tokens [B, N, width])``.

    ``stem_channels`` replaces the patchify conv with the MCi stem (convs
    ``stem0``.. of kernel == stride ``stem_kernels``, GELU between them);
    ``no_embed_class`` makes ``pos_embed`` a patch-only table added before
    the CLS token is prepended.  LayerNorms keep the JAX trunk's eps 1e-5."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, num_heads: int = 12,
                 stem_channels: Optional[Tuple[int, ...]] = None,
                 stem_kernels: Tuple[int, ...] = (4, 2, 2),
                 no_embed_class: bool = False, pool_type: str = "tok",
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = "", use_flash: Optional[bool] = None):
        super().__init__()
        self.patch_size, self.width, self.dtype = patch_size, width, dtype
        self.pool_type, self.no_embed_class = pool_type, no_embed_class
        self.num_features = width
        grid = image_size // patch_size
        self.grid_size = (grid, grid)
        self.stem = None
        if stem_channels is not None:
            chans = (3,) + tuple(stem_channels)
            if chans[-1] != width:
                raise ValueError(
                    f"stem_channels must end at width {width}, got {chans}")
            if math.prod(stem_kernels) != patch_size:
                raise ValueError(f"stem_kernels {tuple(stem_kernels)} must "
                                 f"multiply to patch_size {patch_size}")
            self.stem = list(range(len(stem_kernels)))
            for i, k in enumerate(stem_kernels):
                self.add_module(f"stem{i}",
                                Conv2d(chans[i], chans[i + 1], k, k))
        else:
            self.patch_embed = _PatchEmbed(patch_size, width)
        self.cls_token = nn.Parameter(torch.empty(1, 1, width))
        self.pos_embed = nn.Parameter(torch.empty(
            1, grid * grid + (0 if no_embed_class else 1), width))
        self.blocks = nn.ModuleList(
            TimmBlock(width, num_heads, act_fn, dtype, use_flash)
            for _ in range(layers))
        self.norm = LayerNorm(width)
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.cls_token, self.pos_embed):
            nn.init.normal_(p, std=self.width ** -0.5, generator=generator)

    def patchify(self, images: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, gh*gw, width]."""
        if self.stem is None:
            x = patchify(images, self.patch_embed.proj.weight,
                         self.patch_embed.proj.bias, self.dtype)
        else:
            x = images
            for i in self.stem:
                conv = getattr(self, f"stem{i}")
                x = patchify(x, conv.weight, conv.bias, self.dtype)
                if i < self.stem[-1]:
                    x = gelu(x)
        return x.reshape(images.shape[0], -1, self.width)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h, w, _ = images.shape
        x = self.patchify(images)
        dst = (h // self.patch_size, w // self.patch_size)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.width)
        if self.no_embed_class:
            pe = interpolate_pos_embed(self.pos_embed[0], self.grid_size,
                                       dst, num_prefix=0)
            x = torch.cat([cls, x + pe.to(x.dtype)], dim=1)
        else:
            x = torch.cat([cls, x], dim=1)
            pe = interpolate_pos_embed(self.pos_embed[0], self.grid_size, dst)
            x = x + pe.to(x.dtype)
        for block in self.blocks:
            x = run_block(block, self.remat, self._context_fn, x)
        return pool_tokens(self.norm(x), self.pool_type)
