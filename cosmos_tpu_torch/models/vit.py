"""Vision transformer tower (counterpart of ``cosmos_tpu/models/vit.py``).

Input layout is NHWC ``[B, H, W, 3]``, as in the JAX package.  The patchify
conv (stride == kernel) is an unfold plus one matmul: the same function as
the conv, and it keeps cuDNN's TF32 convolution out of the float32 path.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .attention import AttentionalCrossPooler
from .layers import LayerNorm, gelu, lecun_normal_
from .transformer import Transformer


def interpolate_pos_embed(
    pos_embed: torch.Tensor,
    src_grid: Tuple[int, int],
    dst_grid: Tuple[int, int],
    num_prefix: int = 1,
) -> torch.Tensor:
    """Bicubic-resize the patch part of a [prefix+N, D] position embedding
    (``F.interpolate(mode="bicubic", align_corners=False)``, the function
    the JAX package's interpolation matrix reproduces)."""
    if tuple(src_grid) == tuple(dst_grid):
        return pos_embed
    prefix, patch = pos_embed[:num_prefix], pos_embed[num_prefix:]
    d = pos_embed.shape[-1]
    grid = patch.float().reshape(1, src_grid[0], src_grid[1], d)
    resized = F.interpolate(grid.permute(0, 3, 1, 2), size=tuple(dst_grid),
                            mode="bicubic", align_corners=False)
    resized = resized.permute(0, 2, 3, 1).reshape(-1, d).to(pos_embed.dtype)
    return torch.cat([prefix, resized], dim=0)


class VisionTransformer(nn.Module):
    """CLS-token ViT with learned position embedding and 'tok' pooling.

    ``cross_pool`` adds the COSMOS image-token cross pooler
    (``attn_cross_pool``) at ``output_dim``."""

    def __init__(self, image_size: int = 224, patch_size: int = 16,
                 width: int = 768, layers: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, output_dim: int = 512,
                 ls_init_value: Optional[float] = None,
                 no_ln_pre: bool = False, cross_pool: bool = False,
                 attn_pooler_heads: int = 8, add_zero_attn: bool = False,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False):
        super().__init__()
        self.image_size = image_size
        self.patch_size = patch_size
        self.width = width
        self.dtype = dtype
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
                                       ls_init_value, act_fn, dtype, fuse_ln)
        self.ln_post = LayerNorm(width)
        self.proj = nn.Parameter(torch.empty(width, output_dim))
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
        b, h, w, c = images.shape
        p = self.patch_size
        gh, gw = h // p, w // p
        x = images.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, gh * gw, p * p * c)
        # OIHW -> HWIO -> [p*p*3, width], the row order of the unfold
        kernel = self.conv1.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return torch.matmul(x.to(self.dtype), kernel.to(self.dtype))

    def forward(self, images: torch.Tensor, csa: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (pooled [B, output_dim], tokens [B, N, width]).  ``csa``:
        the last block runs correlative self-attention (segmentation)."""
        b, h, w, _ = images.shape
        x = self.patchify(images)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        pe = interpolate_pos_embed(
            self.positional_embedding, self.grid_size,
            (h // self.patch_size, w // self.patch_size))
        x = x + pe.to(x.dtype)
        x = self.ln_pre(x)
        x = self.transformer(x, csa_last_block=csa)
        x = self.ln_post(x)
        pooled, tokens = x[:, 0], x[:, 1:]
        pooled = torch.matmul(pooled.to(self.dtype), self.proj.to(self.dtype))
        return pooled, tokens
