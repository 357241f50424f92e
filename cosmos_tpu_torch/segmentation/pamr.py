"""PAMR, pixel-adaptive mask refinement, in torch ops on the mask's device
(counterpart of ``cosmos_tpu/segmentation/pamr.py``).

8-neighbourhood affinities at several dilations: per pixel, a softmax over
the neighbour positions of ``-|Δx| / (0.1 σ)`` (σ the standard deviation
over the union of all dilations' 3×3 windows), then ``num_iter`` steps that
replace the mask by its affinity-weighted neighbours.  Neighbours are
shifts with edge replication, taken by clamped indexing; the layout is NHWC,
as in the JAX package.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

# 8-neighbourhood offsets (dy, dx), row-major around the centre
_OFFSETS = (
    (-1, -1), (-1, 0), (-1, 1),
    (0, -1), (0, 1),
    (1, -1), (1, 0), (1, 1),
)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[.., i, j, :] = x[.., clamp(i+dy), clamp(j+dx), :] over the H and
    W axes (-3, -2)."""
    h, w = x.shape[-3], x.shape[-2]
    rows = (torch.arange(h, device=x.device) + dy).clamp_(0, h - 1)
    cols = (torch.arange(w, device=x.device) + dx).clamp_(0, w - 1)
    return x.index_select(-3, rows).index_select(-2, cols)


def _neighbors(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """The 8 · len(dilations) neighbour views, stacked: [P, ..., H, W, C]."""
    return torch.stack([_shift(x, dy * d, dx * d)
                        for d in dilations for dy, dx in _OFFSETS])


def _local_std(x: torch.Tensor, dilations: Sequence[int]) -> torch.Tensor:
    """Standard deviation (ddof 1) over the centre and the neighbours of
    every dilation jointly: [1, ..., H, W, C]."""
    vals = []
    for d in dilations:
        vals.append(x)
        vals.extend(_shift(x, dy * d, dx * d) for dy, dx in _OFFSETS)
    return torch.stack(vals).std(dim=0, correction=1)[None]


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True sampling, NHWC: the source
    positions of JAX's ``linspace(0, n - 1, size)``."""
    b, h, w, c = x.shape
    th, tw = size
    if (h, w) == (th, tw):
        return x
    ys = torch.linspace(0.0, h - 1.0, th, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, tw, device=x.device)
    y0 = ys.floor().long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, :, None, None]
    wx = (xs - x0).to(x.dtype)[None, None, :, None]
    top_rows, bot_rows = x[:, y0], x[:, y1]
    top = top_rows[:, :, x0] * (1 - wx) + top_rows[:, :, x1] * wx
    bot = bot_rows[:, :, x0] * (1 - wx) + bot_rows[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def pamr(image: torch.Tensor, mask: torch.Tensor, num_iter: int = 1,
         dilations: Sequence[int] = (1,)) -> torch.Tensor:
    """Refine ``mask`` [B, h, w, C] (logits or probabilities) by the
    affinities of ``image`` [B, H, W, 3]; returns [B, H, W, C] float32."""
    dilations = tuple(dilations)
    mask = resize_bilinear_align_corners(mask.float(), tuple(image.shape[1:3]))
    img = image.float()
    x_std = _local_std(img, dilations)
    diffs = (_neighbors(img, dilations) - img[None]).abs()
    aff = -diffs / (1e-8 + 0.1 * x_std)
    aff = torch.softmax(aff.mean(dim=-1, keepdim=True), dim=0)
    for _ in range(num_iter):
        mask = (_neighbors(mask, dilations) * aff).sum(dim=0)
    return mask
