"""The ModifiedResNet vision tower of OpenAI's CLIP (counterpart of
``cosmos_tpu/models/modified_resnet.py``): a three-conv stem with an
average pool instead of a strided conv, four stages of Bottleneck blocks
that downsample by average pooling before the conv, and an attention pool
whose query is the mean token.

Activations are NHWC, as in the JAX package (``layers.Conv2d``).  Names are
OpenAI's (``conv1``, ``bn1``, ``layer1.0.conv1``, ``layer1.0.downsample.0``,
``attnpool.q_proj``, ...), so OpenAI RN checkpoints load as they are.  The
BatchNorms are inference-only, as in the JAX package, and their
statistics (``running_mean``, ``running_var``) are parameters, as they are
in its parameter tree: the optimizer updates them as it updates JAX's.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear


class FrozenBatchNorm(nn.Module):
    """Inference BatchNorm, ``(x - mean) rsqrt(var + eps) weight + bias``
    in float32, cast to the compute dtype."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.running_mean = nn.Parameter(torch.zeros(dim))
        self.running_var = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        return ((x.float() - self.running_mean) * inv
                + self.bias).to(self.dtype)


def avg_pool(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Average pool of window and stride ``stride`` over NHWC."""
    if stride <= 1:
        return x
    return F.avg_pool2d(x.permute(0, 3, 1, 2), stride).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride = stride
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(planes, dtype=dtype)
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = FrozenBatchNorm(planes, dtype=dtype)
        self.conv3 = Conv2d(planes, out, 1, bias=False, dtype=dtype)
        self.bn3 = FrozenBatchNorm(out, dtype=dtype)
        self.downsample = None
        if stride > 1 or inplanes != out:
            self.downsample = nn.Sequential(
                Conv2d(inplanes, out, 1, bias=False, dtype=dtype),
                FrozenBatchNorm(out, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(avg_pool(out, self.stride)))
        identity = x
        if self.downsample is not None:
            identity = self.downsample(avg_pool(x, self.stride))
        return F.relu(out + identity)


class AttentionPool2d(nn.Module):
    """Attention of the mean token over [mean, positions] (+ position
    embedding), float32 logits and softmax, as in the JAX package."""

    def __init__(self, spacial: int, dim: int, num_heads: int,
                 output_dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(
            torch.empty(spacial * spacial + 1, dim))
        self.q_proj = Linear(dim, dim, dtype=dtype)
        self.k_proj = Linear(dim, dim, dtype=dtype)
        self.v_proj = Linear(dim, dim, dtype=dtype)
        self.c_proj = Linear(dim, output_dim, dtype=dtype)

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.positional_embedding,
                        std=self.positional_embedding.shape[-1] ** -0.5,
                        generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        seq = x.reshape(b, h * w, c)
        seq = torch.cat([seq.mean(dim=1, keepdim=True), seq], dim=1)
        seq = seq + self.positional_embedding.to(seq.dtype)
        hd = c // self.num_heads

        def split(t):
            return t.reshape(b, -1, self.num_heads, hd).transpose(1, 2)

        q = split(self.q_proj(seq[:, :1]))
        k, v = split(self.k_proj(seq)), split(self.v_proj(seq))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            * hd ** -0.5
        wts = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(wts.float(), v.float()).to(v.dtype)
        return self.c_proj(out.transpose(1, 2).reshape(b, c))


class ModifiedResNet(nn.Module):
    """``(pooled [B, output_dim], tokens [B, (S/32)^2, 32 width])``; CSA
    (segmentation) needs the ViT tower and raises here."""

    def __init__(self, layers: Sequence[int] = (3, 4, 6, 3),
                 output_dim: int = 512, heads: int = 32,
                 image_size: int = 224, width: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_dropout = 0.0
        self.conv1 = Conv2d(3, width // 2, 3, stride=2, padding=1,
                            bias=False, dtype=dtype)
        self.bn1 = FrozenBatchNorm(width // 2, dtype=dtype)
        self.conv2 = Conv2d(width // 2, width // 2, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn2 = FrozenBatchNorm(width // 2, dtype=dtype)
        self.conv3 = Conv2d(width // 2, width, 3, padding=1, bias=False,
                            dtype=dtype)
        self.bn3 = FrozenBatchNorm(width, dtype=dtype)
        inplanes, planes = width, width
        self.num_stages = len(layers)
        for stage, blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            mods = []
            for blk in range(blocks):
                mods.append(Bottleneck(inplanes, planes,
                                       stride if blk == 0 else 1, dtype))
                inplanes = planes * Bottleneck.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*mods))
            planes *= 2
        self.num_features = width * 32
        self.attnpool = AttentionPool2d(image_size // 32, width * 32, heads,
                                        output_dim, dtype)

    def forward(self, images: torch.Tensor, csa: bool = False,
                patch_drop=None) -> Tuple[torch.Tensor, torch.Tensor]:
        if csa:
            raise NotImplementedError("CSA segmentation needs a ViT tower")
        x = F.relu(self.bn1(self.conv1(images)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = avg_pool(F.relu(self.bn3(self.conv3(x))), 2)
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        tokens = x.reshape(x.shape[0], -1, x.shape[-1])
        return self.attnpool(x), tokens
