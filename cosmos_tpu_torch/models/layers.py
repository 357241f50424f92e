"""Core layers shared by the vision and text towers
(counterpart of ``cosmos_tpu/models/layers.py``).

Parameters are stored in float32; each layer casts its weights and input to
the compute dtype (``dtype``) at the same places the JAX modules do, so that
a bfloat16 model rounds where the JAX package rounds.  LayerNorm always
reduces in float32 and casts back to the input dtype.

Two module-level toggles, off by default as in the JAX package, route
LayerNorm through the fused kernels of ``ops.experimental.layer_norm`` for
the inputs its ``supported`` accepts (3-D, D % 128 == 0, an even batch):

- ``FUSED_LN``: K3 forward, K4 backward (checked first, as in JAX);
- ``HYBRID_LN``: the plain forward, K4 backward.  In the JAX package it
  takes effect only on the TPU (``_hybrid_ln_active``); here it takes
  effect on CUDA and CPU tensors alike (on the CPU, K4's plain version).

Set them before the forward, e.g. ``layers.FUSED_LN = True``.

Every module with randomly drawn parameters of its own has
``init_weights(generator)``; ``models.factory.init_weights`` walks the model
and calls each one in module order, so one ``torch.Generator`` seed fixes
every weight.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.experimental import layer_norm as fln
from ..ops.experimental.mlp_block import mlp_block

# LayerNorm through K3 forward and K4 backward (JAX: layers.py:34)
FUSED_LN: bool = False
# LayerNorm through the plain forward and K4 backward (JAX: layers.py:50)
HYBRID_LN: bool = False


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal``: a normal truncated at two deviations, with
    variance 1/fan_in after the truncation.  ``fan_in`` is every axis but
    the first of a torch ``[out, in, ...]`` weight."""
    fan_in = w[0].numel()
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


class LayerNorm(nn.Module):
    """LayerNorm with single-pass float32 statistics (float64 for a float64
    input), cast back to the input dtype: var = max(E[x^2] - E[x]^2, 0).
    ``FUSED_LN``/``HYBRID_LN`` act on it unless ``fusable`` is False."""

    fusable = True

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if (FUSED_LN or HYBRID_LN) and self.fusable and fln.supported(x):
            fn = fln.fused_layer_norm if FUSED_LN else fln.hybrid_layer_norm
            return fn(x, self.weight, self.bias, self.eps)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(-1, keepdim=True)
        meansq = xf.square().mean(-1, keepdim=True)
        var = (meansq - mean.square()).clamp_min(0.0)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class Linear(nn.Module):
    """``y = x W^T + b`` with W and b cast to the compute dtype (flax
    ``Dense(dtype=...)``).  Weight layout is torch's ``[out, in]``."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class Conv2d(nn.Module):
    """flax ``nn.Conv(dtype=...)`` over NHWC ``[B, H, W, C]`` activations:
    weight and bias cast to the compute dtype, symmetric ``padding``.  The
    weight keeps torch's ``[out, in / groups, kh, kw]`` layout; the input
    is viewed as NCHW by a permute (channels-last strides, no copy)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, stride: int = 1,
                 padding: int = 0, groups: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.empty(out_ch, in_ch // groups, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(out_ch)) if bias else None

    def init_weights(self, generator: torch.Generator) -> None:
        lecun_normal_(self.weight, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.weight.to(self.dtype), bias, self.stride,
                     self.padding, 1, self.groups)
        return y.permute(0, 2, 3, 1)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x), the OpenAI CLIP activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU."""
    return F.gelu(x, approximate="tanh")


def get_act_fn(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "gelu":
        return gelu
    if name == "gelu_tanh":
        return gelu_tanh
    if name == "quick_gelu":
        return quick_gelu
    raise ValueError(f"unknown activation: {name}")


def act_name(fn: Callable[[torch.Tensor], torch.Tensor]) -> str:
    """Inverse of ``get_act_fn``: the fused MLP kernel takes the name."""
    for name, f in (("gelu", gelu), ("gelu_tanh", gelu_tanh),
                    ("quick_gelu", quick_gelu)):
        if fn is f:
            return name
    raise ValueError(f"unregistered activation fn: {fn}")


class LayerScale(nn.Module):
    """Per-channel learnable gain."""

    def __init__(self, dim: int, init_value: float = 1e-5):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), init_value))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class Mlp(nn.Module):
    """Transformer MLP: c_fc -> act -> c_proj."""

    def __init__(self, dim: int, hidden_dim: int,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act_fn = act_fn
        self.c_fc = Linear(dim, hidden_dim, dtype=dtype)
        self.c_proj = Linear(hidden_dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``ln=(scale, bias)``: run LayerNorm → c_fc → act → c_proj as one
        kernel (K6, ``ops.experimental.mlp_block``); ``x`` is then the
        un-normalised input, and the biases stay float32 as in the fused
        JAX kernel."""
        if ln is not None:
            return mlp_block(x, ln[0], ln[1], self.c_fc.weight,
                             self.c_fc.bias, self.c_proj.weight,
                             self.c_proj.bias, 1e-5, act_name(self.act_fn))
        return self.c_proj(self.act_fn(self.c_fc(x)))


def patch_dropout(x: torch.Tensor, prob: float,
                  generator: Optional[torch.Generator] = None,
                  keep_idx: Optional[torch.Tensor] = None,
                  exclude_first_token: bool = True) -> torch.Tensor:
    """Keep ``max(1, int(n (1 - prob)))`` of the ``n`` patch tokens of each
    row of ``x`` [B, 1 + n, D] (``cosmos_tpu/models/layers.py``
    ``patch_dropout``): the top-k of standard-normal scores, in the order
    of their scores, the class token first.  With ``exclude_first_token``
    False every token is in the pool and nothing is prepended.

    The scores are drawn on the CPU from ``generator``, so a seed gives the
    same tokens on every device (JAX draws other bits from its key);
    ``keep_idx`` [B, k] skips the draw and keeps those tokens."""
    if prob <= 0.0:
        return x
    if exclude_first_token:
        cls_tokens, tokens = x[:, :1], x[:, 1:]
    else:
        cls_tokens, tokens = None, x
    b, n, d = tokens.shape
    if keep_idx is None:
        num_keep = max(1, int(n * (1.0 - prob)))
        scores = torch.randn(b, n, generator=generator)
        keep_idx = scores.topk(num_keep, dim=-1).indices
    keep_idx = keep_idx.to(x.device)
    kept = tokens.gather(1, keep_idx[..., None].expand(-1, -1, d))
    if cls_tokens is not None:
        kept = torch.cat([cls_tokens, kept], dim=1)
    return kept


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    """F.normalize equivalent computed in float32 and cast back."""
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return (xf / norm.clamp_min(eps)).to(x.dtype)
