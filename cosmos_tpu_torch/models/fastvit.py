"""The FastViT/MCi trunk of MobileCLIP-S1/S2 in its deploy form
(counterpart of ``cosmos_tpu/models/fastvit.py:78-268``): a stem of three
convs, four stages (RepMixer blocks in stages 0-2, attention blocks with a
head dim of 32 in stage 3, each with a ConvFFN), large-kernel downsampling
between stages, a conditional position conv before stage 3, and a grouped
conv expansion with squeeze-excite before the global average pool.

Activations are NHWC, as in the JAX package (``layers.Conv2d``).  Module
and parameter names are the JAX parameter tree's paths with dots
(``stem_0``, ``down_lkb_1``, ``net_3_blocks_0.attn.qkv``, ...), a
``kernel`` as torch's ``weight``.  The attention of stage 3 runs on stock
ops, as the JAX package runs it on XLA: logits in the compute dtype, a
float32 softmax.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .convert import np_
from .layers import Conv2d, Linear, gelu
from .transformer import remat_context_fn, run_block

# timm/Apple model name -> MCi geometry (the JAX package's FASTVIT_CONFIGS)
FASTVIT_CONFIGS: Dict[str, Dict[str, Any]] = {
    "fastvit_mci0": dict(layers=(2, 6, 10, 2), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3)),
    "fastvit_mci1": dict(layers=(4, 12, 20, 4), dims=(64, 128, 256, 512),
                         mlp_ratios=(3, 3, 3, 3)),
    "fastvit_mci2": dict(layers=(4, 12, 24, 4), dims=(80, 160, 320, 640),
                         mlp_ratios=(3, 3, 3, 3)),
}

_TOKEN_MIXERS = ("repmixer", "repmixer", "repmixer", "attention")
_POS_EMBS = (False, False, False, True)   # the position conv before stage 3
_CLS_RATIO = 2.0                          # conv_exp: C -> 2C
_ATTN_HEAD_DIM = 32
_DOWN_KERNEL, _DOWN_STRIDE = 7, 2


def register_fastvit(name: str, *, layers: Sequence[int],
                     dims: Sequence[int],
                     mlp_ratios: Sequence[int] = (3, 3, 3, 3)) -> None:
    """Register another MCi/FastViT geometry."""
    FASTVIT_CONFIGS[name] = dict(layers=tuple(layers), dims=tuple(dims),
                                 mlp_ratios=tuple(mlp_ratios))


def _conv(in_ch: int, out_ch: int, kernel: int, dtype: torch.dtype,
          stride: int = 1, groups: int = 1) -> Conv2d:
    """The JAX package's ``_conv``: symmetric padding kernel // 2."""
    return Conv2d(in_ch, out_ch, kernel, stride, kernel // 2, groups,
                  dtype=dtype)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd_ratio: float = 1.0 / 16,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        rd = max(1, int(channels * rd_ratio))
        self.reduce = Linear(channels, rd, dtype=dtype)
        self.expand = Linear(rd, channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = x.mean(dim=(1, 2))                           # [B, C]
        w = torch.sigmoid(self.expand(F.relu(self.reduce(w))))
        return x * w[:, None, None, :]


class MHSA(nn.Module):
    """Attention over the flattened grid, head dim 32, bias-free qkv."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = Linear(dim, 3 * dim, bias=False, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        heads = c // _ATTN_HEAD_DIM
        qkv = self.qkv(x.reshape(b, h * w, c)).reshape(
            b, h * w, 3, heads, _ATTN_HEAD_DIM)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
        att = torch.matmul(q, k.transpose(-1, -2)) * _ATTN_HEAD_DIM ** -0.5
        att = torch.softmax(att.float(), dim=-1).to(v.dtype)
        o = torch.matmul(att, v).transpose(1, 2).reshape(b, h * w, c)
        return self.proj(o).reshape(b, h, w, c)


class ConvFFN(nn.Module):
    """depthwise 7x7 -> Linear -> GELU -> Linear."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = _conv(dim, dim, 7, dtype, groups=dim)
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(self.conv(x))))


class RepMixerBlock(nn.Module):
    """One fused depthwise 3x3 (identity and layer scale folded in), then
    the ConvFFN residual."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mixer = _conv(dim, dim, 3, dtype, groups=dim)
        self.convffn = ConvFFN(dim, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.mixer(x)
        return x + self.convffn(x)


class AttentionBlock(nn.Module):
    """The inference BatchNorm as a per-channel affine, then attention and
    the ConvFFN, each residual."""

    def __init__(self, dim: int, hidden: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.attn = MHSA(dim, dtype)
        self.convffn = ConvFFN(dim, hidden, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x * self.norm_scale.to(x.dtype) + self.norm_bias.to(x.dtype)
        x = x + self.attn(h)
        return x + self.convffn(x)


class FastVit(nn.Module):
    """MCi/FastViT trunk: ``(pooled [B, 2 dims[-1]], tokens [B, N,
    2 dims[-1]])``, the tokens the flattened final feature map."""

    def __init__(self, model_name: str, dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__()
        g = FASTVIT_CONFIGS[model_name]
        layers, dims, ratios = g["layers"], g["dims"], g["mlp_ratios"]
        self.dtype = dtype
        self.stem_0 = _conv(3, dims[0], 3, dtype, stride=2)
        self.stem_1 = _conv(dims[0], dims[0], 3, dtype, stride=2,
                            groups=dims[0])
        self.stem_2 = _conv(dims[0], dims[0], 1, dtype)
        self.stages = []
        for s, (depth, dim, ratio) in enumerate(zip(layers, dims, ratios)):
            names = []
            if s > 0:
                self.add_module(f"down_lkb_{s}", _conv(
                    dims[s - 1], dim, _DOWN_KERNEL, dtype,
                    stride=_DOWN_STRIDE, groups=dims[s - 1]))
                self.add_module(f"down_pw_{s}", _conv(dim, dim, 1, dtype))
            if _POS_EMBS[s]:
                self.add_module(f"pos_emb_{s}",
                                _conv(dim, dim, 7, dtype, groups=dim))
            block = (RepMixerBlock if _TOKEN_MIXERS[s] == "repmixer"
                     else AttentionBlock)
            for b in range(depth):
                names.append(f"net_{s}_blocks_{b}")
                self.add_module(names[-1], block(dim, dim * ratio, dtype))
            self.stages.append(names)
        final = int(dims[-1] * _CLS_RATIO)
        self.num_features = final
        self.conv_exp = _conv(dims[-1], final, 3, dtype, groups=dims[-1])
        self.conv_exp_se = SqueezeExcite(final, dtype=dtype)
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = images.to(self.dtype)
        x = gelu(self.stem_0(x))
        x = gelu(self.stem_1(x))
        x = gelu(self.stem_2(x))
        for s, names in enumerate(self.stages):
            if s > 0:
                x = gelu(getattr(self, f"down_lkb_{s}")(x))
                x = gelu(getattr(self, f"down_pw_{s}")(x))
            if _POS_EMBS[s]:
                x = getattr(self, f"pos_emb_{s}")(x)
            for name in names:
                x = run_block(getattr(self, name), self.remat,
                              self._context_fn, x)
        x = gelu(self.conv_exp_se(self.conv_exp(x)))
        b, h, w, c = x.shape
        tokens = x.reshape(b, h * w, c)
        return tokens.mean(dim=1), tokens


# --- Apple MobileCLIP checkpoint conversion -------------------------------
#
# Counterpart of ``cosmos_tpu/models/fastvit.py:273-430``: Apple's
# train-form branches (conv + BatchNorm lists, 1x1 scale branches,
# BatchNorm skips, the large-kernel reparameterisation, layer scales) fold
# into the deploy convs above.  The folding runs in numpy in the
# checkpoint's dtype with the JAX package's expressions in its order
# (``t = g / sqrt(var + eps)``, ``w * t``, ``b - mean * t``), so that the
# bits agree; kernels stay OIHW, torch's layout.

def _np(sd, k) -> np.ndarray:
    return np_(sd[k])


def _fuse_conv_bn(sd, prefix: str, eps: float = 1e-5, norm: str = "bn"):
    """conv(bias-free)+BN branch -> (kernel OIHW, bias).  ``norm`` names
    the BN child ('bn' in ml-fastvit's conv_bn, 'norm' in CVNets
    ConvLayer — the MobileCLIP-B stem)."""
    w = _np(sd, f"{prefix}.conv.weight")
    g_ = _np(sd, f"{prefix}.{norm}.weight")
    b = _np(sd, f"{prefix}.{norm}.bias")
    mean = _np(sd, f"{prefix}.{norm}.running_mean")
    var = _np(sd, f"{prefix}.{norm}.running_var")
    t = g_ / np.sqrt(var + eps)
    return w * t[:, None, None, None], b - mean * t


def _dirac(channels: int, groups: int, k: int) -> np.ndarray:
    """Identity mapping as an OIHW conv kernel (RepVGG-style)."""
    in_per_group = channels // groups
    w = np.zeros((channels, in_per_group, k, k), np.float32)
    for i in range(channels):
        w[i, i % in_per_group, k // 2, k // 2] = 1.0
    return w


def _fuse_bn_identity(sd, prefix: str, channels: int, groups: int, k: int,
                      eps: float = 1e-5):
    """BatchNorm-only skip branch -> equivalent (kernel, bias)."""
    g_ = _np(sd, f"{prefix}.weight")
    b = _np(sd, f"{prefix}.bias")
    mean = _np(sd, f"{prefix}.running_mean")
    var = _np(sd, f"{prefix}.running_var")
    t = g_ / np.sqrt(var + eps)
    return _dirac(channels, groups, k) * t[:, None, None, None], b - mean * t


def _pad_to(w: np.ndarray, k: int) -> np.ndarray:
    """Pad a smaller (1x1 scale, 3x3 small) kernel to k x k, centered."""
    p = (k - w.shape[-1]) // 2
    if p == 0:
        return w
    return np.pad(w, ((0, 0), (0, 0), (p, p), (p, p)))


def _fuse_mobileone(sd, prefix: str, in_ch: int, out_ch: int, groups: int,
                    k: int, stride: int):
    """Train-form MobileOneBlock branches -> one (kernel OIHW, bias):
    ``rbr_conv.{j}`` kxk conv+BN list, ``rbr_scale`` 1x1 conv+BN (k > 1
    only), ``rbr_skip`` BatchNorm identity (in == out, stride 1 only)."""
    w = np.zeros((out_ch, in_ch // groups, k, k), np.float32)
    b = np.zeros((out_ch,), np.float32)
    j = 0
    while f"{prefix}.rbr_conv.{j}.conv.weight" in sd:
        wj, bj = _fuse_conv_bn(sd, f"{prefix}.rbr_conv.{j}")
        w, b = w + wj, b + bj
        j += 1
    if f"{prefix}.rbr_scale.conv.weight" in sd:
        ws, bs = _fuse_conv_bn(sd, f"{prefix}.rbr_scale")
        w, b = w + _pad_to(ws, k), b + bs
    if f"{prefix}.rbr_skip.weight" in sd:
        wi, bi = _fuse_bn_identity(sd, f"{prefix}.rbr_skip", out_ch,
                                   groups, k)
        w, b = w + wi, b + bi
    return w, b


def _fuse_replk(sd, prefix: str, k: int):
    """ReparamLargeKernelConv: kxk + small (3x3) conv+BN branches."""
    w, b = _fuse_conv_bn(sd, f"{prefix}.lkb_origin")
    if f"{prefix}.small_conv.conv.weight" in sd:
        ws, bs = _fuse_conv_bn(sd, f"{prefix}.small_conv")
        w, b = w + _pad_to(ws, k), b + bs
    return w, b


def _conv_sd(name: str, w: np.ndarray, b: np.ndarray) -> Dict[str, torch.Tensor]:
    return {f"{name}.weight": torch.from_numpy(np.ascontiguousarray(w)),
            f"{name}.bias": torch.from_numpy(np.ascontiguousarray(b))}


def _ls(sd, key) -> np.ndarray:
    return _np(sd, key).reshape(-1)           # [C,1,1] -> [C]


def infer_fastvit_name(sd: Dict[str, Any], prefix: str = "") -> str:
    """Match an Apple MCi state dict to a registered geometry."""
    dim0 = int(_np(sd, f"{prefix}patch_embed.0.rbr_conv.0.conv.weight"
                   ).shape[0])
    # stage depths: network entries that are block Sequentials hold
    # numbered blocks with convffn params
    depths = []
    for idx in range(16):
        head = f"{prefix}network.{idx}."
        bs = {int(k[len(head):].split(".")[0]) for k in sd
              if k.startswith(head) and ".convffn." in k}
        if bs:
            depths.append(1 + max(bs))
    depths = tuple(depths)
    for name, g in FASTVIT_CONFIGS.items():
        if g["dims"][0] == dim0 and g["layers"] == depths:
            return name
    raise KeyError(
        f"no registered FastViT/MCi geometry matches dims[0]={dim0} "
        f"stage depths={depths}; add one via register_fastvit"
    )


def convert_mobileclip_image(sd: Dict[str, Any], model_name: str,
                             prefix: str = "") -> Dict[str, torch.Tensor]:
    """Apple MobileCLIP's image trunk (train form, keys under ``prefix``)
    as the deploy trunk's state dict (names below ``visual.trunk.``)."""
    g = FASTVIT_CONFIGS[model_name]
    layers, dims, ratios = g["layers"], g["dims"], g["mlp_ratios"]
    d0 = dims[0]
    out: Dict[str, torch.Tensor] = {}
    out.update(_conv_sd("stem_0", *_fuse_mobileone(
        sd, f"{prefix}patch_embed.0", 3, d0, 1, 3, 2)))
    out.update(_conv_sd("stem_1", *_fuse_mobileone(
        sd, f"{prefix}patch_embed.1", d0, d0, d0, 3, 2)))
    out.update(_conv_sd("stem_2", *_fuse_mobileone(
        sd, f"{prefix}patch_embed.2", d0, d0, 1, 1, 1)))
    # ml-fastvit's network index: per stage an optional RepCPE, the block
    # Sequential, then a PatchEmbed (not after the last stage)
    idx = 0
    for s, (depth, dim, ratio) in enumerate(zip(layers, dims, ratios)):
        if _POS_EMBS[s]:
            w = _np(sd, f"{prefix}network.{idx}.pe.weight")
            b = _np(sd, f"{prefix}network.{idx}.pe.bias")
            out.update(_conv_sd(f"pos_emb_{s}", w + _dirac(dim, dim, 7), b))
            idx += 1
        for blk in range(depth):
            p = f"{prefix}network.{idx}.{blk}"
            name = f"net_{s}_blocks_{blk}"
            hidden = dim * ratio
            if _TOKEN_MIXERS[s] == "repmixer":
                # fused RepMixer: I + ls * (mixer - norm)
                wm, bm = _fuse_mobileone(sd, f"{p}.token_mixer.mixer",
                                         dim, dim, dim, 3, 1)
                wn, bn_ = _fuse_mobileone(sd, f"{p}.token_mixer.norm",
                                          dim, dim, dim, 3, 1)
                ls = _ls(sd, f"{p}.token_mixer.layer_scale")
                w = _dirac(dim, dim, 3) + ls[:, None, None, None] * (wm - wn)
                out.update(_conv_sd(f"{name}.mixer", w, ls * (bm - bn_)))
                ffn_ls = _ls(sd, f"{p}.layer_scale")
            else:
                # inference BatchNorm -> per-channel affine
                gm = _np(sd, f"{p}.norm.weight")
                bt = _np(sd, f"{p}.norm.bias")
                mean = _np(sd, f"{p}.norm.running_mean")
                var = _np(sd, f"{p}.norm.running_var")
                t = gm / np.sqrt(var + 1e-5)
                ls1 = _ls(sd, f"{p}.layer_scale_1")
                pw = _np(sd, f"{p}.token_mixer.proj.weight")  # [C, C]
                pb = _np(sd, f"{p}.token_mixer.proj.bias")
                out[f"{name}.norm_scale"] = torch.from_numpy(t)
                out[f"{name}.norm_bias"] = torch.from_numpy(bt - mean * t)
                out[f"{name}.attn.qkv.weight"] = torch.from_numpy(
                    np.ascontiguousarray(_np(sd, f"{p}.token_mixer.qkv.weight")))
                # layer_scale_1 folds into the out projection
                out.update(_conv_sd(f"{name}.attn.proj", pw * ls1[:, None],
                                 pb * ls1))
                ffn_ls = _ls(sd, f"{p}.layer_scale_2")
            out.update(_conv_sd(f"{name}.convffn.conv",
                             *_fuse_conv_bn(sd, f"{p}.convffn.conv")))
            f1w = _np(sd, f"{p}.convffn.fc1.weight").reshape(hidden, dim)
            out.update(_conv_sd(f"{name}.convffn.fc1", f1w,
                             _np(sd, f"{p}.convffn.fc1.bias")))
            # the ConvFFN layer scale folds into fc2
            f2w = _np(sd, f"{p}.convffn.fc2.weight").reshape(dim, hidden)
            f2b = _np(sd, f"{p}.convffn.fc2.bias")
            out.update(_conv_sd(f"{name}.convffn.fc2", f2w * ffn_ls[:, None],
                             f2b * ffn_ls))
        idx += 1
        if s < len(layers) - 1:
            p = f"{prefix}network.{idx}"
            out.update(_conv_sd(f"down_lkb_{s + 1}", *_fuse_replk(
                sd, f"{p}.proj.0", _DOWN_KERNEL)))
            out.update(_conv_sd(f"down_pw_{s + 1}", *_fuse_mobileone(
                sd, f"{p}.proj.1", dims[s + 1], dims[s + 1], 1, 1, 1)))
            idx += 1
    final = int(dims[-1] * _CLS_RATIO)
    out.update(_conv_sd("conv_exp", *_fuse_mobileone(
        sd, f"{prefix}conv_exp", dims[-1], final, dims[-1], 3, 1)))
    se = f"{prefix}conv_exp.se"
    out.update(_conv_sd("conv_exp_se.reduce",
                     _np(sd, f"{se}.reduce.weight").reshape(-1, final),
                     _np(sd, f"{se}.reduce.bias")))
    out.update(_conv_sd("conv_exp_se.expand",
                     _np(sd, f"{se}.expand.weight").reshape(final, -1),
                     _np(sd, f"{se}.expand.bias")))
    return out
