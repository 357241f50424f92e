"""The EVA02 trunk (counterpart of ``cosmos_tpu/models/eva.py``): a ViT
with separate q/k/v projections (k without bias), 2-D axial rotary position
embedding on the patch tokens of q and k (the CLS token is not rotated),
sub-LayerNorms before the attention output projection (``scale_attn``) and
inside the SwiGLU MLP (``scale_mlp``), and a learned position table.

Module and parameter names are timm's ``eva.py`` (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.N.attn.{q,k,v}_proj``,
``attn.norm``, ``attn.proj``, ``mlp.fc1_g/fc1_x/norm/fc2``, ``norm``), the
layout the JAX package's ``convert_timm_eva`` reads.  The attention runs as
the JAX package runs it, on stock ops (its packed-QKV kernel needs a packed
projection): float32 logits, a float32 softmax cast to the compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .convert import rename_
from .layers import LayerNorm, Linear
from .transformer import remat_context_fn, run_block
from .vit import _PatchEmbed, interpolate_pos_embed, patchify

# timm model name -> trunk geometry (the JAX package's EVA_CONFIGS)
EVA_CONFIGS: Dict[str, Dict[str, Any]] = {
    "eva02_tiny_patch14_224": dict(
        patch_size=14, width=192, layers=12, heads=3, scale_mlp=False),
    "eva02_small_patch14_224": dict(
        patch_size=14, width=384, layers=12, heads=6, scale_mlp=False),
    "eva02_base_patch14_224": dict(
        patch_size=14, width=768, layers=12, heads=12, scale_mlp=True),
    "eva02_large_patch14_224": dict(
        patch_size=14, width=1024, layers=24, heads=16, scale_mlp=True),
    "eva02_base_patch16_clip_224": dict(
        patch_size=16, width=768, layers=12, heads=12, scale_mlp=True,
        scale_attn=True),
    "eva02_large_patch14_clip_224": dict(
        patch_size=14, width=1024, layers=24, heads=16, scale_mlp=True,
        scale_attn=True),
    "eva02_large_patch14_clip_336": dict(
        patch_size=14, width=1024, layers=24, heads=16, scale_mlp=True,
        scale_attn=True, image_size=336),
}


def register_eva(name: str, *, patch_size: int, width: int, layers: int,
                 heads: int, scale_mlp: bool = True,
                 scale_attn: bool = False, image_size: int = 224) -> None:
    """Register another EVA02 geometry."""
    EVA_CONFIGS[name] = dict(
        patch_size=patch_size, width=width, layers=layers, heads=heads,
        scale_mlp=scale_mlp, scale_attn=scale_attn, image_size=image_size)


def rope_2d_tables(grid: int, native_grid: int, head_dim: int,
                   theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """(cos, sin) [grid*grid, head_dim] of EVA-02's 2-D axial rope, built
    in numpy as the JAX package builds them: coordinates rescaled to the
    pretraining grid, each angle repeated over a consecutive lane pair, the
    row angles in the first half of the head dim, the column angles in the
    second."""
    dim = head_dim // 2
    freqs = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    t = np.arange(grid, dtype=np.float64) / grid * native_grid
    ang = np.repeat(np.outer(t, freqs), 2, axis=-1)       # [g, dim]
    row = np.broadcast_to(ang[:, None, :], (grid, grid, dim))
    col = np.broadcast_to(ang[None, :, :], (grid, grid, dim))
    full = np.concatenate([row, col], axis=-1).reshape(grid * grid, head_dim)
    return (np.cos(full).astype(np.float32),
            np.sin(full).astype(np.float32))


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) consecutive lane pairs -> (-x2, x1)."""
    x = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-x[..., 1], x[..., 0]], dim=-1).flatten(-2)


def apply_rope(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               num_prefix: int = 1) -> torch.Tensor:
    """Rotate the patch tokens of [B, H, L, hd]; prefix tokens pass."""
    prefix, x = t[:, :, :num_prefix], t[:, :, num_prefix:]
    x = x * cos.to(x.dtype) + _rotate_half(x) * sin.to(x.dtype)
    return torch.cat([prefix, x], dim=2)


class EvaAttention(nn.Module):
    """Separate-q/k/v attention with rope and the optional sub-LN."""

    def __init__(self, width: int, num_heads: int, scale_attn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = Linear(width, width, dtype=dtype)
        self.k_proj = Linear(width, width, bias=False, dtype=dtype)
        self.v_proj = Linear(width, width, dtype=dtype)
        self.norm = LayerNorm(width, eps=1e-6) if scale_attn else None
        self.proj = Linear(width, width, dtype=dtype)

    def forward(self, x: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        b, l, d = x.shape
        hd = d // self.num_heads

        def heads(t):
            return t.reshape(b, l, self.num_heads, hd).transpose(1, 2)

        q, k, v = heads(self.q_proj(x)), heads(self.k_proj(x)), \
            heads(self.v_proj(x))
        q, k = apply_rope(q, *rope), apply_rope(k, *rope)
        s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
        o = torch.matmul(torch.softmax(s, dim=-1).to(v.dtype), v)
        o = o.transpose(1, 2).reshape(b, l, d)
        if self.norm is not None:
            o = self.norm(o)
        return self.proj(o)


class EvaMlp(nn.Module):
    """SwiGLU: ``fc2(norm(silu(fc1_g(x)) * fc1_x(x)))``."""

    def __init__(self, width: int, hidden: int, scale_mlp: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1_g = Linear(width, hidden, dtype=dtype)
        self.fc1_x = Linear(width, hidden, dtype=dtype)
        self.norm = LayerNorm(hidden, eps=1e-6) if scale_mlp else None
        self.fc2 = Linear(hidden, width, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        m = F.silu(self.fc1_g(x)) * self.fc1_x(x)
        if self.norm is not None:
            m = self.norm(m)
        return self.fc2(m)


class EvaBlock(nn.Module):
    def __init__(self, width: int, num_heads: int, scale_mlp: bool = True,
                 scale_attn: bool = False, mlp_ratio: float = 4 * 2 / 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = LayerNorm(width, eps=1e-6)
        self.attn = EvaAttention(width, num_heads, scale_attn, dtype)
        self.norm2 = LayerNorm(width, eps=1e-6)
        self.mlp = EvaMlp(width, int(mlp_ratio * width), scale_mlp, dtype)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), (cos, sin))
        return x + self.mlp(self.norm2(x))


class Eva(nn.Module):
    """EVA02 trunk: ``(pooled [B, width], tokens [B, 1 + N, width])``,
    ``pooled`` the CLS token after the final norm (``token``) or the mean
    of the patch tokens (``avg``).  At another input grid than the native
    one, the position table is resampled (bicubic with antialiasing, as
    timm resamples it) and the rope tables are built for that grid."""

    def __init__(self, model_name: str, pool: str = "token",
                 dtype: torch.dtype = torch.float32,
                 remat: bool = False, remat_policy: str = ""):
        super().__init__()
        g = EVA_CONFIGS[model_name]
        self.patch_size, self.width = g["patch_size"], g["width"]
        self.num_heads, self.pool, self.dtype = g["heads"], pool, dtype
        self.num_features = self.width
        self.native_grid = g.get("image_size", 224) // self.patch_size
        self.patch_embed = _PatchEmbed(self.patch_size, self.width)
        self.cls_token = nn.Parameter(torch.empty(1, 1, self.width))
        self.pos_embed = nn.Parameter(torch.empty(
            1, self.native_grid ** 2 + 1, self.width))
        self.blocks = nn.ModuleList(
            EvaBlock(self.width, g["heads"], g.get("scale_mlp", True),
                     g.get("scale_attn", False), dtype=dtype)
            for _ in range(g["layers"]))
        self.norm = LayerNorm(self.width, eps=1e-6)
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)
        self._rope: Dict[Any, Tuple[torch.Tensor, torch.Tensor]] = {}

    def init_weights(self, generator: torch.Generator) -> None:
        for p in (self.cls_token, self.pos_embed):
            nn.init.normal_(p, std=0.02, generator=generator)

    def rope(self, grid: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The (cos, sin) tables of ``grid`` on ``device``, built once."""
        key = (grid, str(device))
        if key not in self._rope:
            cos, sin = rope_2d_tables(grid, self.native_grid,
                                      self.width // self.num_heads)
            self._rope[key] = (torch.from_numpy(cos).to(device),
                               torch.from_numpy(sin).to(device))
        return self._rope[key]

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, h = images.shape[0], images.shape[1]
        grid = h // self.patch_size
        x = patchify(images, self.patch_embed.proj.weight,
                     self.patch_embed.proj.bias, self.dtype)
        x = x.reshape(b, -1, self.width)
        cls = self.cls_token.to(x.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1)
        native = (self.native_grid, self.native_grid)
        pos = interpolate_pos_embed(self.pos_embed[0], native, (grid, grid),
                                    antialias=True)
        x = x + pos.to(x.dtype)
        cos, sin = self.rope(grid, x.device)
        for block in self.blocks:
            x = run_block(block, self.remat, self._context_fn, x, cos, sin)
        x = self.norm(x)
        pooled = x[:, 0] if self.pool == "token" else x[:, 1:].mean(dim=1)
        return pooled, x


# --- timm checkpoint conversion (cosmos_tpu/models/eva.py:264-358) --------

def infer_timm_eva_name(sd: Dict[str, Any]) -> str:
    """Match a timm EVA02 state dict to a registered geometry by shapes
    and by the presence of the sub-LN keys."""
    w = int(sd["cls_token"].reshape(-1).shape[0])
    p = int(sd["patch_embed.proj.weight"].shape[-1])
    layers = 1 + max(int(k.split(".")[1]) for k in sd
                     if k.startswith("blocks."))
    n_pos = int(sd["pos_embed"].shape[1])
    img = int(round((n_pos - 1) ** 0.5)) * p
    scale_attn = "blocks.0.attn.norm.weight" in sd
    for name, g in EVA_CONFIGS.items():
        if (g["width"] == w and g["patch_size"] == p
                and g["layers"] == layers
                and g.get("image_size", 224) == img
                and g.get("scale_attn", False) == scale_attn):
            return name
    raise KeyError(
        f"no registered EVA02 geometry matches width={w} patch={p} "
        f"layers={layers} img={img} scale_attn={scale_attn}; add one via "
        "register_eva"
    )


def _mlp_keys(sd: Dict[str, Any], blk: str) -> Dict[str, str]:
    """timm eva.py SwiGLU names (fc1_g/fc1_x/norm/fc2) by this trunk's
    names, from timm's keys or the original EVA-02 repo's (w1/w2/ffn_ln/w3)."""
    if f"{blk}.mlp.fc1_g.weight" in sd:
        return {n: f"{blk}.mlp.{n}" for n in ("fc1_g", "fc1_x", "norm", "fc2")}
    if f"{blk}.mlp.w1.weight" in sd:
        return {"fc1_g": f"{blk}.mlp.w1", "fc1_x": f"{blk}.mlp.w2",
                "norm": f"{blk}.mlp.ffn_ln", "fc2": f"{blk}.mlp.w3"}
    raise KeyError(
        f"{blk}: plain-MLP EVA variants (mlp.fc1/fc2, swiglu_mlp=False) "
        "are not supported — EVA02 towers are all SwiGLU"
    )


def convert_timm_eva(sd: Dict[str, Any], model_name: str
                     ) -> Dict[str, torch.Tensor]:
    """A timm EVA02 state dict as the trunk's state dict (names below
    ``visual.trunk.``): timm's names, the original repo's MLP names renamed,
    ``k_proj``'s bias (if any) dropped.  The rope tables carry no weights;
    the classifier head is loaded by ``convert._maybe_load_timm_head``.
    Fused-qkv EVA variants (eva_giant) raise."""
    g = EVA_CONFIGS[model_name]
    w = g["width"]
    if "blocks.0.attn.qkv.weight" in sd:
        raise NotImplementedError(
            "fused-qkv EVA (eva_giant family) is not supported; EVA02 "
            "checkpoints use separate q/k/v projections"
        )
    pairs = [(k, k) for k in ("patch_embed.proj.weight",
                              "patch_embed.proj.bias", "norm.weight",
                              "norm.bias")]
    for i in range(g["layers"]):
        blk = f"blocks.{i}"
        mk = _mlp_keys(sd, blk)
        names = ["norm1", "norm2", "attn.q_proj", "attn.v_proj", "attn.proj"]
        if f"{blk}.attn.norm.weight" in sd:
            names.append("attn.norm")
        pairs += [(f"{blk}.{n}.{leaf}", f"{blk}.{n}.{leaf}")
                  for n in names for leaf in ("weight", "bias")]
        pairs.append((f"{blk}.attn.k_proj.weight", f"{blk}.attn.k_proj.weight"))
        mlp = ["fc1_g", "fc1_x", "fc2"]
        if f"{mk['norm']}.weight" in sd:
            mlp.append("norm")
        pairs += [(f"{blk}.mlp.{n}.{leaf}", f"{mk[n]}.{leaf}")
                  for n in mlp for leaf in ("weight", "bias")]
    out = rename_(sd, pairs)
    out["cls_token"] = torch.as_tensor(sd["cls_token"]).reshape(1, 1, w)
    out["pos_embed"] = torch.as_tensor(sd["pos_embed"]).reshape(1, -1, w)
    return out
