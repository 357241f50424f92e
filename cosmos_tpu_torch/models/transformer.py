"""Residual transformer stack shared by both towers (counterpart of
``cosmos_tpu/models/transformer.py``).

``fuse_ln=True`` runs each block's pre-LayerNorms inside the following
kernels: ``ln_1`` → packed QKV projection as K5
(``ops.experimental.ln_matmul``) and ``ln_2`` → c_fc → act → c_proj as K6
(``ops.experimental.mlp_block``).  The blocks keep their ``ln_1``/``ln_2``
modules and hand their parameters to the kernels, so the state-dict names
are the same with and without it.

``remat=True`` recomputes each block in the backward
(``torch.utils.checkpoint``, non-reentrant), JAX's ``nn.remat`` per block.
``remat_policy`` takes JAX's ``jax.checkpoint_policies`` names and keeps
the aten ops they name (``REMAT_POLICIES``, selective checkpointing).  The
kernels are operators of the ``cosmos_tpu_torch`` namespace, which the
policies see as JAX's see the Pallas calls: a kernel's output is no
``dot_general``, so every policy but ``everything_saveable`` runs K1 (and
K3, K5, K6 where they are on) again in the backward, and
``everything_saveable`` keeps their outputs."""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .attention import MultiheadAttention
from .layers import LayerNorm, LayerScale, Mlp, gelu


_aten = torch.ops.aten
# the matmuls without and with batch dims, as aten sees F.linear/torch.matmul
_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
# JAX's policy name -> the aten ops to keep (None: keep none, "all": every
# op's output)
REMAT_POLICIES = {
    "": None,
    "nothing_saveable": None,
    "dots_saveable": _DOTS + _BATCH_DOTS,
    "checkpoint_dots": _DOTS + _BATCH_DOTS,
    "dots_with_no_batch_dims_saveable": _DOTS,
    "checkpoint_dots_with_no_batch_dims": _DOTS,
    "everything_saveable": "all",
}


def _keep(saved, ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if saved == "all" or op in saved:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_context_fn(policy: str):
    """``checkpoint``'s ``context_fn`` for a JAX policy name (None: the
    default, recompute everything); an unknown name raises."""
    if policy not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {policy!r}; the port maps "
            f"{sorted(p for p in REMAT_POLICIES if p)}")
    saved = REMAT_POLICIES[policy]
    if saved is None:
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             functools.partial(_keep, saved))


def run_block(block: nn.Module, remat: bool, context_fn, *args):
    """``block(*args)``; under ``remat``, recomputed in the backward
    (``checkpoint``, non-reentrant, with ``context_fn`` from
    ``remat_context_fn``).  Without a gradient (the teacher, the evals)
    nothing is recomputed."""
    if remat and torch.is_grad_enabled():
        kw = {} if context_fn is None else {"context_fn": context_fn}
        return checkpoint(block, *args, use_reentrant=False, **kw)
    return block(*args)


class ResidualAttentionBlock(nn.Module):
    """Pre-LN attention and pre-LN MLP, each with an optional LayerScale.

    ``is_cross_attention`` (CoCa's decoder) adds ``ln_1_kv``, the LayerNorm
    of the keys' and values' input ``kv``; ``fuse_ln`` stays off for such a
    block, as JAX's gate keeps it off."""

    def __init__(self, width: int, num_heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False,
                 use_flash: Optional[bool] = None,
                 is_cross_attention: bool = False):
        super().__init__()
        self.fuse_ln = fuse_ln and not is_cross_attention
        self.ln_1 = LayerNorm(width)
        if is_cross_attention:
            self.ln_1_kv = LayerNorm(width)
        self.attn = MultiheadAttention(width, num_heads, dtype=dtype,
                                       use_flash=use_flash)
        self.ls_1 = (LayerScale(width, ls_init_value)
                     if ls_init_value is not None else nn.Identity())
        self.ln_2 = LayerNorm(width)
        self.mlp = Mlp(width, int(width * mlp_ratio), act_fn=act_fn,
                       dtype=dtype)
        self.ls_2 = (LayerScale(width, ls_init_value)
                     if ls_init_value is not None else nn.Identity())

    def forward(self, x: torch.Tensor, causal: bool = False,
                csa: bool = False, mask: Optional[torch.Tensor] = None,
                kv: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: an additive attention mask (the plain path); ``kv``:
        the keys' and values' input of a cross-attention block."""
        if self.fuse_ln:
            x = x + self.ls_1(self.attn(
                x, causal=causal, ln=(self.ln_1.weight, self.ln_1.bias),
                csa=csa, mask=mask))
            return x + self.ls_2(self.mlp(
                x, ln=(self.ln_2.weight, self.ln_2.bias)))
        if kv is not None:
            kv = self.ln_1_kv(kv)
        x = x + self.ls_1(self.attn(self.ln_1(x), kv=kv, mask=mask,
                                    causal=causal, csa=csa))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, num_heads: int,
                 mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32, fuse_ln: bool = False,
                 remat: bool = False, remat_policy: str = "",
                 use_flash: Optional[bool] = None):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads, mlp_ratio, ls_init_value,
                                   act_fn, dtype, fuse_ln, use_flash)
            for _ in range(layers)
        )
        self.remat = remat
        self._context_fn = remat_context_fn(remat_policy)

    def forward(self, x: torch.Tensor, causal: bool = False,
                csa_last_block: bool = False,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``csa_last_block``: the last block runs SCLIP's correlative
        self-attention with no causal structure (the segmentor's path).
        ``mask``: an additive mask for every block (CoCa's text tower)."""
        last = len(self.resblocks) - 1
        for i, block in enumerate(self.resblocks):
            csa = csa_last_block and i == last
            x = run_block(block, self.remat, self._context_fn, x,
                          causal and not csa, csa, mask)
        return x
