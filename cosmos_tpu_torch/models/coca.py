"""CoCa, the contrastive captioner (counterpart of ``cosmos_tpu/models/coca.py``).

A ViT whose patch tokens an attentional pooler reads with learned queries
(query 0 becomes the contrastive latent, queries 1.. condition the
decoder), a text tower with an appended CLS token (``text.py``
``TextTransformer``) and a multimodal decoder of [causal self-attention,
cross-attention over the image tokens] block pairs that projects to the
vocabulary.  The captioning labels are the teacher-forced shifted text.

Where the vision width equals the decoder's width (``coca_Tiny-Test``),
this is the JAX package's function parameter for parameter.  The one
change: the pooler's output width is the decoder's (``multimodal_cfg.
width``), its keys and values projected from the vision width, as in
OpenCLIP's ``AttentionalPooler(d_model, context_dim)``; JAX's pooler keeps
its input's width, so JAX's CoCa does not build where the widths differ
(``coca_ViT-B-32``: 768 against 512).  The vision call skips the ViT's own
projection, and ``visual.proj`` (``[multimodal width, embed_dim]``)
projects the pooled latent.

Routing follows JAX's: the vision tower's self-attention takes K1 (and K2
in the backward); the masked text tower, the decoder's masked
self-attention, its cross-attention and the pooler take the plain path.

State-dict names: OpenCLIP's CoCa names where the part exists there with the
same function (``text.*`` with ``text.cls_emb``,
``text_decoder.resblocks.N``, ``text_decoder.cross_attn.N`` with
``ln_1_kv``, ``text_decoder.ln_final``, ``text_decoder.text_projection``,
``logit_scale``, ``visual.*``), the JAX tree's paths with dots for the
pooler, which OpenCLIP lays out inside the ViT (``attn_pool.*``,
``ln_attn_pool.*``).

``generate`` and ``beam_search_generate`` are JAX's fixed-shape decoders: a
``[B, seq_len]`` buffer (``[B, beams, seq_len]`` for beams) re-encoded in
full at every position.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from .attention import AttentionalPooler
from .config import CLIPCfg, MultimodalCfg, TextCfg
from .layers import LayerNorm, gelu, get_act_fn, l2_normalize
from .text import TextTransformer, additive_causal_mask
from .transformer import ResidualAttentionBlock
from .vit import VisionTransformer


class MultimodalTransformer(nn.Module):
    """The decoder: per layer a causal self-attention block
    (``resblocks.N``) and a cross-attention block over the image tokens
    (``cross_attn.N``), then ``ln_final`` and the vocabulary projection."""

    def __init__(self, width: int, layers: int, num_heads: int,
                 mlp_ratio: float = 4.0, vocab_size: int = 49408,
                 act_fn: Callable[[torch.Tensor], torch.Tensor] = gelu,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads, mlp_ratio, act_fn=act_fn,
                                   dtype=dtype) for _ in range(layers))
        self.cross_attn = nn.ModuleList(
            ResidualAttentionBlock(width, num_heads, mlp_ratio, act_fn=act_fn,
                                   dtype=dtype, is_cross_attention=True)
            for _ in range(layers))
        self.ln_final = LayerNorm(width)
        self.text_projection = nn.Parameter(torch.empty(width, vocab_size))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.text_projection, std=self.width ** -0.5,
                        generator=generator)

    def forward(self, image_embs: torch.Tensor,
                text_embs: torch.Tensor) -> torch.Tensor:
        """[B, N, width] image tokens, [B, L, width] text tokens ->
        [B, L, vocab] logits in the compute dtype."""
        mask = additive_causal_mask(text_embs.shape[1], text_embs.device)
        x = text_embs
        for block, cross in zip(self.resblocks, self.cross_attn):
            x = block(x, mask=mask)
            x = cross(x, kv=image_embs)
        x = self.ln_final(x)
        return torch.matmul(x.to(self.dtype),
                            self.text_projection.to(self.dtype))


class CoCa(nn.Module):
    """``forward(images, text, output_labels)`` returns JAX's keys:
    ``image_features``, ``text_features`` (normalised), ``logits``,
    ``labels`` (with ``output_labels``) and ``logit_scale``; with no text,
    ``image_features`` and ``image_embs``.  ``encode_image`` and
    ``encode_text`` return the bare features, as JAX's do."""

    def __init__(self, cfg: CLIPCfg, pad_id: int = 0,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 remat_policy: str = "", use_flash: Optional[bool] = None):
        super().__init__()
        v, t = cfg.vision_cfg, cfg.text_cfg
        mm = cfg.multimodal_cfg or MultimodalCfg()
        if v.timm_model_name or not isinstance(v.layers, int):
            raise ValueError("CoCa's vision tower is the native ViT")
        self.cfg, self.pad_id, self.dtype = cfg, pad_id, dtype
        act = get_act_fn("quick_gelu" if cfg.quick_gelu else "gelu")
        # the options JAX's CoCa passes to its towers, and no others
        self.visual = VisionTransformer(
            image_size=v.image_size, patch_size=v.patch_size, width=v.width,
            layers=v.layers, num_heads=v.heads, mlp_ratio=v.mlp_ratio,
            output_dim=cfg.embed_dim, pool_type=v.pool_type, act_fn=act,
            dtype=dtype, remat=remat, remat_policy=remat_policy,
            use_flash=use_flash, proj_in=mm.width)
        self.attn_pool = AttentionalPooler(
            mm.width, v.width, v.attn_pooler_queries, mm.attn_pooler_heads,
            dtype)
        self.ln_attn_pool = LayerNorm(mm.width)
        text_cfg = TextCfg(context_length=t.context_length,
                           vocab_size=t.vocab_size, width=t.width,
                           heads=t.heads, layers=t.layers,
                           mlp_ratio=t.mlp_ratio, embed_cls=True,
                           pad_id=pad_id)
        self.text = TextTransformer(text_cfg, cfg.embed_dim, act, dtype,
                                    remat=remat, remat_policy=remat_policy,
                                    use_flash=use_flash)
        self.text_decoder = MultimodalTransformer(
            mm.width, mm.layers, mm.heads, mm.mlp_ratio, t.vocab_size, act,
            dtype)
        self.logit_scale = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator) -> None:
        nn.init.constant_(self.logit_scale, self.cfg.init_logit_scale)

    def _encode_image(self, images: torch.Tensor, normalize: bool = True,
                      patch_drop: Optional[torch.Generator] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent [B, embed_dim], image tokens [B, n_queries - 1,
        multimodal width])."""
        tokens = self.visual.tokens(images, patch_drop=patch_drop)[:, 1:]
        pooled = self.ln_attn_pool(self.attn_pool(tokens))
        latent, embs = pooled[:, 0], pooled[:, 1:]
        latent = torch.matmul(latent.to(self.dtype),
                              self.visual.proj.to(self.dtype))
        return (l2_normalize(latent) if normalize else latent), embs

    def _encode_text(self, text: torch.Tensor, normalize: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(latent [B, embed_dim], token states [B, L, text width])."""
        latent, token_embs = self.text(text)
        return (l2_normalize(latent) if normalize else latent), token_embs

    def encode_image(self, images: torch.Tensor,
                     normalize: bool = True) -> torch.Tensor:
        return self._encode_image(images, normalize)[0]

    def encode_text(self, text: torch.Tensor,
                    normalize: bool = True) -> torch.Tensor:
        return self._encode_text(text, normalize)[0]

    def forward(self, images: torch.Tensor,
                text: Optional[torch.Tensor] = None,
                output_labels: bool = True,
                patch_drop: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        image_latent, image_embs = self._encode_image(images,
                                                      patch_drop=patch_drop)
        if text is None:
            return {"image_features": image_latent, "image_embs": image_embs}
        text_latent, token_embs = self._encode_text(text)
        out: Dict[str, torch.Tensor] = {}
        if output_labels:
            # teacher forcing: the logits at position i predict token i+1
            out["labels"] = text[:, 1:]
            token_embs = token_embs[:, :-1]
        out.update(image_features=image_latent, text_features=text_latent,
                   logits=self.text_decoder(image_embs, token_embs),
                   logit_scale=self.logit_scale.exp())
        return out

    def decode_logits(self, image_embs: torch.Tensor,
                      tokens: torch.Tensor) -> torch.Tensor:
        """The decoder's [B, L, vocab] logits over token ids [B, L]."""
        return self.text_decoder(image_embs, self._encode_text(tokens)[1])


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF's nucleus filter (JAX's ``generate``): keep the smallest set of
    most probable tokens whose mass reaches ``top_p`` (a token survives
    while the mass before it is below ``top_p``, so at least one does);
    the others get -1e30."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < top_p).sum(dim=-1, keepdim=True)
    cutoff = sorted_logits.gather(-1, keep - 1)
    return logits.masked_fill(logits < cutoff, -1e30)


def _sample(logits: torch.Tensor,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw a row from softmax(logits)."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(model: CoCa, images: torch.Tensor, *, seq_len: int = 30,
             sot_token_id: int = 49406, eot_token_id: int = 49407,
             pad_token_id: int = 0, temperature: float = 1.0,
             generation_type: str = "top_p", top_k: int = 1,
             top_p: float = 0.1, min_seq_len: int = 5,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """[B, seq_len] token ids, padded after EOT: greedy, ``top_k`` or
    ``top_p`` (HF's nucleus) sampling, drawing from ``generator``, with EOT
    barred below ``min_seq_len``."""
    if generation_type not in ("greedy", "top_k", "top_p"):
        raise ValueError(generation_type)
    b = images.shape[0]
    image_embs = model._encode_image(images)[1]
    tokens = torch.full((b, seq_len), pad_token_id, dtype=torch.long,
                        device=images.device)
    tokens[:, 0] = sot_token_id
    done = torch.zeros(b, dtype=torch.bool, device=images.device)
    for i in range(1, seq_len):
        logits = model.decode_logits(image_embs, tokens)[:, i - 1]
        logits = logits / temperature
        if i < min_seq_len:
            logits[:, eot_token_id] = -1e30
        if generation_type == "greedy" or (generation_type == "top_k"
                                           and top_k == 1):
            nxt = logits.argmax(dim=-1)
        elif generation_type == "top_k":
            vals, idxs = torch.topk(logits, top_k, dim=-1)
            nxt = idxs.gather(-1, _sample(vals, generator)[:, None])[:, 0]
        else:
            nxt = _sample(top_p_filter(logits, top_p), generator)
        nxt = torch.where(done, pad_token_id, nxt)
        tokens[:, i] = nxt
        done |= nxt == eot_token_id
    return tokens


@torch.no_grad()
def beam_search_generate(model: CoCa, images: torch.Tensor, *,
                         num_beams: int = 6, seq_len: int = 30,
                         sot_token_id: int = 49406,
                         eot_token_id: int = 49407, pad_token_id: int = 0,
                         min_seq_len: int = 5,
                         length_penalty: float = 1.0) -> torch.Tensor:
    """JAX's fixed-shape beam search: ``[B, beams, seq_len]`` buffers,
    beam 0 alone live at the start, finished beams extended with pad at no
    cost, the best beam by score / length ** ``length_penalty``.
    Returns [B, seq_len]."""
    b, k = images.shape[0], num_beams
    dev = images.device
    embs = model._encode_image(images)[1].repeat_interleave(k, dim=0)
    neg = -1e9
    tokens = torch.full((b, k, seq_len), pad_token_id, dtype=torch.long,
                        device=dev)
    tokens[:, :, 0] = sot_token_id
    scores = torch.full((b, k), neg, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros(b, k, dtype=torch.bool, device=dev)
    for i in range(1, seq_len):
        logits = model.decode_logits(embs, tokens.reshape(b * k, seq_len))
        logp = torch.log_softmax(logits[:, i - 1].float(), dim=-1)
        logp = logp.reshape(b, k, -1)
        vocab = logp.shape[-1]
        if i < min_seq_len:
            logp[..., eot_token_id] = neg
        pad_only = torch.full((vocab,), neg, device=dev)
        pad_only[pad_token_id] = 0.0
        logp = torch.where(done[..., None], pad_only, logp)
        cand = (scores[..., None] + logp).reshape(b, k * vocab)
        scores, top = torch.topk(cand, k, dim=-1)
        beam, tok = top // vocab, top % vocab
        tokens = tokens.gather(1, beam[..., None].expand(-1, -1, seq_len))
        tokens[:, :, i] = tok
        done = done.gather(1, beam) | (tok == eot_token_id)
    lengths = (tokens != pad_token_id).sum(dim=-1).float()
    best = (scores / lengths ** length_penalty).argmax(dim=-1)
    return tokens[torch.arange(b, device=dev), best]
