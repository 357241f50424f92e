"""The port's stand-in for ``transformers.AutoConfig.for_model`` and
``AutoConfig.from_pretrained`` on a local directory: an offline
``hf_model_config`` dict, or the dict a directory's ``config.json`` holds
(``model_type`` and the config's fields), as a namespace with the defaults
of transformers' config class of the type for every field the port's
encoders read (``cosmos_tpu/models/hf_model.py`` ``resolve_hf_config``):
``hf_bert.py`` (BERT, RoBERTa, XLM-RoBERTa, ELECTRA,
RoBERTa-PreLayerNorm), ``hf_distilbert.py``, ``hf_albert.py``,
``hf_t5.py`` (T5, mT5), and the decoder LMs ``hf_gpt2.py`` (GPT-2, which
also serves ``gpt-sw3``: ``AutoConfig.for_model("gpt-sw3")`` is a
``GPT2Config`` of ``model_type`` ``gpt2``), ``hf_opt.py`` and
``hf_llama.py`` (Llama, Mistral, Gemma).  The dict's other keys
(transformers' bookkeeping: ``architectures``, ``transformers_version``,
``torch_dtype``, dropout rates, ...) are left out.  The port never imports ``transformers``: the
card's machine does not have it.

T5's ``feed_forward_proj`` parses as transformers parses it: ``"relu"`` or
``"gated-<act>"``, with ``"gated-gelu"`` meaning the gated ``gelu_new``;
a saved config's own ``dense_act_fn`` and ``is_gated_act`` win over the
parse, as they do in ``T5Config``.  DistilBERT's config takes BERT's
names for its own (``hidden_size`` for ``dim``, ...), as its
``attribute_map`` does; GPT-2's takes them for ``n_embd``, ``n_layer``,
``n_head`` and ``n_positions``.  As their configs do, Llama and Mistral
fill an unset ``num_key_value_heads`` with ``num_attention_heads``, and
OPT an unset ``word_embed_proj_dim`` with ``hidden_size``.  ``mlp_act``
is the activation the Flax MLP of a Llama-family type applies: Llama's
and Mistral's ``hidden_act``; Gemma's ``hidden_activation``, and
``gelu_pytorch_tanh`` where that is unset, whatever ``hidden_act`` says
(``FlaxGemmaMLP``).

A type is refused as the JAX package refuses it, in its order of checks,
by the lists of ``assets/hf_model_types.json`` (taken from transformers
4.57.6 by ``tests/torch_hf_types.py``): a type transformers does not know
raises ``AutoConfig.for_model``'s ``ValueError``; an encoder-decoder config
other than T5's and mT5's raises JAX's ``NotImplementedError``; so does a
type with no Flax model; a Flax type that takes no token ids raises the
exception class JAX's tower raises on it; a Flax text type the port has
not written yet names the ``ROADMAP.md`` item that would add it.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict

# the encoders of hf_bert.py, each of whose Flax modules reads is_decoder
# (a causal self-attention)
BERT_FAMILY = ("bert", "roberta", "xlm-roberta", "electra",
               "roberta-prelayernorm")
T5_FAMILY = ("t5", "mt5")
# the decoder LMs of hf_llama.py
LLAMA_FAMILY = ("llama", "mistral", "gemma")
# the types AutoConfig.for_model resolves to another type's config
TYPE_ALIASES = {"gpt-sw3": "gpt2"}

_BERT = dict(vocab_size=30522, hidden_size=768, num_hidden_layers=12,
             num_attention_heads=12, intermediate_size=3072,
             hidden_act="gelu", max_position_embeddings=512,
             type_vocab_size=2, initializer_range=0.02, layer_norm_eps=1e-12,
             pad_token_id=0, is_decoder=False, add_cross_attention=False,
             is_encoder_decoder=False)
_T5 = dict(vocab_size=32128, d_model=512, d_kv=64, d_ff=2048, num_layers=6,
           num_heads=8, relative_attention_num_buckets=32,
           relative_attention_max_distance=128, layer_norm_epsilon=1e-6,
           initializer_factor=1.0, feed_forward_proj="relu",
           tie_word_embeddings=True, pad_token_id=0, is_decoder=False,
           is_encoder_decoder=True)
_LLAMA = dict(vocab_size=32000, hidden_size=4096, intermediate_size=11008,
              num_hidden_layers=32, num_attention_heads=32,
              num_key_value_heads=None, hidden_act="silu",
              max_position_embeddings=2048, initializer_range=0.02,
              rms_norm_eps=1e-6, pad_token_id=None, is_encoder_decoder=False)
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "bert": _BERT,
    "roberta": dict(_BERT, vocab_size=50265, pad_token_id=1),
    "xlm-roberta": dict(_BERT, pad_token_id=1),
    # ElectraConfig's defaults are electra-small's
    "electra": dict(_BERT, embedding_size=128, hidden_size=256,
                    num_attention_heads=4, intermediate_size=1024),
    "roberta-prelayernorm": dict(_BERT, vocab_size=50265, pad_token_id=1),
    "distilbert": dict(vocab_size=30522, max_position_embeddings=512,
                       sinusoidal_pos_embds=False, n_layers=6, n_heads=12,
                       dim=768, hidden_dim=3072, activation="gelu",
                       initializer_range=0.02, pad_token_id=0,
                       is_encoder_decoder=False),
    # AlbertConfig's defaults are albert-xxlarge's
    "albert": dict(vocab_size=30000, embedding_size=128, hidden_size=4096,
                   num_hidden_layers=12, num_hidden_groups=1,
                   num_attention_heads=64, intermediate_size=16384,
                   inner_group_num=1, hidden_act="gelu_new",
                   max_position_embeddings=512, type_vocab_size=2,
                   initializer_range=0.02, layer_norm_eps=1e-12,
                   pad_token_id=0, is_encoder_decoder=False),
    "t5": _T5,
    "mt5": dict(_T5, vocab_size=250112, d_ff=1024, num_layers=8,
                num_heads=6, feed_forward_proj="gated-gelu",
                tie_word_embeddings=False),
    "gpt2": dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
                 n_head=12, n_inner=None, activation_function="gelu_new",
                 layer_norm_epsilon=1e-5, initializer_range=0.02,
                 pad_token_id=None, is_encoder_decoder=False),
    "opt": dict(vocab_size=50272, hidden_size=768, num_hidden_layers=12,
                ffn_dim=3072, max_position_embeddings=2048,
                do_layer_norm_before=True, _remove_final_layer_norm=False,
                word_embed_proj_dim=None, num_attention_heads=12,
                activation_function="relu", init_std=0.02, pad_token_id=1,
                is_encoder_decoder=False),
    # LlamaConfig's defaults are Llama-2-7B's, MistralConfig's
    # Mistral-7B's, GemmaConfig's gemma-7b's
    "llama": dict(_LLAMA, attention_bias=False),
    "mistral": dict(_LLAMA, intermediate_size=14336, num_key_value_heads=8,
                    max_position_embeddings=131072, sliding_window=4096),
    "gemma": dict(_LLAMA, vocab_size=256000, hidden_size=3072,
                  intermediate_size=24576, num_hidden_layers=28,
                  num_attention_heads=16, num_key_value_heads=16,
                  head_dim=256, hidden_act="gelu_pytorch_tanh",
                  hidden_activation=None, max_position_embeddings=8192,
                  pad_token_id=0, attention_bias=False),
}
# DistilBertConfig.attribute_map, GPT2Config.attribute_map
ALIASES = {"distilbert": {"hidden_size": "dim", "num_attention_heads":
                          "n_heads", "num_hidden_layers": "n_layers"},
           "gpt2": {"hidden_size": "n_embd", "max_position_embeddings":
                    "n_positions", "num_attention_heads": "n_head",
                    "num_hidden_layers": "n_layer"}}

UNPORTED = ("the ROADMAP.md item \"HF text towers: Flax architectures the "
            "port has not written\"")
# the Flax types that take no token ids, and the exception class JAX's
# tower raises on a tiny config of each (its init feeds them the captions)
NO_TEXT = {"beit": ValueError, "clip": ValueError, "dinov2": TypeError,
           "regnet": TypeError, "resnet": TypeError, "vit": TypeError,
           "wav2vec2": NotImplementedError,
           "vision-text-dual-encoder": ValueError}
_TYPES = Path(__file__).resolve().parent.parent / "assets" \
    / "hf_model_types.json"


@lru_cache()
def model_types() -> Dict[str, Any]:
    """``assets/hf_model_types.json``: ``known``, ``encoder_decoder``,
    ``flax``."""
    return json.loads(_TYPES.read_text())


def _parse_ff(proj: str):
    """``feed_forward_proj`` -> (``dense_act_fn``, ``is_gated_act``), as
    ``T5Config`` sets them."""
    info = proj.split("-")
    if (len(info) > 1 and info[0] != "gated") or len(info) > 2:
        raise ValueError(
            f"`feed_forward_proj`: {proj} is not a valid activation function "
            "of the dense layer. Please make sure `feed_forward_proj` is of "
            "the format `gated-{ACT_FN}` or `{ACT_FN}`, e.g. 'gated-gelu' or "
            "'relu'")
    act = "gelu_new" if proj == "gated-gelu" else info[-1]
    return act, info[0] == "gated"


def refuse(model_type: str, d: Dict[str, Any]) -> None:
    """Raise what the JAX package raises for a type the port does not
    build, in JAX's order of checks."""
    types = model_types()
    if model_type not in types["known"]:
        raise ValueError(
            f"Unrecognized model identifier: {model_type}. Should contain "
            f"one of {', '.join(types['known'])}")
    if model_type == "vision-text-dual-encoder" and \
            d.get("vision_config") is None:
        raise ValueError("`vision_config` can not be `None`.")
    encoder_decoder = d.get("is_encoder_decoder",
                            model_type in types["encoder_decoder"])
    if encoder_decoder and model_type not in T5_FAMILY:
        raise NotImplementedError(
            f"encoder-decoder arch {model_type!r} has no Flax encoder path "
            "here (transformers ships no Flax weights for it); use a "
            "bert/roberta-family text tower")
    if model_type not in types["flax"]:
        raise NotImplementedError(
            f"no Flax implementation for HF arch {model_type!r} in this "
            "transformers build")
    if model_type in NO_TEXT:
        raise NO_TEXT[model_type](
            f"HF arch {model_type!r} takes no token ids: the JAX package's "
            f"tower fails on it with a {NO_TEXT[model_type].__name__}")
    if model_type not in DEFAULTS:
        raise NotImplementedError(
            f"HF text tower {model_type!r}: the port writes its encoders "
            f"itself and has {', '.join(DEFAULTS)}; see {UNPORTED}")


def resolve_hf_config(hf_model_config: Dict[str, Any]) -> SimpleNamespace:
    """The dict's fields over its type's defaults, as attributes (the
    fields the encoders read, and ``model_type``)."""
    d = dict(hf_model_config)
    model_type = d.pop("model_type")
    model_type = TYPE_ALIASES.get(model_type, model_type)
    if model_type not in DEFAULTS or (
            d.get("is_encoder_decoder") and model_type not in T5_FAMILY):
        refuse(model_type, d)
    for alias, name in ALIASES.get(model_type, {}).items():
        if alias in d:
            # set after the config's own fields, so the alias wins
            d[name] = d.pop(alias)
    fields = {k: d.get(k, v) for k, v in DEFAULTS[model_type].items()}
    fields["model_type"] = model_type
    if model_type in T5_FAMILY:
        act, gated = _parse_ff(fields["feed_forward_proj"])
        fields["dense_act_fn"] = d.get("dense_act_fn", act)
        fields["is_gated_act"] = d.get("is_gated_act", gated)
    if model_type in ("llama", "mistral") and \
            fields["num_key_value_heads"] is None:
        fields["num_key_value_heads"] = fields["num_attention_heads"]
    if model_type == "opt" and fields["word_embed_proj_dim"] is None:
        fields["word_embed_proj_dim"] = fields["hidden_size"]
    if model_type in LLAMA_FAMILY:
        fields["mlp_act"] = (
            (fields["hidden_activation"] or "gelu_pytorch_tanh")
            if model_type == "gemma" else fields["hidden_act"])
    return SimpleNamespace(**fields)
