"""The port's stand-in for ``transformers.AutoConfig.for_model`` and
``AutoConfig.from_pretrained`` on a local directory: an offline
``hf_model_config`` dict, or the dict a directory's ``config.json`` holds
(``model_type`` and the config's fields), as a namespace with the defaults
of transformers' ``BertConfig``, ``RobertaConfig``, ``XLMRobertaConfig``,
``T5Config`` and ``MT5Config`` for every field the encoders of
``hf_bert.py`` and ``hf_t5.py`` read (``cosmos_tpu/models/hf_model.py``
``resolve_hf_config``).  The dict's other keys (transformers' bookkeeping:
``architectures``, ``transformers_version``, ``torch_dtype``, dropout
rates, ...) are left out.  The port never imports ``transformers``: the
card's machine does not have it.

T5's ``feed_forward_proj`` parses as transformers parses it: ``"relu"`` or
``"gated-<act>"``, with ``"gated-gelu"`` meaning the gated ``gelu_new``;
a saved config's own ``dense_act_fn`` and ``is_gated_act`` win over the
parse, as they do in ``T5Config``.
``m2m_100`` is refused as the JAX package refuses it (no Flax encoder);
any other type is refused, naming the ``ROADMAP.md`` item that would add
it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Any, Dict

BERT_FAMILY = ("bert", "roberta", "xlm-roberta")
T5_FAMILY = ("t5", "mt5")

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
DEFAULTS: Dict[str, Dict[str, Any]] = {
    "bert": _BERT,
    "roberta": dict(_BERT, vocab_size=50265, pad_token_id=1),
    "xlm-roberta": dict(_BERT, pad_token_id=1),
    "t5": _T5,
    "mt5": dict(_T5, vocab_size=250112, d_ff=1024, num_layers=8,
                num_heads=6, feed_forward_proj="gated-gelu",
                tie_word_embeddings=False),
}

UNPORTED = ("the ROADMAP.md item \"HF text towers: Flax architectures "
            "beyond bert, roberta, xlm-roberta, t5 and mt5\"")


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


def resolve_hf_config(hf_model_config: Dict[str, Any]) -> SimpleNamespace:
    """The dict's fields over its type's defaults, as attributes (the
    fields the encoders read, and ``model_type``)."""
    d = dict(hf_model_config)
    model_type = d.pop("model_type")
    if model_type == "m2m_100":
        raise NotImplementedError(
            f"encoder-decoder arch {model_type!r} has no Flax encoder path "
            "here (transformers ships no Flax weights for it); use a "
            "bert/roberta-family text tower")
    if model_type not in DEFAULTS:
        raise NotImplementedError(
            f"HF text tower {model_type!r}: the port writes its encoders "
            f"itself and has {', '.join(DEFAULTS)}; see {UNPORTED}")
    fields = {k: d.get(k, v) for k, v in DEFAULTS[model_type].items()}
    fields["model_type"] = model_type
    if model_type in T5_FAMILY:
        act, gated = _parse_ff(fields["feed_forward_proj"])
        fields["dense_act_fn"] = d.get("dense_act_fn", act)
        fields["is_gated_act"] = d.get("is_gated_act", gated)
    elif fields["is_decoder"] or fields["add_cross_attention"]:
        raise NotImplementedError(
            f"HF text tower {model_type!r} as a decoder: the port builds "
            f"encoders only; see {UNPORTED}")
    return SimpleNamespace(**fields)
