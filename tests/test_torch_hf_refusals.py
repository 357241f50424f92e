"""The HF model types the port does not build are refused as the JAX
package refuses them, in its order of checks (``cosmos_tpu/models/
hf_model.py`` ``resolve_hf_config``, ``resolve_hf_module_cls``): a type
transformers does not know, the encoder-decoder types other than T5 and
mT5 (``bart``, ``mbart``, ``marian``, ``pegasus``, ``longt5``,
``blenderbot``, ``whisper``, ``m2m_100``, and BERT with
``is_encoder_decoder``), a type with no Flax model (``deberta``) raise
JAX's exception class and message; the Flax types that take no token ids
(``beit``, ``clip``, ``dinov2``, ``regnet``, ``resnet``, ``vit``,
``wav2vec2``, ``vision-text-dual-encoder``) raise the class JAX's tower
raises on a tiny config of each; a Flax text type the port has not
written (``bloom``, ``gpt_neo``, ``gptj``, ``xglm``, ``roformer``,
``big_bird``) names its ROADMAP item.  The committed type lists
(``cosmos_tpu_torch/assets/hf_model_types.json``, written by
``tests/torch_hf_types.py``) are pinned against transformers'.  An ALBERT
tokenizer directory with a SentencePiece ``.model`` alone is refused
naming its ROADMAP item, as T5's is.
"""

import json

import pytest

import torch_hf_cases as H
import torch_hf_types
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.models.hf_arch import NO_TEXT, model_types

_VIT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
            intermediate_size=64, image_size=16, patch_size=8)
# case -> the text_hf_model_config of a tiny tower JAX cannot build
REFUSED = {
    "not-a-model": {"model_type": "not-a-model"},
    **{t: {"model_type": t} for t in (
        "bart", "mbart", "marian", "pegasus", "longt5", "blenderbot",
        "whisper", "m2m_100", "deberta", "clip", "regnet", "resnet",
        "vision-text-dual-encoder")},
    "bert-encoder-decoder": dict(H.HF["bert"], is_encoder_decoder=True),
    "beit": dict(_VIT, model_type="beit"),
    "dinov2": dict(_VIT, model_type="dinov2"),
    "vit": dict(_VIT, model_type="vit"),
    "wav2vec2": dict(_VIT, model_type="wav2vec2"),
}
# the cases whose message the port copies from JAX's
SAME_MESSAGE = {c for c, d in REFUSED.items()
                if d["model_type"] not in NO_TEXT}


def test_type_lists_are_transformers_s():
    import transformers
    from transformers import CONFIG_MAPPING
    from transformers.models.auto.modeling_flax_auto import \
        FLAX_MODEL_MAPPING_NAMES

    types = model_types()
    assert types["transformers"] == transformers.__version__
    assert types["known"] == list(CONFIG_MAPPING.keys())
    assert types["flax"] == list(FLAX_MODEL_MAPPING_NAMES)
    # every listed type is encoder-decoder, and no Flax type nor deberta is
    # but the listed ones (instantiating all 421 configs takes seconds)
    for t in set(types["encoder_decoder"]) | set(types["flax"]) | {
            "deberta", "bert"}:
        assert torch_hf_types.encoder_decoder(CONFIG_MAPPING[t]) == (
            t in types["encoder_decoder"]), t
    assert len(types["encoder_decoder"]) == 49


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_are_jax_s(case):
    kw = H.model_kw("bert", text_hf_model_config=REFUSED[case])
    with pytest.raises(Exception) as want:
        H.jax_model(kw)
    with pytest.raises(Exception) as got:
        create_model("ViT-B-16", device="meta", **kw)
    assert type(got.value) is type(want.value), (got.value, want.value)
    if case in SAME_MESSAGE:
        assert str(got.value) == str(want.value)


# the Flax text types the port has not written (JAX builds each; gpt2 was
# this list's case until it was ported: test_torch_hf_decoders.py holds it)
UNPORTED_TYPES = ("bloom", "gpt_neo", "gptj", "xglm", "roformer", "big_bird")


def test_an_unported_flax_text_type_names_its_roadmap_item():
    from cosmos_tpu_torch.models.hf_arch import UNPORTED

    with pytest.raises(NotImplementedError) as got:
        create_model("ViT-B-16", device="meta", **H.model_kw(
            "bert", text_hf_model_config={"model_type": "bloom"}))
    assert UNPORTED in str(got.value)


@pytest.mark.parametrize("model_type", UNPORTED_TYPES)
def test_each_unported_flax_text_type_is_refused(model_type):
    from cosmos_tpu_torch.models.hf_arch import UNPORTED, model_types

    assert model_type in model_types()["flax"]
    with pytest.raises(NotImplementedError) as got:
        create_model("ViT-B-16", device="meta", **H.model_kw(
            "bert", text_hf_model_config={"model_type": model_type}))
    assert UNPORTED in str(got.value)


def test_an_albert_spiece_model_alone_is_refused(tmp_path):
    from cosmos_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
    from cosmos_tpu_torch.data.tokenizer import HFTokenizer

    (tmp_path / "spiece.model").write_bytes(b"\0")
    (tmp_path / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "AlbertTokenizer"}))
    with pytest.raises(NotImplementedError,
                       match="SentencePiece .model alone"):
        HFTokenizer(str(tmp_path))
    # transformers cannot read it here either: no sentencepiece
    with pytest.raises(Exception):
        JaxHFTokenizer(str(tmp_path))
