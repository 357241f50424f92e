"""``get_tokenizer`` for configs whose ``text_cfg.hf_tokenizer_name`` is a
local directory, and ``HFTokenizer`` itself, held to the JAX package's
``HFTokenizer`` (``AutoTokenizer.from_pretrained`` + ``batch_encode_plus``)
on the directories ``tests/torch_tokenizer_dirs.py`` writes: the five
types in each file layout, keywords of ``tokenizer_config.json`` that
rewrite ``tokenizer.json``, added and special tokens in the text,
truncation at and past the context, both padding sides,
``strip_sep_token`` and each ``clean``, and hypothesis-drawn Unicode
strings.  Every comparison is exact, shape and dtype included.

``PYTHONPATH=. python tests/test_torch_hf_tokenizer_dirs.py`` rewrites
``tests/torch_tokenizer_ids.json``, transformers' ids of the fixed
captions, which ``chip_smoke.py`` phase 26 holds the card's ids to."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_tokenizer_dirs as D
from cosmos_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
from cosmos_tpu.models import config as jax_config
from cosmos_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from cosmos_tpu_torch.data import hf_tokenizer as H
from cosmos_tpu_torch.data.tokenizer import HFTokenizer, get_clean_fn
from cosmos_tpu_torch.models import config as port_config
from cosmos_tpu_torch.models.factory import get_tokenizer

TYPES = ("bert", "roberta", "xlm-roberta", "t5", "mt5")
_CACHE = {}


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return D.write_all(tmp_path_factory.mktemp("tokenizers"))


def register(tmp: Path, name: str, tokenizer: str, context: int = 77):
    """A config ``name`` (ViT-B-16's, its text tower naming ``tokenizer``)
    in both packages' registries."""
    cfg = json.loads((Path(port_config.__file__).parent / "configs"
                      / "ViT-B-16.json").read_text())
    cfg["text_cfg"].update(hf_tokenizer_name=tokenizer,
                           context_length=context)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_config.add_model_config(path)
    port_config.add_model_config(path)
    return name


def pair(path: str, **kw):
    """(JAX's, the port's) HFTokenizer of ``path`` with ``kw``, cached."""
    key = (path, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = (JaxHFTokenizer(path, **kw), HFTokenizer(path, **kw))
    return _CACHE[key]


def same(want, got):
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def expected_record(dirs: dict, auto=None) -> dict:
    """Each directory's digest, pad id and transformers' ids of
    ``D.CAPTIONS`` at ``D.CONTEXT`` (cleaned as HFTokenizer cleans them),
    with the trailing pads left out; ``auto(path)`` loads transformers'
    tokenizer (``AutoTokenizer.from_pretrained`` by default)."""
    from transformers import AutoTokenizer

    auto = auto or AutoTokenizer.from_pretrained
    clean = get_clean_fn("whitespace")
    texts = [clean(t) for t in D.CAPTIONS]
    record = {"context": D.CONTEXT, "captions": D.CAPTIONS, "dirs": {}}
    for name, path in dirs.items():
        tok = auto(path)
        ids = tok(texts, return_tensors="np", max_length=D.CONTEXT,
                  padding="max_length", truncation=True).input_ids
        rows = [list(map(int, r)) for r in ids]
        for r in rows:
            while r and r[-1] == tok.pad_token_id:
                r.pop()
        record["dirs"][name] = {"digest": D.digest(path),
                                "pad_id": tok.pad_token_id, "ids": rows}
    return record


def test_committed_ids_are_transformers_s(dirs):
    """The generator is deterministic, and the committed ids are what
    transformers gives its directories now."""
    assert expected_record(dirs, lambda p: pair(p)[0].tokenizer) == \
        json.loads(D.EXPECTED.read_text())


@pytest.mark.parametrize("name", sorted(D.DIRS))
def test_get_tokenizer_equals_jax(dirs, tmp_path, name):
    model = register(tmp_path, f"hftok-{name}", dirs[name])
    want = jax_get_tokenizer(model)(D.CAPTIONS)
    got = get_tokenizer(model)(D.CAPTIONS)
    same(want, got)
    rec = json.loads(D.EXPECTED.read_text())["dirs"][name]
    assert [list(r[r != rec["pad_id"]]) for r in got] == rec["ids"]
    # the context from the config, and from the call
    model = register(tmp_path, f"hftok-{name}-9", dirs[name], context=9)
    same(jax_get_tokenizer(model)(D.CAPTIONS),
         get_tokenizer(model)(D.CAPTIONS))
    same(jax_get_tokenizer(model, context_length=20)(D.CAPTIONS[:4]),
         get_tokenizer(model, context_length=20)(D.CAPTIONS[:4]))


# Unicode strings of the kinds captions carry: combining marks, CJK, emoji
# and ZWJ sequences, full-width forms, control characters, runs of spaces,
# the types' special tokens
_PIECES = st.one_of(
    st.text(st.characters(codec="utf-8",
                          exclude_categories=("Cs", "Co", "Cn")),
            max_size=6),
    st.text(st.characters(categories=("Mn", "Me", "Mc")), max_size=3),
    st.text(st.characters(min_codepoint=0x4E00, max_codepoint=0x4FFF),
            max_size=4),
    st.text(st.characters(min_codepoint=0xFF01, max_codepoint=0xFFEE),
            max_size=4),
    st.text(st.characters(min_codepoint=0, max_codepoint=0x9F), max_size=4),
    st.sampled_from(["👨‍👩‍👧", "🏳️‍🌈", "👍🏽", "🇵🇪", "‍", "️",
                     " ", "   ", "\t", "\n", "　", "é", "ﬁ", "①",
                     "<mask>", "</s>", "<s>", "[SEP]", "[CLS]", "<unk>",
                     "<extra_id_7>", "[UNK]", "ΑΣ", "İ"]),
    st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E),
            max_size=12),
)
_TEXTS = st.lists(st.lists(_PIECES, max_size=8).map("".join), min_size=1,
                  max_size=4)


@pytest.mark.parametrize("kind", TYPES)
@settings(max_examples=20, deadline=None, derandomize=True, database=None)
@given(texts=_TEXTS)
def test_drawn_strings_equal_jax(dirs, kind, texts):
    want, got = pair(dirs[kind], context_length=24)
    same(want(texts), got(texts))


@pytest.mark.parametrize("name", sorted(D.DIRS))
@pytest.mark.parametrize("padding_side,truncation_side",
                         [("right", "right"), ("left", "left"),
                          ("left", "right")])
def test_truncation_and_padding_equal_jax(dirs, name, padding_side,
                                          truncation_side):
    """Contexts below, at and past a caption's length, on each side."""
    want, got = pair(dirs[name], padding_side=padding_side,
                     truncation_side=truncation_side)
    text = "a photo of a dog on the beach, élève ① 猫"
    n = int((want([text]) != want.tokenizer.pad_token_id).sum())
    for context in (3, n - 1, n, n + 1, n + 5):
        same(want([text, "", "x"], context), got([text, "", "x"], context))


@pytest.mark.parametrize("name", ["bert", "roberta", "t5", "xlm-roberta"])
@pytest.mark.parametrize("clean", ["whitespace", "lower", "canonicalize"])
def test_strip_sep_token_and_clean_equal_jax(dirs, name, clean):
    texts = D.CAPTIONS[:8] + ["Hello, World! [SEP] </s> _under_score_"]
    for strip in (False, True):
        want, got = pair(dirs[name], clean=clean, strip_sep_token=strip)
        same(want(texts), got(texts))


def _copy(dirs, name, tmp_path, config=None, tokenizer=None,
          remove=()) -> str:
    """A copy of the directory ``name`` with ``config`` over its
    tokenizer_config.json and ``tokenizer(doc)`` applied to its
    tokenizer.json."""
    path = tmp_path / name
    shutil.copytree(dirs[name], path)
    for f in remove:
        (path / f).unlink()
    if config:
        f = path / "tokenizer_config.json"
        f.write_text(json.dumps({**json.loads(f.read_text()), **config}))
    if tokenizer:
        f = path / "tokenizer.json"
        doc = json.loads(f.read_text())
        tokenizer(doc)
        f.write_text(json.dumps(doc))
    return str(path)


_OVERRIDES = {
    "bert-cased": ("bert", {"do_lower_case": False}),
    "bert-accents": ("bert", {"strip_accents": False,
                              "tokenize_chinese_chars": False}),
    "bert-strip-cased": ("bert", {"do_lower_case": False,
                                  "strip_accents": True}),
    "bert-vocab-cased": ("bert-vocab", {"do_lower_case": False,
                                        "tokenize_chinese_chars": False}),
    "roberta-prefix": ("roberta", {"add_prefix_space": True}),
    "roberta-vocab-prefix": ("roberta-vocab", {"add_prefix_space": True}),
    "xlm-roberta-left": ("xlm-roberta", {"padding_side": "left",
                                         "truncation_side": "left"}),
    "t5-max-length": ("t5", {"model_max_length": 8}),
}


@pytest.mark.parametrize("case", sorted(_OVERRIDES))
def test_config_keywords_equal_jax(dirs, tmp_path, case):
    """tokenizer_config.json's keywords over tokenizer.json's pipeline."""
    name, config = _OVERRIDES[case]
    path = _copy(dirs, name, tmp_path, config=config)
    texts = D.CAPTIONS + ["ÉCOLE Ünïcödé 東京 ﬁ"]
    want, got = JaxHFTokenizer(path, context_length=30), HFTokenizer(
        path, context_length=30)
    same(want(texts), got(texts))


@pytest.mark.parametrize("name,model_type", [
    ("bert-vocab", "bert"), ("roberta", "roberta"), ("mt5", "mt5")])
def test_class_from_config_json_equals_jax(dirs, tmp_path, name,
                                           model_type):
    """No tokenizer_config.json: the class comes from config.json's
    model_type, the special tokens from special_tokens_map.json."""
    path = _copy(dirs, name, tmp_path, remove=("tokenizer_config.json",))
    (Path(path) / "config.json").write_text(
        json.dumps({"model_type": model_type}))
    texts = D.CAPTIONS
    want, got = JaxHFTokenizer(path, context_length=30), HFTokenizer(
        path, context_length=30)
    same(want(texts), got(texts))


def _more_added(doc):
    vocab = doc["model"]["vocab"]
    n = len(vocab)
    for i, (content, flags) in enumerate([
            ("<ent>", dict(normalized=True, special=False)),
            ("[X]", dict(lstrip=True, rstrip=True, special=False,
                         normalized=False)),
            ("cat", dict(single_word=True, special=False, normalized=False)),
            ("<sp>", dict(special=True, normalized=False, rstrip=True)),
            ("ÉTÉ", dict(normalized=True, special=False))]):
        doc["added_tokens"].append({
            "id": n + i, "content": content, "single_word": False,
            "lstrip": False, "rstrip": False, **flags})


@pytest.mark.parametrize("name", ["bert", "roberta", "t5", "xlm-roberta"])
def test_added_tokens_in_the_text_equal_jax(dirs, tmp_path, name):
    """Added tokens with each flag, and the types' own special tokens, in
    the text (the copies drop added_tokens_decoder, so transformers reads
    the added tokens of tokenizer.json and special_tokens_map.json)."""
    path = _copy(dirs, name, tmp_path, tokenizer=_more_added)
    cfg = Path(path) / "tokenizer_config.json"
    config = json.loads(cfg.read_text())
    config.pop("added_tokens_decoder")
    cfg.write_text(json.dumps(config))
    texts = ["a <ent> b", "x[X]y  [X]  z", "cat concat cat_ cat.",
             "<sp>   next", "été ÉTÉ", "<mask> the <mask>x", "</s></s>",
             "[SEP][CLS] [MASK]", "<extra_id_0> <extra_id_99>", "<s>a</s>",
             "<pad> <unk> [PAD] [UNK]"]
    want, got = JaxHFTokenizer(path, context_length=40), HFTokenizer(
        path, context_length=40)
    same(want(texts), got(texts))


def test_refusals_name_their_roadmap_items(dirs, tmp_path):
    # a hub name needs a download
    model = register(tmp_path, "hftok-hub", "timm/ViT-B-16-SigLIP")
    with pytest.raises(NotImplementedError, match='"Not queued"'):
        get_tokenizer(model)
    # a SentencePiece .model alone
    spm = tmp_path / "spm"
    spm.mkdir()
    (spm / "spiece.model").write_bytes(b"\0")
    (spm / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "T5Tokenizer"}))
    with pytest.raises(NotImplementedError, match="SentencePiece .model"):
        HFTokenizer(str(spm))
    # a class the port does not build
    other = _copy(dirs, "roberta", tmp_path / "bloom",
                  config={"tokenizer_class": "BloomTokenizerFast"})
    with pytest.raises(NotImplementedError,
                       match="BloomTokenizer.*An HF tokenizer from a local"):
        HFTokenizer(other)
    # BPE dropout, which draws from tokenizers' own generator

    def dropout(doc):
        doc["model"]["dropout"] = 0.1
    path = _copy(dirs, "roberta", tmp_path / "dropout", tokenizer=dropout)
    with pytest.raises(NotImplementedError, match="BPE dropout"):
        HFTokenizer(path)
    # a keyword of AutoTokenizer the port does not take
    with pytest.raises(NotImplementedError, match="use_fast"):
        HFTokenizer(dirs["bert"], use_fast=False)
    # without tokenizer.json, only BERT's and RoBERTa's files are read
    bare = _copy(dirs, "xlm-roberta", tmp_path / "bare",
                 remove=("tokenizer.json",))
    with pytest.raises(NotImplementedError, match="without its tokenizer"):
        HFTokenizer(bare)


def test_pipeline_is_transformers_s(dirs):
    """The pipeline the port builds for each directory is the one
    transformers builds: its added tokens and its pad and sep ids."""
    for name, path in dirs.items():
        tok = pair(path)[0].tokenizer
        state = json.loads(tok.backend_tokenizer.to_str())
        port = H.load(path)
        assert {t["content"]: t["id"] for t in state["added_tokens"]} == \
            port.ids, name
        assert port.pad_id == tok.pad_token_id
        assert port.sep_id == tok.sep_token_id


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rec = expected_record(D.write_all(tmp))
    D.EXPECTED.write_text(json.dumps(rec, ensure_ascii=False) + "\n")
