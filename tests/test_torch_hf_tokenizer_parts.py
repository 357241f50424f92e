"""The port's HF tokenizer pipeline (``cosmos_tpu_torch/data/hf_tokenizer.py``)
held to ``tokenizers`` one component at a time: each normalizer,
pre-tokenizer, model and post-processor built from the same JSON form on
both sides, on fixed strings and on every code point; the grapheme
clusters against ``regex``'s ``\\X``; the charsmap writer of
``tests/torch_tokenizer_dirs.py`` against ``tokenizers``' ``Precompiled``.
All comparisons are exact."""

import base64
import functools
import json
import sys
import unicodedata

import pytest
import regex
from tokenizers import Tokenizer

import torch_tokenizer_dirs as D
from cosmos_tpu_torch.data import hf_tokenizer as H



@functools.lru_cache()
def assigned():
    """Every code point unicodedata 15.0 assigns (private use and
    surrogates left out)."""
    return [chr(c) for c in range(sys.maxunicode + 1)
            if unicodedata.category(chr(c)) not in ("Cn", "Cs", "Co")]

STRINGS = [
    "", " ", "Hello, World!", "  two  spaces  ", "tabs\tand\nlines\r\n",
    "A café in Zürich: crème brûlée", "é ä ̈a", "ＦＵＬＬ　ｗｉｄｔｈ ｶﾀｶﾅ",
    "东京的一只猫 椅子", "family 👨‍👩‍👧 🇵🇪🇺", "ﬁsh ①② ㍿ ℡",
    "ΟΔΟΣ Σ ΑΣ", "İstanbul ǅ", "can't it's we're 3.14 1,000",
    "\x00\x01\x7f\x85",
    "क्षत्रिय नमस्ते", "한국어 각", "under_score--dash", "a​b﻿c",
    "x" * 120, "mixed123abc!!?", "　lead and trail　",
]


def _tok(normalizer=None, pre_tokenizer=None, model=None,
         post_processor=None) -> Tokenizer:
    """``tokenizers``' Tokenizer of the JSON forms given (a WordPiece of
    one id where no model is given)."""
    doc = {"version": "1.0", "truncation": None, "padding": None,
           "added_tokens": [], "normalizer": normalizer,
           "pre_tokenizer": pre_tokenizer, "post_processor": post_processor,
           "decoder": None,
           "model": model or {"type": "WordPiece", "unk_token": "[UNK]",
                              "continuing_subword_prefix": "##",
                              "max_input_chars_per_word": 100,
                              "vocab": {"[UNK]": 0}}}
    return Tokenizer.from_str(json.dumps(doc))


def _blocks(chars, size=64):
    """``chars`` joined into strings of ``size``, each behind a letter."""
    return ["a" + "".join(chars[i:i + size])
            for i in range(0, len(chars), size)]


@functools.lru_cache()
def charsmap():
    """The test directories' precompiled charsmap, base64 as in
    tokenizer.json."""
    return base64.b64encode(D.precompiled_charsmap(
        D.charsmap_table())).decode()


# "precompiled_charsmap": None stands for charsmap()
NORMALIZERS = {
    "bert": {"type": "BertNormalizer", "clean_text": True,
             "handle_chinese_chars": True, "strip_accents": None,
             "lowercase": True},
    "bert-cased": {"type": "BertNormalizer", "clean_text": True,
                   "handle_chinese_chars": False, "strip_accents": False,
                   "lowercase": False},
    "bert-strip": {"type": "BertNormalizer", "clean_text": False,
                   "handle_chinese_chars": True, "strip_accents": True,
                   "lowercase": False},
    "bert-keep-accents": {"type": "BertNormalizer", "clean_text": True,
                          "handle_chinese_chars": True,
                          "strip_accents": False, "lowercase": True},
    "lowercase": {"type": "Lowercase"},
    "nfc": {"type": "NFC"}, "nfd": {"type": "NFD"}, "nfkc": {"type": "NFKC"},
    "nfkd": {"type": "NFKD"},
    "strip-accents": {"type": "StripAccents"},
    "strip": {"type": "Strip", "strip_left": True, "strip_right": True},
    "strip-right": {"type": "Strip", "strip_left": False,
                    "strip_right": True},
    "replace-string": {"type": "Replace", "pattern": {"String": "``"},
                       "content": '"'},
    "replace-regex": {"type": "Replace", "pattern": {"Regex": " {2,}"},
                      "content": "▁"},
    "prepend": {"type": "Prepend", "prepend": "▁"},
    "sequence": {"type": "Sequence", "normalizers": [
        {"type": "NFD"}, {"type": "StripAccents"}, {"type": "Lowercase"}]},
    "precompiled": {"type": "Precompiled", "precompiled_charsmap": None},
    "spm": {"type": "Sequence", "normalizers": [
        {"type": "Precompiled", "precompiled_charsmap": None},
        {"type": "Strip", "strip_left": False, "strip_right": True},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": "▁"}]},
}


@pytest.mark.parametrize("name", sorted(NORMALIZERS))
def test_normalizer_equals_tokenizers(name):
    spec = json.loads(json.dumps(NORMALIZERS[name]).replace(
        '"precompiled_charsmap": null',
        f'"precompiled_charsmap": "{charsmap()}"'))
    want = _tok(normalizer=spec).normalizer.normalize_str
    got = H.normalizer(spec)
    texts = STRINGS + _blocks(assigned())
    assert [got(t) for t in texts] == [want(t) for t in texts]


PRE_TOKENIZERS = {
    "bert": {"type": "BertPreTokenizer"},
    "byte-level": {"type": "ByteLevel", "add_prefix_space": False,
                   "trim_offsets": True, "use_regex": True},
    "byte-level-prefix": {"type": "ByteLevel", "add_prefix_space": True,
                          "trim_offsets": True},
    "byte-level-no-regex": {"type": "ByteLevel", "add_prefix_space": False,
                            "trim_offsets": True, "use_regex": False},
    "metaspace-always": {"type": "Metaspace", "replacement": "▁",
                         "prepend_scheme": "always", "split": True},
    "metaspace-never": {"type": "Metaspace", "replacement": "▁",
                        "prepend_scheme": "never", "split": True},
    "metaspace-first": {"type": "Metaspace", "replacement": "▁",
                        "prepend_scheme": "first", "split": True},
    "metaspace-no-split": {"type": "Metaspace", "replacement": "▁",
                           "prepend_scheme": "always", "split": False},
    "metaspace-legacy": {"type": "Metaspace", "replacement": "▁",
                         "add_prefix_space": True},
    "metaspace-legacy-off": {"type": "Metaspace", "replacement": "▁",
                             "add_prefix_space": False, "str_rep": "▁",
                             "prepend_scheme": "never"},
    "whitespace-split": {"type": "WhitespaceSplit"},
    "whitespace": {"type": "Whitespace"},
    "t5-legacy": {"type": "Sequence", "pretokenizers": [
        {"type": "WhitespaceSplit"},
        {"type": "Metaspace", "replacement": "▁", "add_prefix_space": True}]},
    **{f"split-{b.lower()}": {"type": "Split", "pattern": {"String": " "},
                              "behavior": b, "invert": False}
       for b in ("Removed", "Isolated", "MergedWithPrevious",
                 "MergedWithNext", "Contiguous")},
    "split-inverted": {"type": "Split", "pattern": {"String": "a"},
                       "behavior": "Isolated", "invert": True},
    "split-gpt2-regex": {"type": "Split", "pattern": {"Regex": H._GPT2},
                         "behavior": "Isolated", "invert": False},
    "split-digits": {"type": "Split", "pattern": {"Regex": r"\p{N}{1,3}"},
                     "behavior": "Isolated", "invert": False},
}


@pytest.mark.parametrize("name", sorted(PRE_TOKENIZERS))
def test_pre_tokenizer_equals_tokenizers(name):
    spec = PRE_TOKENIZERS[name]
    want = _tok(pre_tokenizer=spec).pre_tokenizer.pre_tokenize_str
    got = H.pre_tokenizer(spec)
    texts = STRINGS + ["▁a▁▁b ▁", "aaa a", "a  a  aa"] + _blocks(
        assigned(), 32)[::7]
    assert [[p for p, _ in got([(t, True)])] for t in texts] == [
        [p for p, _ in want(t)] for t in texts]


def test_metaspace_refuses_what_tokenizers_refuses():
    spec = {"type": "Metaspace", "replacement": "▁", "add_prefix_space": False}
    with pytest.raises(Exception, match="add_prefix_space"):
        _tok(pre_tokenizer=spec)
    with pytest.raises(ValueError, match="add_prefix_space"):
        H.pre_tokenizer(spec)


def test_byte_level_classes_equal_tokenizers():
    """The GPT-2 split's letters, numbers and spaces on every code point,
    between letters, digits and spaces."""
    spec = PRE_TOKENIZERS["byte-level"]
    want = _tok(pre_tokenizer=spec).pre_tokenizer.pre_tokenize_str
    got = H.pre_tokenizer(spec)
    for ctx in ("a{}b", "1{}2", " {}  ", "{}'s"):
        every = assigned()
        texts = [ctx.format("".join(every[i:i + 16]))
                 for i in range(0, len(every), 16)]
        assert [[p for p, _ in got([(t, True)])] for t in texts] == [
            [p for p, _ in want(t)] for t in texts]


_WORDS = ["[UNK]", "un", "##aff", "##able", "a", "##b", "hello", "##!",
          "é", "##é", "猫"]
MODELS = {
    "wordpiece": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 8,
                  "vocab": {w: i for i, w in enumerate(_WORDS)}},
    "bpe": {"type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False,
            "vocab": {t: i for i, t in enumerate(
                ["a", "b", "c", "ab", "bc", "abc", "aa", "aaa"])},
            "merges": ["a b", "b c", "ab c", "a a", "aa a"]},
    "bpe-unk": {"type": "BPE", "unk_token": "<unk>", "fuse_unk": False,
                "vocab": {"<unk>": 0, "a": 1, "b": 2, "ab": 3},
                "merges": [["a", "b"]]},
    "bpe-fused-unk": {"type": "BPE", "unk_token": "<unk>", "fuse_unk": True,
                      "vocab": {"<unk>": 0, "a": 1, "b": 2, "ab": 3},
                      "merges": [["a", "b"]]},
    "bpe-affixes": {"type": "BPE", "continuing_subword_prefix": "##",
                    "end_of_word_suffix": "</w>",
                    "vocab": {t: i for i, t in enumerate(
                        ["a", "##b", "##c</w>", "c</w>", "ab", "abc</w>",
                         "##b##c</w>"])},
                    "merges": ["a ##b", "ab ##c</w>"]},
    "unigram": {"type": "Unigram", "unk_id": 0, "vocab": [
        ["<unk>", 0.0], ["▁", -2.0], ["a", -3.0], ["b", -3.5], ["ab", -4.0],
        ["▁ab", -4.5], ["abc", -9.0], ["c", -5.0], ["bc", -4.2],
        ["猫", -6.0]]},
}
MODEL_TEXTS = ["unaffable", "un", "aff", "hello!", "ab", "abc", "aaaa",
               "abcabcab", "abzzab", "zz", "▁abc", "▁ab▁ab猫x", "ééé", "猫",
               "ababababab", "a" * 9, "unaffableaff", "xyzzy", "c"]


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_equals_tokenizers(name):
    spec = MODELS[name]
    want = _tok(model=spec)
    got = H.model(json.loads(json.dumps(spec)))
    assert [got.tokenize(t) for t in MODEL_TEXTS] == [
        want.encode(t, add_special_tokens=False).ids for t in MODEL_TEXTS]


@pytest.mark.parametrize("name,spec", [
    ("bert", {"type": "BertProcessing", "sep": ["[SEP]", 3],
              "cls": ["[CLS]", 2]}),
    ("roberta", {"type": "RobertaProcessing", "sep": ["</s>", 2],
                 "cls": ["<s>", 0], "trim_offsets": True,
                 "add_prefix_space": False}),
    ("template", {"type": "TemplateProcessing", "single": [
        {"SpecialToken": {"id": "[CLS]", "type_id": 0}},
        {"Sequence": {"id": "A", "type_id": 0}},
        {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
        {"SpecialToken": {"id": "[X]", "type_id": 0}}], "pair": [],
        "special_tokens": {
            "[CLS]": {"id": "[CLS]", "ids": [2], "tokens": ["[CLS]"]},
            "[SEP]": {"id": "[SEP]", "ids": [3], "tokens": ["[SEP]"]},
            "[X]": {"id": "[X]", "ids": [7, 8], "tokens": ["[X]", "[Y]"]}}}),
    ("sequence", {"type": "Sequence", "processors": [
        {"type": "ByteLevel", "add_prefix_space": False,
         "trim_offsets": False, "use_regex": True},
        {"type": "BertProcessing", "sep": ["[SEP]", 3],
         "cls": ["[CLS]", 2]}]}),
])
def test_post_processor_equals_tokenizers(name, spec):
    model = {"type": "WordPiece", "unk_token": "[UNK]",
             "continuing_subword_prefix": "##",
             "max_input_chars_per_word": 100,
             "vocab": {t: i for i, t in enumerate(
                 ["[UNK]", "a", "[CLS]", "[SEP]", "b", "c", "d", "[X]",
                  "[Y]"])}}
    tok = _tok(model=model, post_processor=spec,
               pre_tokenizer={"type": "WhitespaceSplit"})
    post = H.PostProcessor(spec)
    for text in ("a b c", "d", ""):
        ids = tok.encode(text, add_special_tokens=False).ids
        assert post(ids) == tok.encode(text).ids
    assert post.added == tok.post_processor.num_special_tokens_to_add(False)


def test_graphemes_equal_regex():
    """Every code point unicodedata 15.0 assigns, alone and beside marks,
    joiners, emoji, regional indicators, Hangul jamo, Indic consonants and
    viramas, line ends and prepended marks."""
    partners = ["a", "́", "‍", "\r", "\U0001F468", "\U0001F1F5",
                "ᄀ", "ᆨ", "क", "्", "؀", "ः"]
    for q in partners:
        # q c q c ... q: every code point on both sides of q
        s = q + "".join(c + q for c in assigned())
        assert H.graphemes(s) == regex.findall(r"\X", s), repr(q)


def test_charsmap_writer_equals_tokenizers():
    """The test-side writer's charsmap, read by ``tokenizers``' Precompiled,
    gives every key's replacement."""
    from tokenizers import normalizers

    table = D.charsmap_table()
    pc = normalizers.Precompiled(D.precompiled_charsmap(table))
    keys = sorted(table)
    assert [pc.normalize_str(k) for k in keys] == [table[k] for k in keys]


def test_unicode_tables_name_their_sources():
    sources = H._tables()["sources"]
    assert sources["unicodedata"] == unicodedata.unidata_version
    assert set(sources) == {"regex", "regex_unicode", "tokenizers",
                            "unicodedata"}
