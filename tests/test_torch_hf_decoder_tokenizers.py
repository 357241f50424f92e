"""The decoder LMs' tokenizers, held to transformers and ``tokenizers``:

  - ``byte_fallback`` of the BPE model (Llama's, Mistral's and Gemma's
    SentencePiece-style BPE, ``fuse_unk`` and an unk) and of the Unigram
    model against ``tokenizers``' own models on fixed and
    hypothesis-drawn strings, with all 256 ``<0xNN>`` pieces and with the
    ASCII ones alone (a character whose bytes are not all there is the
    unk);
  - the directories of ``tests/torch_tokenizer_dirs.py``
    (``DECODER_DIRS``: GPT-2 with a pad token and ``add_prefix_space``,
    OPT's ``vocab.json`` + ``merges.txt`` under ``GPT2Tokenizer`` with
    ``add_bos_token``, Llama, Mistral with ``add_eos_token``, Gemma)
    through ``get_tokenizer`` against the JAX package's, with truncation
    and padding (Llama's and Gemma's classes pad on the left), the
    keywords that rewrite the post-processor, and drawn strings; the
    committed ids (``torch_tokenizer_decoder_ids.json``) are transformers'
    ids now;
  - a GPT-2 directory without a pad token raises transformers' padding
    ``ValueError``, as the JAX package's tokenizer does, class and
    message;
  - a Llama ``add_prefix_space`` and ``gpt-sw3``'s SentencePiece-only
    class are refused naming their ROADMAP item.

``PYTHONPATH=. python tests/test_torch_hf_decoder_tokenizers.py``
rewrites the committed ids, which ``chip_smoke.py`` phase 28 holds the
card's ids to.
"""

import json
import shutil

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_tokenizer_dirs as D
from cosmos_tpu.data.tokenizer import HFTokenizer as JaxHFTokenizer
from cosmos_tpu.models import config as jax_config
from cosmos_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from cosmos_tpu_torch.data import hf_tokenizer as T
from cosmos_tpu_torch.data.tokenizer import HFTokenizer, get_clean_fn
from cosmos_tpu_torch.models import config as port_config
from cosmos_tpu_torch.models.factory import get_tokenizer

NAMES = tuple(n for n in D.DECODER_DIRS if n not in D.NO_PAD)
_CACHE = {}

FIXED = ["a photo of a dog", "東京の猫 🎉 at the park", "élève ①②③ ﬁsh",
         "\t\n\x00\x7f", "", "▁▁a", "<0xE6> is text here", "Zürich ΟΔΟΣ"]
_TEXT = st.one_of(
    st.text(st.characters(codec="utf-8",
                          exclude_categories=("Cs", "Co", "Cn")),
            max_size=12),
    st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E),
            max_size=16),
    st.lists(st.sampled_from(["▁", "photo", "é", "猫", "🇵🇪", "\x00", "a",
                              "<0x41>", "<unk>", " "]),
             max_size=8).map("".join))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return D.write_decoders(tmp_path_factory.mktemp("decoder_tokenizers"))


def pair(path: str, **kw):
    key = (path, tuple(sorted(kw.items())))
    if key not in _CACHE:
        _CACHE[key] = (JaxHFTokenizer(path, **kw), HFTokenizer(path, **kw))
    return _CACHE[key]


def same(want, got):
    assert got.dtype == want.dtype == np.int32
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# --- byte_fallback against tokenizers' models ----------------------------

def _bpe(ascii_bytes: bool):
    """(the port's BPE, tokenizers' Tokenizer) of the Llama-style
    vocabulary, with every byte piece or the ASCII ones alone."""
    from tokenizers import Tokenizer, models

    vocab, merges = D.spm_bpe_vocab_merges(["<unk>", "<s>", "</s>"])
    if ascii_bytes:
        vocab = [t for t in vocab if not (t.startswith("<0x") and len(t) == 6
                                          and int(t[3:5], 16) >= 0x80)]
        vocab = {t: i for i, t in enumerate(vocab)}
    spec = {"type": "BPE", "unk_token": "<unk>", "fuse_unk": True,
            "byte_fallback": True, "vocab": vocab,
            "merges": [f"{a} {b}" for a, b in merges]}
    ref = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>",
                               fuse_unk=True, byte_fallback=True))
    return T.model(spec), ref


def _unigram(ascii_bytes: bool):
    from tokenizers import Tokenizer, models

    pieces = [("<unk>", 0.0)] + [
        (f"<0x{b:02X}>", 0.0) for b in range(0x80 if ascii_bytes else 256)]
    pieces += D.unigram_pieces(D.SEED, cjk=False)
    spec = {"type": "Unigram", "unk_id": 0, "byte_fallback": True,
            "vocab": [[p, s] for p, s in pieces]}
    ref = Tokenizer(models.Unigram(pieces, unk_id=0, byte_fallback=True))
    return T.model(spec), ref


_MODELS = {}


def _model(kind: str, ascii_bytes: bool):
    key = (kind, ascii_bytes)
    if key not in _MODELS:
        _MODELS[key] = (_bpe if kind == "bpe" else _unigram)(ascii_bytes)
    return _MODELS[key]


def test_byte_pieces_spell_utf8_bytes():
    vocab = {f"<0x{b:02X}>": b + 3 for b in range(256)}
    assert T.byte_pieces("é", vocab) == [0xC3 + 3, 0xA9 + 3]
    assert T.byte_pieces("猫", {"<0xE7>": 1}) is None


@pytest.mark.parametrize("ascii_bytes", [False, True])
@pytest.mark.parametrize("kind", ["bpe", "unigram"])
def test_byte_fallback_equals_tokenizers_on_fixed_strings(kind, ascii_bytes):
    port, ref = _model(kind, ascii_bytes)
    for text in FIXED:
        want = ref.encode(text, add_special_tokens=False).ids
        assert port.tokenize(text) == want, text
    # the fallback is reached: a CJK character is spelled in byte pieces
    ids = port.tokenize("猫")
    assert len(ids) == (1 if ascii_bytes else 3)


@pytest.mark.parametrize("ascii_bytes", [False, True])
@pytest.mark.parametrize("kind", ["bpe", "unigram"])
@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(text=_TEXT)
def test_byte_fallback_equals_tokenizers_on_drawn_strings(kind, ascii_bytes,
                                                          text):
    port, ref = _model(kind, ascii_bytes)
    port.cache.clear()
    assert port.tokenize(text) == ref.encode(
        text, add_special_tokens=False).ids


# --- the directories ------------------------------------------------------

def register(tmp, name: str, tokenizer: str, context: int = 77):
    cfg = json.loads((__import__("pathlib").Path(port_config.__file__).parent
                      / "configs" / "ViT-B-16.json").read_text())
    cfg["text_cfg"].update(hf_tokenizer_name=tokenizer,
                           context_length=context)
    path = tmp / f"{name}.json"
    path.write_text(json.dumps(cfg))
    jax_config.add_model_config(path)
    port_config.add_model_config(path)
    return name


def expected_record(dirs: dict, auto=None) -> dict:
    """Each directory's digest, pad id, padding side and transformers'
    ids of ``D.CAPTIONS`` at ``D.CONTEXT``, whole rows (Llama's and
    Gemma's pad on the left)."""
    from transformers import AutoTokenizer

    auto = auto or AutoTokenizer.from_pretrained
    clean = get_clean_fn("whitespace")
    texts = [clean(t) for t in D.CAPTIONS]
    record = {"context": D.CONTEXT, "captions": D.CAPTIONS, "dirs": {}}
    for name in NAMES:
        tok = auto(dirs[name])
        ids = tok(texts, return_tensors="np", max_length=D.CONTEXT,
                  padding="max_length", truncation=True).input_ids
        record["dirs"][name] = {
            "digest": D.digest(dirs[name]), "pad_id": tok.pad_token_id,
            "padding_side": tok.padding_side,
            "ids": [list(map(int, r)) for r in ids]}
    return record


def test_committed_ids_are_transformers_s(dirs):
    assert expected_record(dirs, lambda p: pair(p)[0].tokenizer) == \
        json.loads(D.DECODER_EXPECTED.read_text())


@pytest.mark.parametrize("name", NAMES)
def test_get_tokenizer_equals_jax(dirs, tmp_path, name):
    model = register(tmp_path, f"hftok-{name}", dirs[name])
    want = jax_get_tokenizer(model)(D.CAPTIONS)
    got = get_tokenizer(model)(D.CAPTIONS)
    same(want, got)
    rec = json.loads(D.DECODER_EXPECTED.read_text())["dirs"][name]
    assert got.tolist() == rec["ids"]
    model = register(tmp_path, f"hftok-{name}-9", dirs[name], context=9)
    same(jax_get_tokenizer(model)(D.CAPTIONS),
         get_tokenizer(model)(D.CAPTIONS))
    same(jax_get_tokenizer(model, context_length=20)(D.CAPTIONS[:4]),
         get_tokenizer(model, context_length=20)(D.CAPTIONS[:4]))


@pytest.mark.parametrize("name", ["llama", "mistral", "gemma"])
def test_byte_fallback_reaches_the_ids(dirs, name):
    """The CJK and emoji captions are spelled in ``<0xNN>`` pieces."""
    ids = HFTokenizer(dirs[name])(D.CAPTIONS[4:6])
    vocab = json.loads((__import__("pathlib").Path(dirs[name])
                        / "tokenizer.json").read_text())["model"]["vocab"]
    byte_ids = {vocab[f"<0x{b:02X}>"] for b in range(256)}
    assert all(byte_ids & set(row.tolist()) for row in ids)


@pytest.mark.parametrize("name,kw", [
    ("llama", {"add_eos_token": True}),
    ("llama", {"add_bos_token": False, "add_eos_token": True}),
    ("mistral", {"add_eos_token": False}),
    ("gemma", {"add_eos_token": True, "padding_side": "right"}),
    ("gemma", {"add_bos_token": False}),
    ("gpt2-pad", {"add_prefix_space": False}),
    ("opt", {"add_bos_token": False}),
    ("opt", {"add_prefix_space": True, "truncation_side": "left"}),
])
def test_keywords_equal_jax(dirs, name, kw):
    want, got = pair(dirs[name], **kw)
    texts = D.CAPTIONS[:3] + [D.CAPTIONS[12]]
    for context in (5, 77):
        same(want(texts, context), got(texts, context))


_PIECES = st.one_of(
    st.text(st.characters(codec="utf-8",
                          exclude_categories=("Cs", "Co", "Cn")),
            max_size=6),
    st.text(st.characters(min_codepoint=0x4E00, max_codepoint=0x4FFF),
            max_size=3),
    st.sampled_from(["👨‍👩‍👧", "🇵🇪", " ", "   ", "\t", "\n", "é", "ﬁ",
                     "<s>", "</s>", "<unk>", "<bos>", "<eos>", "<pad>",
                     "<|endoftext|>", "<start_of_turn>", "<0x41>", "▁"]),
    st.text(st.characters(min_codepoint=0x20, max_codepoint=0x7E),
            max_size=12),
)
_TEXTS = st.lists(st.lists(_PIECES, max_size=8).map("".join), min_size=1,
                  max_size=4)


@pytest.mark.parametrize("name", NAMES)
@settings(max_examples=12, deadline=None, derandomize=True, database=None)
@given(texts=_TEXTS)
def test_drawn_strings_equal_jax(dirs, name, texts):
    want, got = pair(dirs[name], context_length=24)
    same(want(texts), got(texts))


# --- refusals ---------------------------------------------------------------

def test_gpt2_without_a_pad_token_raises_jax_s_padding_error(dirs):
    want_tok, got_tok = pair(dirs["gpt2"])
    with pytest.raises(Exception) as want:
        want_tok(D.CAPTIONS[:2])
    with pytest.raises(Exception) as got:
        got_tok(D.CAPTIONS[:2])
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


def test_a_llama_add_prefix_space_is_refused(dirs):
    """LlamaTokenizerFast rebuilds its pipeline from the SentencePiece
    model under ``add_prefix_space``, which neither machine can read."""
    with pytest.raises(NotImplementedError,
                       match="SentencePiece .model alone"):
        HFTokenizer(dirs["llama"], add_prefix_space=True)
    with pytest.raises(Exception):
        JaxHFTokenizer(dirs["llama"], add_prefix_space=True)


def test_gpt_sw3_s_tokenizer_is_refused(dirs, tmp_path):
    """``GPTSw3Tokenizer`` has no fast class: a SentencePiece model."""
    path = tmp_path / "gpt-sw3"
    shutil.copytree(dirs["gpt2-pad"], path)
    (path / "spiece.model").write_bytes(b"\0")
    f = path / "tokenizer_config.json"
    f.write_text(json.dumps({**json.loads(f.read_text()),
                             "tokenizer_class": "GPTSw3Tokenizer"}))
    with pytest.raises(NotImplementedError,
                       match="SentencePiece .model alone"):
        HFTokenizer(str(path))
    with pytest.raises(Exception):
        JaxHFTokenizer(str(path))(["a photo"])


if __name__ == "__main__":
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        rec = expected_record(D.write_decoders(tmp))
    D.DECODER_EXPECTED.write_text(json.dumps(rec, ensure_ascii=False) + "\n")
