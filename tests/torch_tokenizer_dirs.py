"""Local HF tokenizer directories for the port's tokenizer tests and for
``chip_smoke.py`` phase 26, written without ``transformers``,
``tokenizers`` or ``sentencepiece``, from a seed.

The vocabularies come from the port's own CLIP merge table
(``cosmos_tpu_torch/assets/bpe_merges.json.gz``):

- byte-level BPE (RoBERTa): the merges in which neither part nor result
  carries ``</w>`` (closed under themselves), then a merge of the space
  symbol with each alphabetic result, ranked after them;
- WordPiece (BERT, DistilBERT, ELECTRA): the single characters, the
  ``</w>`` results as words and the other results as ``##`` continuations;
- Unigram (XLM-R, T5, mT5, ALBERT): ``▁`` + each word, the other results
  and the single characters, each scored from the seed.

RoBERTa-PreLayerNorm's directory names no ``tokenizer_class``: its
``config.json`` carries the model type, from which ``AutoTokenizer`` takes
RoBERTa's class.  ELECTRA's ``tokenizer_config.json`` turns lowercasing
off, which rewrites ``tokenizer.json``'s ``BertNormalizer``.

The four Unigram types carry a precompiled charsmap written here in
SentencePiece's layout (a darts-clone double array, then NUL-terminated
replacements): every code point whose NFKC form differs maps to that form,
and every two-character canonical decomposition of a Latin letter maps to
its composed letter (keys that span a grapheme cluster).

The decoder LMs' directories (``DECODER_DIRS``) take the byte-level BPE
vocabulary in GPT-2's layout (``<|endoftext|>`` last; no pad token, and a
variant that names one and sets ``add_prefix_space``) and in OPT's
(``vocab.json`` + ``merges.txt`` under ``GPT2Tokenizer`` with
``add_bos_token``, the special tokens in ``special_tokens_map.json``
alone), and a SentencePiece-style BPE with ``byte_fallback`` (Llama,
Mistral, Gemma): the byte-level merges as text, the space symbol as ``▁``,
the 256 ``<0xNN>`` pieces, and a Llama normalizer (``Prepend`` and
``Replace``), a ``Metaspace`` of scheme ``first`` under ``LlamaTokenizer``
with ``add_eos_token`` (Mistral), and Gemma's ``Replace`` and ``Split``.

``write_all(root)`` writes the directories of ``DIRS`` and returns
their paths, ``write_decoders(root)`` those of ``DECODER_DIRS``;
``digest(path)`` hashes a directory's files.
``tests/torch_tokenizer_ids.json`` (``EXPECTED``) holds each directory's
digest and transformers' ids of ``CAPTIONS``; ``PYTHONPATH=. python
tests/test_torch_hf_tokenizer_dirs.py`` rewrites it; ``DECODER_EXPECTED``
holds the decoder LMs' (``PYTHONPATH=. python
tests/test_torch_hf_decoder_tokenizers.py``).  This module imports
neither ``transformers`` nor ``tokenizers``: ``chip_smoke.py`` runs it on
the card's machine.
"""

from __future__ import annotations

import base64
import collections
import gzip
import hashlib
import json
import struct
import sys
import unicodedata
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

EXPECTED = Path(__file__).resolve().parent / "torch_tokenizer_ids.json"
SEED = 20
CONTEXT = 77
# name -> (type, layout)
DIRS = {
    "bert": ("bert", "tokenizer.json"),
    "bert-vocab": ("bert", "vocab.txt"),
    "roberta": ("roberta", "tokenizer.json"),
    "roberta-vocab": ("roberta", "vocab.json"),
    "xlm-roberta": ("xlm-roberta", "tokenizer.json"),
    "t5": ("t5", "tokenizer.json"),
    "mt5": ("mt5", "tokenizer.json"),
    "distilbert": ("distilbert", "tokenizer.json"),
    "distilbert-vocab": ("distilbert", "vocab.txt"),
    "electra": ("electra", "tokenizer.json"),
    "electra-vocab": ("electra", "vocab.txt"),
    "albert": ("albert", "tokenizer.json"),
    "roberta-prelayernorm": ("roberta-prelayernorm", "config.json"),
}
# the decoder LMs' directories: name -> (type, layout); NO_PAD names those
# with no pad token, whose padding raises (they have no committed ids)
DECODER_DIRS = {
    "gpt2": ("gpt2", "tokenizer.json"),
    "gpt2-pad": ("gpt2", "pad"),
    "opt": ("opt", "vocab.json"),
    "llama": ("llama", "tokenizer.json"),
    "mistral": ("mistral", "tokenizer.json"),
    "gemma": ("gemma", "tokenizer.json"),
}
NO_PAD = ("gpt2",)
DECODER_EXPECTED = EXPECTED.with_name("torch_tokenizer_decoder_ids.json")
# the tokenizer class of each WordPiece type
WORDPIECE = {"bert": "BertTokenizer", "distilbert": "DistilBertTokenizer",
             "electra": "ElectraTokenizer"}
# a fixed caption set: plain captions, accents, CJK, full-width forms,
# emoji and a ZWJ sequence, special tokens in the text, runs of spaces, a
# caption past the context
CAPTIONS = [
    "a photo of a dog on the beach",
    "Two people riding bicycles down a city street.",
    "A café in Zürich serves crème brûlée",
    "ＦＵＬＬ　ＷＩＤＴＨ letters and ｶﾀｶﾅ",
    "东京的一只猫 sitting on a 椅子",
    "family 👨‍👩‍👧 at the park 🎉",
    "the <mask> is on the table </s> [SEP] <unk>",
    "  spaces    between   words  ",
    "élève näive ﬁsh ﬂour ①②③",
    "Ελληνικά ΟΔΟΣ and русский текст",
    "numbers 12345 and 3.14159 and 1,000,000",
    "can't won't it's we're they've I'm you'll he'd",
    "x" * 60 + " " + "word " * 40,
    "",
    "a\tb\nc\rd\x0be\x0cf g h",
    "Cañón del Colca 🇵🇪 at dawn",
]


# ---------------------------------------------------------------- strings

def _byte_decoder() -> Dict[str, int]:
    from cosmos_tpu_torch.data.tokenizer import bytes_to_unicode

    return {v: k for k, v in bytes_to_unicode().items()}


def clip_merges() -> List[Tuple[str, str]]:
    from cosmos_tpu_torch.data.tokenizer import default_merges_path

    with gzip.open(default_merges_path(), "rt", encoding="utf-8") as f:
        return [tuple(p) for p in json.load(f)]


def _text(symbols: str, dec) -> str:
    """The UTF-8 text of byte-level symbols, or '' where it is not text."""
    try:
        return bytes(dec[c] for c in symbols).decode("utf-8")
    except (KeyError, UnicodeDecodeError):
        return ""


def _dedupe(items):
    seen, out = set(), []
    for x in items:
        if x and x not in seen:
            seen.add(x)
            out.append(x)
    return out


def clip_words() -> Tuple[List[str], List[str], List[str]]:
    """(words, continuations, characters) as text, in merge order."""
    dec = _byte_decoder()
    words, subs = [], []
    for a, b in clip_merges():
        r = a + b
        if r.endswith("</w>"):
            words.append(_text(r[:-4], dec))
        else:
            subs.append(_text(r, dec))
    words, subs = _dedupe(words), _dedupe(subs)
    chars = _dedupe(c for w in words + subs for c in w)
    chars = _dedupe(chars + [chr(c) for c in range(0x21, 0x7F)])
    return words, subs, chars


# ------------------------------------------------------------ vocabularies

def bpe_vocab_merges() -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """RoBERTa's layout: <s> <pad> </s> <unk>, the 256 byte symbols, the
    merge results, <mask>."""
    from cosmos_tpu_torch.data.tokenizer import bytes_to_unicode

    merges = [(a, b) for a, b in clip_merges()
              if "</w>" not in a and "</w>" not in b]
    space = bytes_to_unicode()[ord(" ")]
    results = [a + b for a, b in merges]
    dec = _byte_decoder()
    merges += [(space, r) for r in results
               if len(r) > 1 and _text(r, dec).isalpha()
               and _text(r, dec).isascii()]
    tokens = ["<s>", "<pad>", "</s>", "<unk>"]
    tokens += list(bytes_to_unicode().values())
    tokens += [a + b for a, b in merges]
    tokens = _dedupe(tokens) + ["<mask>"]
    return {t: i for i, t in enumerate(tokens)}, merges


def wordpiece_vocab() -> List[str]:
    words, subs, chars = clip_words()
    specials = ["[PAD]"] + [f"[unused{i}]" for i in range(4)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    return _dedupe(specials + chars + ["##" + c for c in chars] + words
                   + ["##" + s for s in subs])


def unigram_pieces(seed: int, cjk: bool) -> List[Tuple[str, float]]:
    """``▁`` + words, continuations and characters, scored from ``seed``:
    a longer piece tends to score higher, as a trained model's do."""
    words, subs, chars = clip_words()
    extra = []
    if cjk:
        extra = [chr(c) for c in range(0x4E00, 0x4E00 + 400)]
        extra += ["▁" + chr(c) for c in range(0x4E00, 0x4E00 + 100)]
        extra += [chr(c) for c in range(0x0410, 0x0450)]
        extra += [chr(c) for c in range(0x0391, 0x03CA) if c != 0x03A2]
    pieces = _dedupe(["▁"] + ["▁" + w for w in words] + subs + chars + extra)
    rng = np.random.default_rng(seed)
    scores = -rng.uniform(6.0, 14.0, len(pieces)) + 0.9 * np.minimum(
        [len(p) for p in pieces], 8)
    return [(p, float(round(s, 6))) for p, s in zip(pieces, scores)]


# --------------------------------------------------------- the charsmap

def _encode_offset(o: int) -> int:
    if o < (1 << 21):
        return o << 10
    assert o & 0xFF == 0 and o < (1 << 29), o
    return ((o >> 8) << 10) | (1 << 9)


def double_array(keys: Dict[bytes, int]) -> List[int]:
    """A darts-clone double array of ``keys`` (bytes -> value < 2**31):
    each node's children at ``base ^ label``, its value (where a key ends)
    at ``base ^ 0``."""
    trie: dict = {}
    for k, v in keys.items():
        node = trie
        for b in k:
            node = node.setdefault(b, {})
        node[None] = v
    units = [0] * 512
    used = bytearray(512)
    used[0] = 1
    first_open = [1]

    def place(labels):
        """The first base, block by block, whose ``base ^ label`` slots
        are all free."""
        k = first_open[0]
        while True:
            lo = k << 8
            if lo + 256 > len(units):
                units.extend([0] * 65536)
                used.extend(bytearray(65536))
            for q in range(256):
                if used[lo | q]:
                    continue
                b = lo | (q ^ labels[0])
                if all(not used[b ^ c] for c in labels):
                    return b
            k += 1

    queue = collections.deque([(0, trie)])
    while queue:
        pos, node = queue.popleft()
        labels = sorted(c for c in node if c is not None)
        leaf = None in node
        slots = ([0] if leaf else []) + labels
        base = place(slots)
        for c in slots:
            used[base ^ c] = 1
        while first_open[0] * 256 + 256 <= len(used) and all(
                used[first_open[0] * 256:first_open[0] * 256 + 256]):
            first_open[0] += 1
        units[pos] |= _encode_offset(pos ^ base)
        if leaf:
            units[pos] |= 1 << 8
            units[base] = node[None] | (1 << 31)
        for c in labels:
            units[base ^ c] = c
            queue.append((base ^ c, node[c]))
    return units[:used.rstrip(b"\0").__len__()]


def charsmap_table() -> Dict[str, str]:
    """NFKC's changes, one code point at a time, and the two-character
    decompositions of the Latin letters to their composed forms."""
    table = {}
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        if unicodedata.category(c) in ("Cs", "Cn", "Co"):
            continue
        n = unicodedata.normalize("NFKC", c)
        if n != c:
            table[c] = n
    for cp in range(0xC0, 0x250):
        c = chr(cp)
        d = unicodedata.normalize("NFD", c)
        if len(d) == 2 and unicodedata.normalize("NFC", d) == c:
            table[d] = c
    return table


def precompiled_charsmap(table: Dict[str, str]) -> bytes:
    """SentencePiece's layout: a little-endian u32 byte size of the double
    array, the array, then the NUL-terminated replacements."""
    blob, offsets, keys = bytearray(), {}, {}
    for src in sorted(table):
        dst = table[src]
        if dst not in offsets:
            offsets[dst] = len(blob)
            blob += dst.encode("utf-8") + b"\0"
        keys[src.encode("utf-8")] = offsets[dst]
    units = double_array(keys)
    array = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(array)) + array + bytes(blob)


# ---------------------------------------------------------- the files

def _added(content, id_, special=True, lstrip=False, normalized=False):
    return {"id": id_, "content": content, "single_word": False,
            "lstrip": lstrip, "rstrip": False, "normalized": normalized,
            "special": special}


def _decoder_entry(t):
    return {k: t[k] for k in ("content", "lstrip", "normalized", "rstrip",
                              "single_word", "special")}


def _config(path: Path, cls: str, added: list, special: dict,
            **extra) -> None:
    config = {"added_tokens_decoder": {str(t["id"]): _decoder_entry(t)
                                       for t in added},
              "clean_up_tokenization_spaces": False,
              "model_max_length": 512, "tokenizer_class": cls,
              **special, **extra}
    (path / "tokenizer_config.json").write_text(
        json.dumps(config, indent=2, ensure_ascii=False))
    (path / "special_tokens_map.json").write_text(
        json.dumps(special, indent=2, ensure_ascii=False))


def _string_mask(path: Path, content: str = "<mask>") -> None:
    """tokenizer_config.json names the mask token by its content (its
    flags stand in added_tokens_decoder), special_tokens_map.json whole."""
    f = path / "tokenizer_config.json"
    config = json.loads(f.read_text())
    config["mask_token"] = content
    f.write_text(json.dumps(config, indent=2, ensure_ascii=False))


def _tokenizer_json(path: Path, model, normalizer, pre_tokenizer,
                    post_processor, added, decoder) -> None:
    doc = {"version": "1.0", "truncation": None, "padding": None,
           "added_tokens": added, "normalizer": normalizer,
           "pre_tokenizer": pre_tokenizer, "post_processor": post_processor,
           "decoder": decoder, "model": model}
    (path / "tokenizer.json").write_text(
        json.dumps(doc, ensure_ascii=False))


def write_bert(path: Path, layout: str, kind: str = "bert") -> None:
    cls = WORDPIECE[kind]
    vocab = wordpiece_vocab()
    ids = {t: i for i, t in enumerate(vocab)}
    names = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    added = [_added(t, ids[t]) for t in sorted(names, key=ids.get)]
    special = {"cls_token": "[CLS]", "mask_token": "[MASK]",
               "pad_token": "[PAD]", "sep_token": "[SEP]",
               "unk_token": "[UNK]"}
    (path / "vocab.txt").write_text("".join(t + "\n" for t in vocab))
    _config(path, cls, added, special,
            do_lower_case=kind != "electra", strip_accents=None,
            tokenize_chinese_chars=True, do_basic_tokenize=True,
            never_split=None)
    if layout == "vocab.txt":
        (path / "tokenizer_config.json").unlink()
        _config(path, cls, [], special, do_lower_case=True,
                tokenize_chinese_chars=True)
        return
    _tokenizer_json(
        path,
        {"type": "WordPiece", "unk_token": "[UNK]",
         "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
         "vocab": ids},
        {"type": "BertNormalizer", "clean_text": True,
         "handle_chinese_chars": True, "strip_accents": None,
         "lowercase": True},
        {"type": "BertPreTokenizer"},
        {"type": "TemplateProcessing",
         "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                    {"Sequence": {"id": "A", "type_id": 0}},
                    {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
         "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                  {"Sequence": {"id": "A", "type_id": 0}},
                  {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                  {"Sequence": {"id": "B", "type_id": 1}},
                  {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
         "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                            for t in ("[CLS]", "[SEP]")}},
        added, {"type": "WordPiece", "prefix": "##", "cleanup": True})


def write_roberta(path: Path, layout: str) -> None:
    """RoBERTa's files; ``layout`` ``"config.json"``: ``tokenizer.json``
    with no ``tokenizer_class``, beside a ``config.json`` of
    RoBERTa-PreLayerNorm."""
    vocab, merges = bpe_vocab_merges()
    names = ("<s>", "<pad>", "</s>", "<unk>", "<mask>")
    added = [_added(t, vocab[t], lstrip=t == "<mask>") for t in names]
    special = {"bos_token": "<s>", "cls_token": "<s>", "eos_token": "</s>",
               "mask_token": {"content": "<mask>", "lstrip": True,
                              "normalized": False, "rstrip": False,
                              "single_word": False},
               "pad_token": "<pad>", "sep_token": "</s>",
               "unk_token": "<unk>"}
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))
    _config(path, "RobertaTokenizer", added, special,
            add_prefix_space=False, trim_offsets=True, errors="replace")
    _string_mask(path)
    if layout == "vocab.json":
        return
    if layout == "config.json":
        f = path / "tokenizer_config.json"
        config = json.loads(f.read_text())
        del config["tokenizer_class"]
        f.write_text(json.dumps(config, indent=2, ensure_ascii=False))
        (path / "config.json").write_text(json.dumps(
            {"model_type": "roberta-prelayernorm", "pad_token_id": 1}))
    # the release files' older form: merges as "a b" strings
    _tokenizer_json(
        path,
        {"type": "BPE", "dropout": None, "unk_token": None,
         "continuing_subword_prefix": "", "end_of_word_suffix": "",
         "fuse_unk": False, "vocab": vocab,
         "merges": [f"{a} {b}" for a, b in merges]},
        None,
        {"type": "ByteLevel", "add_prefix_space": False,
         "trim_offsets": True},
        {"type": "RobertaProcessing", "sep": ["</s>", vocab["</s>"]],
         "cls": ["<s>", vocab["<s>"]], "trim_offsets": True,
         "add_prefix_space": False},
        added, {"type": "ByteLevel", "add_prefix_space": True,
                "trim_offsets": True})


def _charsmap_b64() -> str:
    return base64.b64encode(precompiled_charsmap(charsmap_table())).decode()


def write_unigram(path: Path, kind: str, charsmap: str) -> None:
    if kind == "xlm-roberta":
        head = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
        pieces = head + unigram_pieces(SEED, cjk=True) + [("<mask>", 0.0)]
        unk, specials = 3, ("<s>", "<pad>", "</s>", "<unk>", "<mask>")
    else:
        head = [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
        pieces = head + unigram_pieces(SEED + (kind == "mt5"),
                                       cjk=kind == "mt5")
        extra = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
        pieces += [(t, 0.0) for t in extra]
        unk, specials = 2, ("<pad>", "</s>", "<unk>", *extra)
    ids = {p: i for i, (p, _) in enumerate(pieces)}
    added = [_added(t, ids[t], lstrip=t == "<mask>") for t in specials]
    model = {"type": "Unigram", "unk_id": unk,
             "vocab": [[p, s] for p, s in pieces], "byte_fallback": False}
    if kind == "xlm-roberta":
        # the form transformers' converter writes now
        special = {"bos_token": "<s>", "cls_token": "<s>",
                   "eos_token": "</s>", "mask_token": {
                       "content": "<mask>", "lstrip": True,
                       "normalized": False, "rstrip": False,
                       "single_word": False},
                   "pad_token": "<pad>", "sep_token": "</s>",
                   "unk_token": "<unk>"}
        _config(path, "XLMRobertaTokenizer", added, special)
        _string_mask(path)
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": charsmap},
            {"type": "Strip", "strip_left": False, "strip_right": True},
            {"type": "Replace", "pattern": {"Regex": " {2,}"},
             "content": "▁"}]}
        pre = {"type": "Metaspace", "replacement": "▁",
               "prepend_scheme": "always", "split": True}
        post = {"type": "TemplateProcessing",
                "single": [{"SpecialToken": {"id": "<s>", "type_id": 0}},
                           {"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                "pair": [],
                "special_tokens": {t: {"id": t, "ids": [ids[t]],
                                       "tokens": [t]}
                                   for t in ("<s>", "</s>")}}
    else:
        special = {"eos_token": "</s>", "pad_token": "<pad>",
                   "unk_token": "<unk>",
                   "additional_special_tokens": extra}
        _config(path, "T5Tokenizer", added, special, extra_ids=100)
        if kind == "t5":
            # the release files' older form: a whitespace split before a
            # Metaspace with add_prefix_space
            normalizer = {"type": "Precompiled",
                          "precompiled_charsmap": charsmap}
            pre = {"type": "Sequence", "pretokenizers": [
                {"type": "WhitespaceSplit"},
                {"type": "Metaspace", "replacement": "▁",
                 "add_prefix_space": True}]}
        else:
            normalizer = {"type": "Sequence", "normalizers": [
                {"type": "Precompiled", "precompiled_charsmap": charsmap},
                {"type": "Strip", "strip_left": False, "strip_right": True},
                {"type": "Replace", "pattern": {"Regex": " {2,}"},
                 "content": "▁"}]}
            pre = {"type": "Metaspace", "replacement": "▁",
                   "add_prefix_space": True}
        post = {"type": "TemplateProcessing",
                "single": [{"Sequence": {"id": "A", "type_id": 0}},
                           {"SpecialToken": {"id": "</s>", "type_id": 0}}],
                "pair": [],
                "special_tokens": {"</s>": {"id": "</s>", "ids": [ids["</s>"]],
                                            "tokens": ["</s>"]}}}
    _tokenizer_json(path, model, normalizer, pre, post, added,
                    {"type": "Metaspace", "replacement": "▁",
                     "add_prefix_space": True})


def write_albert(path: Path, charsmap: str) -> None:
    """``AlbertConverter``'s pipeline: quotes, NFKD, accents stripped,
    lowercase, the charsmap, runs of spaces, Metaspace, Unigram, ``[CLS]
    $A [SEP]``."""
    specials = ("<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]")
    pieces = [(t, 0.0) for t in specials] + unigram_pieces(SEED + 2,
                                                            cjk=False)
    ids = {p: i for i, (p, _) in enumerate(pieces)}
    added = [_added(t, ids[t], lstrip=t == "[MASK]") for t in specials]
    special = {"bos_token": "[CLS]", "cls_token": "[CLS]",
               "eos_token": "[SEP]", "mask_token": {
                   "content": "[MASK]", "lstrip": True, "normalized": False,
                   "rstrip": False, "single_word": False},
               "pad_token": "<pad>", "sep_token": "[SEP]",
               "unk_token": "<unk>"}
    _config(path, "AlbertTokenizer", added, special, do_lower_case=True,
            remove_space=True, keep_accents=False)
    _string_mask(path, "[MASK]")
    normalizer = {"type": "Sequence", "normalizers": [
        {"type": "Replace", "pattern": {"String": "``"}, "content": '"'},
        {"type": "Replace", "pattern": {"String": "''"}, "content": '"'},
        {"type": "NFKD"}, {"type": "StripAccents"}, {"type": "Lowercase"},
        {"type": "Precompiled", "precompiled_charsmap": charsmap},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    pre = {"type": "Metaspace", "replacement": "▁",
           "prepend_scheme": "always", "split": True}
    post = {"type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [ids[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}}
    model = {"type": "Unigram", "unk_id": ids["<unk>"],
             "vocab": [[p, s] for p, s in pieces], "byte_fallback": False}
    _tokenizer_json(path, model, normalizer, pre, post, added,
                    {"type": "Metaspace", "replacement": "▁",
                     "prepend_scheme": "always", "split": True})


def write_all(root) -> Dict[str, str]:
    """The directories of ``DIRS`` under ``root``; name -> path."""
    root = Path(root)
    charsmap = _charsmap_b64()
    out = {}
    for name, (kind, layout) in DIRS.items():
        path = root / name
        path.mkdir(parents=True, exist_ok=True)
        if kind in WORDPIECE:
            write_bert(path, layout, kind)
        elif kind in ("roberta", "roberta-prelayernorm"):
            write_roberta(path, layout)
        elif kind == "albert":
            write_albert(path, charsmap)
        else:
            write_unigram(path, kind, charsmap)
        out[name] = str(path)
    return out


def spm_bpe_vocab_merges(specials: List[str]
                         ) -> Tuple[Dict[str, int], List[Tuple[str, str]]]:
    """SentencePiece-style BPE: ``specials``, the 256 ``<0xNN>`` byte
    pieces, ``▁``, the characters and the results of ``bpe_vocab_merges``'
    merges written as text (its space symbol as ``▁``), the merges whose
    parts are text."""
    dec = _byte_decoder()

    def text(symbols: str) -> str:
        return _text(symbols, dec).replace(" ", "▁")

    _, byte_merges = bpe_vocab_merges()
    merges = [(text(a), text(b)) for a, b in byte_merges]
    merges = [(a, b) for a, b in merges if a and b]
    chars = _dedupe(["▁"] + [c for a, b in merges for c in a + b]
                    + [chr(c) for c in range(0x21, 0x7F)])
    tokens = _dedupe(list(specials) + [f"<0x{b:02X}>" for b in range(256)]
                     + chars + [t for a, b in merges for t in (a, b, a + b)])
    return {t: i for i, t in enumerate(tokens)}, merges


def _bpe_model(vocab, merges, **extra) -> dict:
    return {"type": "BPE", "dropout": None, "unk_token": None,
            "continuing_subword_prefix": None, "end_of_word_suffix": None,
            "fuse_unk": False, "byte_fallback": False,
            "ignore_merges": False, "vocab": vocab,
            "merges": [[a, b] for a, b in merges], **extra}


def write_gpt2(path: Path, layout: str) -> None:
    """GPT-2's files: ``<|endoftext|>`` bos, eos and unk, no pad token;
    ``layout`` ``"pad"`` names it the pad token and sets
    ``add_prefix_space``."""
    vocab, merges = bpe_vocab_merges()
    for t in ("<s>", "<pad>", "</s>", "<unk>", "<mask>"):
        del vocab[t]
    vocab = {t: i for i, t in enumerate(list(vocab) + ["<|endoftext|>"])}
    end = "<|endoftext|>"
    added = [_added(end, vocab[end])]
    special = {"bos_token": end, "eos_token": end, "unk_token": end}
    extra = {"add_prefix_space": False, "errors": "replace",
             "add_bos_token": False}
    if layout == "pad":
        special["pad_token"] = end
        extra["add_prefix_space"] = True
    _config(path, "GPT2Tokenizer", added, special, **extra)
    _tokenizer_json(
        path, _bpe_model(vocab, merges, continuing_subword_prefix="",
                         end_of_word_suffix=""),
        None, {"type": "ByteLevel", "add_prefix_space": False,
               "trim_offsets": True, "use_regex": True},
        {"type": "ByteLevel", "add_prefix_space": True,
         "trim_offsets": False, "use_regex": True},
        added, {"type": "ByteLevel", "add_prefix_space": True,
                "trim_offsets": True, "use_regex": True})


def write_opt(path: Path) -> None:
    """OPT's files: RoBERTa's ``vocab.json`` and ``merges.txt`` (``<s>
    <pad> </s> <unk>`` first) under ``GPT2Tokenizer`` with
    ``add_bos_token``, ``</s>`` its bos, eos and unk, ``<pad>`` its pad,
    as AddedToken fields in ``special_tokens_map.json`` (no
    ``added_tokens_decoder``)."""
    vocab, merges = bpe_vocab_merges()
    del vocab["<mask>"]
    (path / "vocab.json").write_text(json.dumps(vocab, ensure_ascii=False))
    (path / "merges.txt").write_text(
        "#version: 0.2\n" + "".join(f"{a} {b}\n" for a, b in merges))

    def token(content):
        return {"content": content, "lstrip": False, "normalized": True,
                "rstrip": False, "single_word": False}

    special = {"bos_token": token("</s>"), "eos_token": token("</s>"),
               "unk_token": token("</s>"), "pad_token": token("<pad>")}
    (path / "tokenizer_config.json").write_text(json.dumps(dict(
        special, add_bos_token=True, add_prefix_space=False,
        errors="replace", model_max_length=1000000000000000019884624838656,
        tokenizer_class="GPT2Tokenizer"), indent=2))
    (path / "special_tokens_map.json").write_text(
        json.dumps(special, indent=2))


def write_spm_bpe(path: Path, kind: str) -> None:
    """Llama's, Mistral's or Gemma's ``tokenizer.json``: BPE with
    ``byte_fallback``, ``fuse_unk`` and an unk."""
    if kind == "gemma":
        specials = ["<pad>", "<eos>", "<bos>", "<unk>", "<mask>",
                    "<start_of_turn>", "<end_of_turn>"]
        cls, pad = "GemmaTokenizer", "<pad>"
        special = {"bos_token": "<bos>", "eos_token": "<eos>",
                   "unk_token": "<unk>", "pad_token": "<pad>",
                   "additional_special_tokens": ["<start_of_turn>",
                                                 "<end_of_turn>"]}
        extra = {"add_bos_token": True, "add_eos_token": False}
        normalizer = {"type": "Replace", "pattern": {"String": " "},
                      "content": "▁"}
        pre = {"type": "Split", "pattern": {"String": " "},
               "behavior": "MergedWithPrevious", "invert": False}
    else:
        specials = ["<unk>", "<s>", "</s>"]
        cls = "LlamaTokenizer"
        special = {"bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>"}
        if kind == "llama":
            special["pad_token"] = "</s>"
            extra = {"add_bos_token": True, "add_eos_token": False,
                     "legacy": True}
            normalizer = {"type": "Sequence", "normalizers": [
                {"type": "Prepend", "prepend": "▁"},
                {"type": "Replace", "pattern": {"String": " "},
                 "content": "▁"}]}
            pre = None
        else:
            special["pad_token"] = "<unk>"
            extra = {"add_bos_token": True, "add_eos_token": True,
                     "legacy": False}
            normalizer = None
            pre = {"type": "Metaspace", "replacement": "▁",
                   "prepend_scheme": "first", "split": False}
    vocab, merges = spm_bpe_vocab_merges(specials)
    added = [_added(t, vocab[t]) for t in specials]
    _config(path, cls, added, special, clean_up_tokenization_spaces=False,
            **extra)
    first = special["bos_token"]
    post = {"type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": first, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [],
            "special_tokens": {first: {"id": first, "ids": [vocab[first]],
                                       "tokens": [first]}}}
    _tokenizer_json(
        path, _bpe_model(vocab, merges, unk_token="<unk>", fuse_unk=True,
                         byte_fallback=True),
        normalizer, pre, post, added,
        {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"}]})


def write_decoders(root) -> Dict[str, str]:
    """The directories of ``DECODER_DIRS`` under ``root``; name -> path."""
    root = Path(root)
    out = {}
    for name, (kind, layout) in DECODER_DIRS.items():
        path = root / name
        path.mkdir(parents=True, exist_ok=True)
        if kind == "gpt2":
            write_gpt2(path, layout)
        elif kind == "opt":
            write_opt(path)
        else:
            write_spm_bpe(path, kind)
        out[name] = str(path)
    return out


def digest(path) -> str:
    """sha256 over a directory's file names and bytes."""
    h = hashlib.sha256()
    for f in sorted(Path(path).iterdir()):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return h.hexdigest()
