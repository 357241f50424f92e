"""HF tokenizers from a local directory, without ``transformers``,
``tokenizers``, ``sentencepiece`` or ``regex`` (the counterpart of what
``AutoTokenizer.from_pretrained(dir)`` and ``batch_encode_plus`` do in the
JAX package's ``HFTokenizer``, for the text towers the port builds: the
classes of BERT, DistilBERT, ELECTRA, RoBERTa (RoBERTa-PreLayerNorm's
too), XLM-RoBERTa, ALBERT, T5 and mT5, GPT-2 (OPT's too), Llama
(Mistral's too) and Gemma).

``load(path, **overrides)`` reads a directory as ``AutoTokenizer`` does:
``tokenizer_config.json`` (the class, its keywords, ``padding_side``,
``truncation_side``), ``special_tokens_map.json`` and ``tokenizer.json``;
without ``tokenizer.json``, a BERT, DistilBERT or ELECTRA ``vocab.txt`` or a
RoBERTa or GPT-2 ``vocab.json`` + ``merges.txt`` built into the pipeline
transformers' converters build.  It returns a ``Pipeline``, whose
``encode_batch(texts, max_length)`` gives the ids of ``truncation=True,
padding="max_length"``.

The pipeline is ``tokenizers``': added tokens split out (the special ones
before normalization), a normalizer, a pre-tokenizer, a model (WordPiece,
byte-level or SentencePiece-style BPE, Unigram; ``byte_fallback`` spells
a piece the vocabulary lacks as the ``<0xNN>`` pieces of its UTF-8 bytes,
where all of them exist), truncation leaving room for the
post-processor's specials, the post-processor, padding.  A class with no
pad token encodes, and ``encode_batch`` raises transformers' padding
``ValueError``, as the JAX package's ``batch_encode_plus(padding=
"max_length")`` does.  Each component reads the fields
``tokenizers`` 0.22 reads, the release files' older ones included.

``tokenizers`` reads older Unicode tables than ``unicodedata`` for some of
its components, and segments grapheme clusters (the ``Precompiled``
normalizer) by UAX #29, which the standard library does not do.  Both come
from ``assets/hf_unicode.json.gz`` (its generator is
``tests/torch_hf_unicode.py``; the grapheme properties are Unicode 17.0's).

Deliberate differences: BPE dropout and components the port's types do
not use are refused by name; ``Metaspace``'s
``prepend_scheme: "first"`` prepends to the piece that starts the text,
where ``tokenizers`` also looks through a normalizer that deleted the
text's first characters.
"""

from __future__ import annotations

import base64
import gzip
import heapq
import json
import re
import struct
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .tokenizer import _NOT_WHITE_SPACE, _classes, _ranges, bytes_to_unicode

ITEM = 'ROADMAP queue 1, "An HF tokenizer from a local directory"'
SPM_ITEM = ('ROADMAP queue 1, "An HF tokenizer from a SentencePiece .model '
            'alone"')
_ASSETS = Path(__file__).resolve().parent.parent / "assets"

# a piece of a pre-tokenized string: its text, and whether it starts the
# original text
Piece = Tuple[str, bool]


def refuse(what: str, item: str = ITEM) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported ({item})")


# ------------------------------------------------------------ unicode tables

@lru_cache()
def _tables() -> Dict[str, Any]:
    with gzip.open(_ASSETS / "hf_unicode.json.gz", "rt",
                   encoding="utf-8") as f:
        return json.load(f)


def _points(name: str) -> List[int]:
    return [p for lo, hi in _tables()[name] for p in range(lo, hi + 1)]


@lru_cache()
def _class(name: str) -> str:
    """A character-class body of the table ``name``."""
    return _ranges(_points(name))


@lru_cache()
def _sub(name: str) -> "re.Pattern":
    return re.compile(f"[{_class(name)}]")


@lru_cache()
def _white_space() -> str:
    """Rust's ``char::is_whitespace`` (White_Space), as a string."""
    return "".join(chr(c) for c in range(0x3001) if chr(c).isspace()
                   and chr(c) not in _NOT_WHITE_SPACE)


@lru_cache()
def _grapheme_props() -> Tuple[Dict[str, str], Dict[str, str], frozenset]:
    t = _tables()
    gcb = {chr(p): k[4:] for k in t if k.startswith("gcb_")
           for lo, hi in t[k] for p in range(lo, hi + 1)}
    incb = {chr(p): k[5:] for k in t if k.startswith("incb_")
            for lo, hi in t[k] for p in range(lo, hi + 1)}
    pict = frozenset(chr(p) for p in _points("extpict"))
    return gcb, incb, pict


def graphemes(s: str) -> List[str]:
    """The extended grapheme clusters of ``s`` (UAX #29, GB3-GB999)."""
    if not s:
        return []
    if s.isascii() and "\r\n" not in s:
        return list(s)
    gcb, incb, pict = _grapheme_props()
    out, start = [], 0
    prev = gcb.get(s[0], "")
    ri = int(prev == "Regional_Indicator")
    emoji = 1 if s[0] in pict else 0
    conj = 1 if incb.get(s[0]) == "Consonant" else 0
    for i in range(1, len(s)):
        c = s[i]
        p, k, x = gcb.get(c, ""), incb.get(c), c in pict
        if prev == "CR" and p == "LF":
            cut = False
        elif prev in ("Control", "CR", "LF") or p in ("Control", "CR", "LF"):
            cut = True
        elif ((prev == "L" and p in ("L", "V", "LV", "LVT"))
              or (prev in ("LV", "V") and p in ("V", "T"))
              or (prev in ("LVT", "T") and p == "T")):
            cut = False
        elif p in ("Extend", "ZWJ", "SpacingMark") or prev == "Prepend":
            cut = False
        elif k == "Consonant" and conj == 2:
            cut = False
        elif x and emoji == 2:
            cut = False
        elif prev == p == "Regional_Indicator" and ri % 2 == 1:
            cut = False
        else:
            cut = True
        if cut:
            out.append(s[start:i])
            start = i
        ri = ri + 1 if p == "Regional_Indicator" else 0
        if x:
            emoji = 1
        elif p == "Extend" and emoji == 1:
            pass
        else:
            emoji = 2 if p == "ZWJ" and emoji == 1 else 0
        if k == "Consonant":
            conj = 1
        elif k == "Linker" and conj:
            conj = 2
        elif k != "Extend":
            conj = 0
        prev = p
    out.append(s[start:])
    return out


# ---------------------------------------------------------------- normalizers

def _lower(s: str) -> str:
    """Lower case one character at a time (no final-sigma context)."""
    return s.lower() if s.isascii() else "".join(c.lower() for c in s)


def unicode_normalize(form: str, s: str) -> str:
    """``form`` of ``s`` as ``tokenizers`` computes it: the characters its
    tables do not know stay as they are and split the text into runs."""
    if s.isascii():
        return s
    unknown = _sub("norm_unknown")
    if not unknown.search(s):
        return unicodedata.normalize(form, s)
    parts, last = [], 0
    for m in unknown.finditer(s):
        parts.append(unicodedata.normalize(form, s[last:m.start()]))
        parts.append(m.group())
        last = m.end()
    parts.append(unicodedata.normalize(form, s[last:]))
    return "".join(parts)


class Precompiled:
    """SentencePiece's precompiled charsmap: a little-endian u32 byte size,
    a darts-clone double array, then NUL-terminated replacements.  A
    grapheme cluster under 6 bytes is looked up whole, else (or where the
    whole is not a key) each character; a lookup takes the shortest key
    that prefixes the chunk."""

    def __init__(self, charsmap) -> None:
        data = (bytes(charsmap) if isinstance(charsmap, list)
                else base64.b64decode(charsmap))
        size = struct.unpack_from("<I", data)[0]
        self.array = struct.unpack_from(f"<{size // 4}I", data, 4)
        self.normalized = data[4 + size:]
        self.cache: Dict[str, Optional[str]] = {}

    def _lookup(self, key: bytes) -> Optional[int]:
        a, pos = self.array, 0
        if not a:
            return None
        unit = a[0]
        pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= len(a):
                return None
            unit = a[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                return None
            pos ^= (unit >> 10) << ((unit & (1 << 9)) >> 6)
            if (unit >> 8) & 1:
                return a[pos] & ((1 << 31) - 1)
        return None

    def transform(self, chunk: str) -> Optional[str]:
        if chunk in self.cache:
            return self.cache[chunk]
        at = self._lookup(chunk.encode("utf-8"))
        out = None
        if at is not None:
            end = self.normalized.find(b"\0", at)
            out = self.normalized[at:end if end >= 0 else None].decode(
                "utf-8")
        self.cache[chunk] = out
        return out

    def __call__(self, s: str) -> str:
        out = []
        for g in graphemes(s):
            if len(g.encode("utf-8")) < 6:
                r = self.transform(g)
                if r is not None:
                    out.append(r)
                    continue
            for c in g:
                r = self.transform(c)
                out.append(c if r is None else r)
        return "".join(out)


def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    clean = spec.get("clean_text", True)
    chinese = spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def run(s: str) -> str:
        if clean:
            s = _sub("bert_space").sub(" ", _sub("bert_drop").sub("", s))
        if chinese and not s.isascii():
            s = _sub("bert_chinese").sub(lambda m: f" {m.group()} ", s)
        if strip:
            s = _sub("bert_marks").sub("", unicode_normalize("NFD", s))
        return _lower(s) if lower else s
    return run


def _replace(spec: dict) -> Callable[[str], str]:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        literal = pattern["String"]
        return lambda s: s.replace(literal, content) if literal else s
    rx = onig_pattern(pattern["Regex"])
    return lambda s: rx.sub(lambda _: content, s)


def _strip(spec: dict) -> Callable[[str], str]:
    left, right = spec.get("strip_left", True), spec.get("strip_right", True)
    ws = _white_space()

    def run(s: str) -> str:
        if left:
            s = s.lstrip(ws)
        return s.rstrip(ws) if right else s
    return run


def normalizer(spec: Optional[dict]) -> Optional[Callable[[str], str]]:
    """A ``tokenizers`` normalizer from its JSON form."""
    if spec is None:
        return None
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [normalizer(n) for n in spec["normalizers"]]

        def run(s: str) -> str:
            for n in parts:
                s = n(s)
            return s
        return run
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda s: unicode_normalize(kind, s)
    if kind == "Lowercase":
        return _lower
    if kind == "StripAccents":
        return lambda s: _sub("strip_marks").sub("", s)
    if kind == "Strip":
        return _strip(spec)
    if kind == "Replace":
        return _replace(spec)
    if kind == "Prepend":
        text = spec["prepend"]
        return lambda s: text + s if s else s
    if kind == "Precompiled":
        return Precompiled(spec["precompiled_charsmap"])
    raise refuse(f"the {kind} normalizer")


# -------------------------------------------------------------- pre-tokenizers

def onig_pattern(pattern: str) -> "re.Pattern":
    """An Oniguruma pattern of the kind the converters write, for ``re``:
    ``\\p{L}``, ``\\p{N}``, ``\\s`` and ``\\S`` as Unicode classes."""
    letters, numbers, space = _classes()[:3]
    out, i, depth = [], 0, 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if pattern.startswith(("\\p{L}", "\\p{N}"), i):
                body = letters if pattern[i + 3] == "L" else numbers
                out.append(body if depth else f"[{body}]")
                i += 5
                continue
            if nxt in "sS":
                if nxt == "S" and depth:
                    raise refuse(f"the pattern {pattern!r}")
                out.append(space if depth else
                           (f"[{space}]" if nxt == "s" else f"[^{space}]"))
                i += 2
                continue
            if nxt == "p":
                raise refuse(f"the pattern {pattern!r}")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not depth:
            depth = 1
        elif c == "]" and depth and out and out[-1] not in ("[", "[^"):
            depth = 0
        out.append(c)
        i += 1
    return re.compile("".join(out))


_GPT2 = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+"
         r"|\s+(?!\S)|\s+")


def _spans(text: str, pattern) -> List[Tuple[int, int, bool]]:
    """``text`` cut at the matches of ``pattern`` (a ``re`` pattern or a
    literal): (start, end, is_match) in order, empty matches left out."""
    out, last = [], 0
    if isinstance(pattern, str):
        if not pattern:
            return [(0, len(text), False)]
        at = text.find(pattern)
        while at >= 0:
            if at > last:
                out.append((last, at, False))
            out.append((at, at + len(pattern), True))
            last = at + len(pattern)
            at = text.find(pattern, last)
    else:
        for m in pattern.finditer(text):
            if m.start() == m.end():
                continue
            if m.start() > last:
                out.append((last, m.start(), False))
            out.append((m.start(), m.end(), True))
            last = m.end()
    if last < len(text):
        out.append((last, len(text), False))
    return out


def split_pieces(piece: Piece, pattern, behavior: str,
                 invert: bool = False) -> List[Piece]:
    """``tokenizers``' ``NormalizedString::split`` with a delimiter
    behavior; empty pieces are dropped."""
    text, first = piece
    spans = [(a, b, m != invert) for a, b, m in _spans(text, pattern)]
    if behavior == "Removed":
        keep = [(a, b) for a, b, m in spans if not m]
    elif behavior == "Isolated":
        keep = [(a, b) for a, b, _ in spans]
    elif behavior == "MergedWithPrevious":
        keep, prev = [], False
        for a, b, m in spans:
            if m and not prev and keep:
                keep[-1] = (keep[-1][0], b)
            else:
                keep.append((a, b))
            prev = m
    elif behavior == "MergedWithNext":
        keep, prev = [], False
        for a, b, m in reversed(spans):
            if m and not prev and keep:
                keep[-1] = (a, keep[-1][1])
            else:
                keep.append((a, b))
            prev = m
        keep.reverse()
    elif behavior == "Contiguous":
        keep, prev = [], False
        for a, b, m in spans:
            if m == prev and keep:
                keep[-1] = (keep[-1][0], b)
            else:
                keep.append((a, b))
            prev = m
    else:
        raise refuse(f"the split behavior {behavior}")
    return [(text[a:b], first and a == 0) for a, b in keep if b > a]


@lru_cache()
def _byte_level_map() -> Tuple[str, ...]:
    table = bytes_to_unicode()
    return tuple(table[b] for b in range(256))


def _byte_level(spec: dict):
    prefix = spec.get("add_prefix_space", True)
    use_regex = spec.get("use_regex", True)
    table = _byte_level_map()

    def run(pieces: List[Piece]) -> List[Piece]:
        out = []
        for text, first in pieces:
            if prefix and not text.startswith(" "):
                text = " " + text
            parts = (split_pieces((text, first), _gpt2(), "Isolated")
                     if use_regex else [(text, first)])
            out += [("".join(table[b] for b in t.encode("utf-8")), f)
                    for t, f in parts]
        return out
    return run


@lru_cache()
def _gpt2() -> "re.Pattern":
    return onig_pattern(_GPT2)


def _metaspace(spec: dict):
    repl = spec.get("replacement", "▁")
    scheme = spec.get("prepend_scheme", "always")
    if spec.get("add_prefix_space") is False and scheme != "never":
        raise ValueError("Metaspace: add_prefix_space false and "
                         f"prepend_scheme {scheme!r} disagree")
    split = spec.get("split", True)

    def run(pieces: List[Piece]) -> List[Piece]:
        out = []
        for text, first in pieces:
            text = text.replace(" ", repl)
            if not text.startswith(repl) and (
                    scheme == "always" or (scheme == "first" and first)):
                text = repl + text
            out += (split_pieces((text, first), repl, "MergedWithNext")
                    if split else [(text, first)])
        return out
    return run


def _split_with(pattern, behavior: str, invert: bool = False):
    def run(pieces: List[Piece]) -> List[Piece]:
        return [q for p in pieces
                for q in split_pieces(p, pattern, behavior, invert)]
    return run


@lru_cache()
def _bert_pattern() -> "re.Pattern":
    punct, ws = _class("bert_punct"), re.escape(_white_space())
    return re.compile(f"[{punct}]|[^{ws}{punct}]+")


@lru_cache()
def _whitespace_pattern() -> "re.Pattern":
    word, ws = _class("word"), re.escape(_white_space())
    return re.compile(f"[{word}]+|[^{word}{ws}]+")


def _find_all(pattern: "re.Pattern"):
    def run(pieces: List[Piece]) -> List[Piece]:
        return [(m.group(), first and m.start() == 0) for text, first in pieces
                for m in pattern.finditer(text)]
    return run


def pre_tokenizer(spec: Optional[dict]):
    """A ``tokenizers`` pre-tokenizer from its JSON form: a function from
    pieces to pieces (an empty piece gives none)."""
    if spec is None:
        return None
    run = _pre_tokenizer(spec)
    return lambda pieces: run([p for p in pieces if p[0]])


def _pre_tokenizer(spec: dict):
    kind = spec.get("type")
    if kind == "Sequence":
        parts = [_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def run(pieces: List[Piece]) -> List[Piece]:
            for p in parts:
                pieces = p(pieces)
            return pieces
        return run
    if kind == "BertPreTokenizer":
        return _find_all(_bert_pattern())
    if kind == "ByteLevel":
        return _byte_level(spec)
    if kind == "Metaspace":
        return _metaspace(spec)
    if kind == "WhitespaceSplit":
        return _find_all(re.compile(f"[^{re.escape(_white_space())}]+"))
    if kind == "Whitespace":
        return _find_all(_whitespace_pattern())
    if kind == "Split":
        pattern = spec["pattern"]
        pattern = (pattern["String"] if "String" in pattern
                   else onig_pattern(pattern["Regex"]))
        return _split_with(pattern, spec["behavior"],
                           spec.get("invert", False))
    raise refuse(f"the {kind} pre-tokenizer")


# ------------------------------------------------------------------- models

class WordPiece:
    """Greedy longest match first, a whole-word unk."""

    def __init__(self, spec: dict) -> None:
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, word: str) -> List[int]:
        if word in self.cache:
            return self.cache[word]
        if len(word) > self.max_chars:
            return [self.vocab[self.unk]]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end] if start == 0 else \
                    self.prefix + word[start:end]
                if sub in self.vocab:
                    break
                end -= 1
            else:
                out = [self.vocab[self.unk]]
                break
            out.append(self.vocab[sub])
            start = end
        self.cache[word] = out
        return out


def _merges(raw) -> List[Tuple[str, str]]:
    out = []
    for m in raw:
        if isinstance(m, str):
            parts = m.split(" ")
            if len(parts) != 2:
                raise ValueError(f"a BPE merge of two parts, not {m!r}")
            m = parts
        out.append((m[0], m[1]))
    return out


def byte_pieces(s: str, vocab: Dict[str, int]) -> Optional[List[int]]:
    """The ids of ``<0xNN>`` for each UTF-8 byte of ``s``, or None where
    the vocabulary lacks one (``tokenizers``' ``byte_fallback``)."""
    ids = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
    return None if None in ids else ids


class BPE:
    """Merges by rank over the word's symbols (``tokenizers``' queue: the
    lowest rank first, then the leftmost)."""

    def __init__(self, spec: dict) -> None:
        if spec.get("dropout") not in (None, 0, 0.0):
            raise refuse("BPE dropout")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.vocab: Dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.fuse_unk = spec.get("fuse_unk", False)
        self.ignore_merges = spec.get("ignore_merges", False)
        self.merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, (a, b) in enumerate(_merges(spec.get("merges", []))):
            new = a + b[len(self.prefix):]
            self.merges[(self.vocab[a], self.vocab[b])] = (rank,
                                                           self.vocab[new])
        self.cache: Dict[str, List[int]] = {}

    def _symbols(self, word: str) -> List[int]:
        out, unk = [], None
        for i, c in enumerate(word):
            s = (self.prefix if i else "") + c + (
                self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk is not None:
                    out.append(unk)
                    unk = None
                out.append(self.vocab[s])
                continue
            if self.byte_fallback:
                spelled = byte_pieces(s, self.vocab)
                if spelled is not None:
                    # a pending unk stays pending, as in tokenizers
                    out += spelled
                    continue
            if self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    out.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            out.append(unk)
        return out

    def tokenize(self, word: str) -> List[int]:
        if word in self.cache:
            return self.cache[word]
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids = self._symbols(word)
        n = len(ids)
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        queue = []
        for i in range(n - 1):
            m = self.merges.get((ids[i], ids[i + 1]))
            if m:
                queue.append((m[0], i, m[1]))
        heapq.heapify(queue)
        while queue:
            rank, pos, new = heapq.heappop(queue)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((ids[pos], ids[right]))
            if m is None or m[1] != new:
                continue
            ids[pos] = new
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((ids[prv[pos]], new))
                if m:
                    heapq.heappush(queue, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((new, ids[nxt[pos]]))
                if m:
                    heapq.heappush(queue, (m[0], pos, m[1]))
        out = [t for t, a in zip(ids, alive) if a]
        self.cache[word] = out
        return out


class Unigram:
    """Viterbi over the pieces' scores; a character no piece starts with
    costs ``min_score - 10`` and is the unk, consecutive unks fused (and,
    under ``byte_fallback``, spelled in ``<0xNN>`` pieces)."""

    def __init__(self, spec: dict) -> None:
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.pieces = [(p, float(s)) for p, s in spec["vocab"]]
        self.ids = {p: i for i, (p, _) in enumerate(self.pieces)}
        self.unk_id = spec.get("unk_id")
        self.unk_score = min(s for _, s in self.pieces) - 10.0
        self.longest = max(len(p) for p, _ in self.pieces)
        self.cache: Dict[str, List[int]] = {}

    def tokenize(self, text: str) -> List[int]:
        if text in self.cache:
            return self.cache[text]
        n, ids, pieces = len(text), self.ids, self.pieces
        score = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        best = [0] * (n + 1)
        for i in range(n):
            here = score[i]
            single = False
            for j in range(i + 1, min(n, i + self.longest) + 1):
                t = ids.get(text[i:j])
                if t is None:
                    continue
                cand = pieces[t][1] + here
                if start[j] is None or cand > score[j]:
                    score[j], start[j], best[j] = cand, i, t
                single = single or j == i + 1
            if not single:
                if self.unk_id is None:
                    raise ValueError("Unigram: a character no piece starts "
                                     "with, and no unk_id")
                cand = self.unk_score + here
                if start[i + 1] is None or cand > score[i + 1]:
                    score[i + 1], start[i + 1], best[i + 1] = (
                        cand, i, self.unk_id)
        strings, unk, end = [], [], n
        while end > 0:
            s = start[end]
            if best[end] == self.unk_id:
                unk.append(text[s:end])
            else:
                if unk:
                    strings.append("".join(reversed(unk)))
                    unk = []
                strings.append(text[s:end])
            end = s
        if unk:
            strings.append("".join(reversed(unk)))
        out = []
        for t in reversed(strings):
            if t in ids:
                out.append(ids[t])
                continue
            spelled = byte_pieces(t, ids) if self.byte_fallback else None
            out += [self.unk_id] if spelled is None else spelled
        self.cache[text] = out
        return out


def model(spec: dict):
    kind = spec.get("type")
    if kind is None:
        kind = ("BPE" if "merges" in spec else "Unigram"
                if isinstance(spec.get("vocab"), list) else "WordPiece")
    if kind == "WordPiece":
        return WordPiece(spec)
    if kind == "BPE":
        return BPE(spec)
    if kind == "Unigram":
        return Unigram(spec)
    raise refuse(f"the {kind} model")


# ----------------------------------------------------------- post-processors

class PostProcessor:
    """Adds the specials of a single sequence; ``added`` counts them."""

    def __init__(self, spec: Optional[dict]) -> None:
        self.before: List[int] = []
        self.after: List[int] = []
        if spec is not None:
            self._read(spec)

    def _read(self, spec: dict) -> None:
        kind = spec.get("type")
        if kind == "Sequence":
            for p in spec["processors"]:
                self._read(p)
        elif kind in ("RobertaProcessing", "BertProcessing"):
            self.before.append(spec["cls"][1])
            self.after.append(spec["sep"][1])
        elif kind == "TemplateProcessing":
            special = spec.get("special_tokens", {})
            seen = False
            for item in spec["single"]:
                if "Sequence" in item:
                    seen = True
                    continue
                ids = special[item["SpecialToken"]["id"]]["ids"]
                (self.after if seen else self.before).extend(ids)
        elif kind != "ByteLevel":
            raise refuse(f"the {kind} post-processor")

    @property
    def added(self) -> int:
        return len(self.before) + len(self.after)

    def __call__(self, ids: List[int]) -> List[int]:
        return self.before + ids + self.after


# ---------------------------------------------------------- added vocabulary

_TOKEN_FLAGS = ("single_word", "lstrip", "rstrip", "normalized", "special")


def added_token(content: str, **flags) -> dict:
    """An added token's fields; ``normalized`` defaults to not ``special``,
    as in ``tokenizers``."""
    special = flags.get("special", False)
    return {"content": content, "single_word": flags.get("single_word", False),
            "lstrip": flags.get("lstrip", False),
            "rstrip": flags.get("rstrip", False),
            "normalized": flags.get("normalized", not special),
            "special": special}


class AddedVocabulary:
    """Added tokens matched leftmost-longest: those with ``normalized``
    false in the raw text, the others in the normalized pieces."""

    def __init__(self, tokens: List[dict], ids: Dict[str, int],
                 norm: Optional[Callable[[str], str]]) -> None:
        self.tokens = {t["content"]: t for t in tokens}
        self.ids = ids
        raw = [t["content"] for t in tokens if not t["normalized"]]
        normed: Dict[str, str] = {}
        for t in tokens:
            if t["normalized"]:
                normed.setdefault(norm(t["content"]) if norm
                                  else t["content"], t["content"])
        self.raw = self._matcher(raw)
        self.normed = self._matcher(list(normed))
        self.by_normed = normed

    @staticmethod
    def _matcher(contents: List[str]):
        contents = [c for c in contents if c]
        if not contents:
            return None
        order = sorted(range(len(contents)), key=lambda i: -len(contents[i]))
        return re.compile("|".join(re.escape(contents[i]) for i in order))

    def split(self, text: str, normalized: bool
              ) -> List[Tuple[str, Optional[int], int]]:
        """(piece, id of the token or None, start) in order."""
        pattern = self.normed if normalized else self.raw
        if pattern is None or not text:
            return [(text, None, 0)]
        out, last = [], 0
        ws = _white_space()
        for m in pattern.finditer(text):
            start, stop = m.start(), m.end()
            content = (self.by_normed[m.group()] if normalized
                       else m.group())
            tok = self.tokens[content]
            if tok["single_word"] and not (
                    (start == 0 or not _is_word(text[start - 1]))
                    and (stop == len(text) or not _is_word(text[stop]))):
                continue
            if tok["lstrip"]:
                start = max(len(text[:start].rstrip(ws)), last)
            if tok["rstrip"]:
                stop = len(text) - len(text[stop:].lstrip(ws))
            if last < start:
                out.append((text[last:start], None, last))
            out.append((text[start:stop], self.ids[content], start))
            last = stop
        if last < len(text):
            out.append((text[last:], None, last))
        return out


def _is_word(c: str) -> bool:
    return c == "_" or bool(re.match(f"[{_class('word')}]", c))


# ------------------------------------------------------------------ pipeline

# transformers' refusal to pad with a tokenizer that has no pad token
PAD_REFUSAL = (
    "Asking to pad but the tokenizer does not have a padding token. Please "
    "select a token to use as `pad_token` `(tokenizer.pad_token = "
    "tokenizer.eos_token e.g.)` or add a new pad token via "
    "`tokenizer.add_special_tokens({'pad_token': '[PAD]'})`.")


class Pipeline:
    """One tokenizer: ``encode(text)`` without specials, ``encode_batch``
    as ``batch_encode_plus(max_length=, padding="max_length",
    truncation=True)`` gives it (``pad_id`` None: transformers' padding
    ``ValueError``)."""

    def __init__(self, spec: dict, added: List[dict], *,
                 pad_id: Optional[int], sep_id: Optional[int],
                 padding_side: str = "right",
                 truncation_side: str = "right") -> None:
        self.normalizer = normalizer(spec.get("normalizer"))
        self.pre_tokenizer = pre_tokenizer(spec.get("pre_tokenizer"))
        self.model = model(spec["model"])
        self.post = PostProcessor(spec.get("post_processor"))
        self.ids = {t["content"]: t["id"] for t in added}
        self.added = AddedVocabulary(added, self.ids, self.normalizer)
        self.pad_id, self.sep_id = pad_id, sep_id
        if padding_side not in ("right", "left") or truncation_side not in (
                "right", "left"):
            raise ValueError("padding_side and truncation_side are 'right' "
                             "or 'left'")
        self.padding_side = padding_side
        self.truncation_side = truncation_side

    def encode(self, text: str) -> List[int]:
        out: List[int] = []
        for piece, tid, start in self.added.split(text, normalized=False):
            if tid is not None:
                out.append(tid)
                continue
            norm = self.normalizer(piece) if self.normalizer else piece
            for sub, tid, at in self.added.split(norm, normalized=True):
                if tid is not None:
                    out.append(tid)
                    continue
                if not sub:
                    continue
                pieces = [(sub, start == 0 and at == 0)]
                if self.pre_tokenizer is not None:
                    pieces = self.pre_tokenizer(pieces)
                for word, _ in pieces:
                    out += self.model.tokenize(word)
        return out

    def encode_batch(self, texts: Sequence[str], max_length: int
                     ) -> np.ndarray:
        if self.pad_id is None:
            raise ValueError(PAD_REFUSAL)
        keep = max_length - self.post.added
        if keep < 0:
            raise ValueError(f"max_length {max_length} leaves no room for "
                             f"the {self.post.added} special tokens")
        out = np.full((len(texts), max_length), self.pad_id, np.int64)
        for i, text in enumerate(texts):
            ids = self.encode(text)
            if len(ids) > keep:
                ids = (ids[:keep] if self.truncation_side == "right"
                       else ids[len(ids) - keep:])
            ids = self.post(ids)
            if self.padding_side == "right":
                out[i, :len(ids)] = ids
            else:
                out[i, max_length - len(ids):] = ids
        return out


# ----------------------------------------------------------- the directory

_BERT_SPECIAL = dict(unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                     cls_token="[CLS]", mask_token="[MASK]")
# the classes' special tokens by default
_CLASSES = {
    "Bert": _BERT_SPECIAL,
    "DistilBert": _BERT_SPECIAL,
    "Electra": _BERT_SPECIAL,
    "Roberta": dict(bos_token="<s>", eos_token="</s>", sep_token="</s>",
                    cls_token="<s>", unk_token="<unk>", pad_token="<pad>",
                    mask_token="<mask>"),
    "XLMRoberta": dict(bos_token="<s>", eos_token="</s>", sep_token="</s>",
                       cls_token="<s>", unk_token="<unk>", pad_token="<pad>",
                       mask_token="<mask>"),
    "T5": dict(eos_token="</s>", unk_token="<unk>", pad_token="<pad>"),
    "Albert": dict(bos_token="[CLS]", eos_token="[SEP]", unk_token="<unk>",
                   sep_token="[SEP]", pad_token="<pad>", cls_token="[CLS]",
                   mask_token="[MASK]"),
    # no pad token: padding to max_length raises
    "GPT2": dict(unk_token="<|endoftext|>", bos_token="<|endoftext|>",
                 eos_token="<|endoftext|>"),
    "Llama": dict(unk_token="<unk>", bos_token="<s>", eos_token="</s>"),
    "Gemma": dict(unk_token="<unk>", bos_token="<bos>", eos_token="<eos>",
                  pad_token="<pad>"),
}
# the SentencePiece-BPE classes: their fast constructor rewrites the
# post-processor from add_bos_token (default true) and add_eos_token
# (default false), and their padding_side is "left" unless told otherwise
_SPM_BPE = ("Llama", "Gemma")
# the classes transformers has only a SentencePiece (slow) class of
_SPM_ONLY = ("GPTSw3",)
# the WordPiece classes, whose vocab.txt BertConverter builds and whose
# keywords rewrite the BertNormalizer
_WORDPIECE = ("Bert", "DistilBert", "Electra")
# the classes whose constructor makes a string mask token an AddedToken
# that strips on its left
_LSTRIP_MASK = ("Roberta", "XLMRoberta", "Albert")
_SPECIAL = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
            "cls_token", "mask_token")
_MODEL_TYPES = {"bert": "Bert", "roberta": "Roberta",
                "xlm-roberta": "XLMRoberta", "t5": "T5", "mt5": "T5",
                "distilbert": "DistilBert", "electra": "Electra",
                "albert": "Albert", "roberta-prelayernorm": "Roberta",
                "gpt2": "GPT2", "opt": "GPT2", "llama": "Llama",
                "mistral": "Llama", "gemma": "Gemma", "gpt-sw3": "GPTSw3"}
# the keywords the port reads, beside the special tokens
KEYWORDS = frozenset(_SPECIAL) | {
    "additional_special_tokens", "padding_side", "truncation_side",
    "model_max_length", "do_lower_case", "strip_accents",
    "tokenize_chinese_chars", "do_basic_tokenize", "add_prefix_space",
    "trim_offsets", "extra_ids", "remove_space", "keep_accents",
    "add_bos_token", "add_eos_token"}


def _json(path: Path) -> dict:
    return json.loads(path.read_text(encoding="utf-8")) if path.is_file() \
        else {}


def _class_name(path: Path, config: dict) -> str:
    name = config.get("tokenizer_class")
    if name is None:
        model_type = _json(path / "config.json").get("model_type")
        if model_type not in _MODEL_TYPES:
            raise refuse(f"{path}: a tokenizer with no tokenizer_class and "
                         f"model_type {model_type!r}")
        return _MODEL_TYPES[model_type]
    base = name[:-4] if name.endswith("Fast") else name
    base = base[:-9] if base.endswith("Tokenizer") else base
    base = {"MT5": "T5"}.get(base, base)
    if base not in _CLASSES and base not in _SPM_ONLY:
        raise refuse(f"{path}: the tokenizer class {name}")
    return base


def _content(value) -> Tuple[str, dict]:
    """A special token's content and flags (a string or an AddedToken's
    fields)."""
    if isinstance(value, dict):
        return value["content"], {k: value[k] for k in _TOKEN_FLAGS
                                  if k in value}
    return str(value), {}


def bert_spec(path: Path, kw: dict) -> dict:
    """``BertConverter``'s pipeline of ``vocab.txt``."""
    with (path / "vocab.txt").open(encoding="utf-8") as f:
        vocab = {t.rstrip("\n"): i for i, t in enumerate(f.readlines())}
    basic = kw.get("do_basic_tokenize", True)
    lower = kw.get("do_lower_case", True)
    cls = _content(kw.get("cls_token", "[CLS]"))[0]
    sep = _content(kw.get("sep_token", "[SEP]"))[0]
    return {
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": basic and kw.get(
                           "tokenize_chinese_chars", True),
                       "strip_accents": kw.get("strip_accents") if basic
                       else False, "lowercase": basic and lower},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "model": {"type": "WordPiece",
                  "unk_token": _content(kw.get("unk_token", "[UNK]"))[0],
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": vocab},
        "post_processor": {"type": "TemplateProcessing", "single": [
            {"SpecialToken": {"id": cls, "type_id": 0}},
            {"Sequence": {"id": "A", "type_id": 0}},
            {"SpecialToken": {"id": sep, "type_id": 0}}],
            "special_tokens": {
                cls: {"id": cls, "ids": [vocab.get(cls)], "tokens": [cls]},
                sep: {"id": sep, "ids": [vocab.get(sep)], "tokens": [sep]}}},
        "added_tokens": []}


def roberta_spec(path: Path, kw: dict) -> dict:
    """``RobertaConverter``'s pipeline of ``vocab.json`` + ``merges.txt``."""
    vocab = _json(path / "vocab.json")
    with (path / "merges.txt").open(encoding="utf-8") as f:
        lines = f.read().split("\n")
    merges = [tuple(m.split()) for m in lines[1:-1]]
    prefix = kw.get("add_prefix_space", False)
    cls = _content(kw.get("cls_token", "<s>"))[0]
    sep = _content(kw.get("sep_token", "</s>"))[0]
    return {
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": prefix,
                          "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": "", "end_of_word_suffix": "",
                  "fuse_unk": False, "vocab": vocab, "merges": merges},
        "post_processor": {"type": "RobertaProcessing",
                           "sep": [sep, vocab.get(sep)],
                           "cls": [cls, vocab.get(cls)],
                           "trim_offsets": True, "add_prefix_space": prefix},
        "added_tokens": []}


def gpt2_spec(path: Path, kw: dict) -> dict:
    """``GPT2Converter``'s pipeline of ``vocab.json`` + ``merges.txt``
    (OPT's directories too): its post-processor adds the bos token under
    ``add_bos_token``, whose id ``load`` fills in."""
    spec = roberta_spec(path, kw)
    if kw.get("add_bos_token", False):
        bos = kw.get("bos_token", _CLASSES["GPT2"]["bos_token"])
        spec["post_processor"] = _template(_content(bos)[0], None)
    else:
        spec["post_processor"] = {"type": "ByteLevel", "trim_offsets": False}
    return spec


def _template(bos: Optional[str], eos: Optional[str]) -> dict:
    """``TemplateProcessing`` of ``[bos] $A [eos]``; the tokens' ids are
    filled in by ``load``."""
    single = [{"Sequence": {"id": "A", "type_id": 0}}]
    if bos is not None:
        single.insert(0, {"SpecialToken": {"id": bos, "type_id": 0}})
    if eos is not None:
        single.append({"SpecialToken": {"id": eos, "type_id": 0}})
    return {"type": "TemplateProcessing", "single": single,
            "special_tokens": {t: {"id": t, "ids": [None], "tokens": [t]}
                               for t in (bos, eos) if t is not None}}


def _class_rewrites(cls: str, spec: dict, kw: dict) -> None:
    """What the fast classes' constructors change in ``tokenizer.json``'s
    pipeline that reaches the ids: BERT's normalizer from its keywords, and
    a ByteLevel pre-tokenizer's ``add_prefix_space`` from the keyword
    (false by default).  RoBERTa's post-processor takes
    ``add_prefix_space`` and ``trim_offsets`` too, which move offsets
    only; ALBERT's ``do_lower_case``, ``remove_space`` and
    ``keep_accents`` change nothing where a ``tokenizer.json`` is read.
    Llama's and Gemma's post-processor becomes ``[bos] $A [eos]`` from
    ``add_bos_token`` and ``add_eos_token`` (``update_post_processor``).
    GPT-2's ``add_bos_token`` reaches the ids only through the converter
    of ``vocab.json`` + ``merges.txt`` (``gpt2_spec``)."""
    n = spec.get("normalizer")
    if cls in _WORDPIECE and n and n.get("type") == "BertNormalizer":
        state = {"clean_text": n.get("clean_text", True),
                 "handle_chinese_chars": n.get("handle_chinese_chars", True),
                 "strip_accents": n.get("strip_accents"),
                 "lowercase": n.get("lowercase", True)}
        want = {"lowercase": kw.get("do_lower_case", True),
                "strip_accents": kw.get("strip_accents"),
                "handle_chinese_chars": kw.get("tokenize_chinese_chars",
                                               True)}
        if any(state[k] != v for k, v in want.items()):
            spec["normalizer"] = {**n, **state, **want}
    pre = spec.get("pre_tokenizer")
    if pre and pre.get("type") == "ByteLevel":
        pre["add_prefix_space"] = kw.get("add_prefix_space", False)
    if cls in _SPM_BPE:
        bos = kw.get("bos_token", _CLASSES[cls]["bos_token"])
        eos = kw.get("eos_token", _CLASSES[cls]["eos_token"])
        add_bos = kw.get("add_bos_token", True)
        add_eos = kw.get("add_eos_token", False)
        if bos is None and add_bos:
            raise ValueError("add_bos_token = True but bos_token = None")
        if eos is None and add_eos:
            raise ValueError("add_eos_token = True but eos_token = None")
        spec["post_processor"] = _template(
            _content(bos)[0] if add_bos else None,
            _content(eos)[0] if add_eos else None)


def _specials(cls: str, kw: dict) -> Tuple[Dict[str, Tuple[str, dict]],
                                            List[Tuple[str, dict]]]:
    named = {}
    for key in _SPECIAL:
        value = kw.get(key, _CLASSES[cls].get(key))
        if value is None:
            continue
        content, flags = _content(value)
        if key == "mask_token" and cls in _LSTRIP_MASK \
                and not isinstance(value, dict):
            flags = {"lstrip": True, "rstrip": False, "normalized": False}
        named[key] = (content, flags)
    extra = [_content(v) for v in kw.get("additional_special_tokens") or []]
    if cls == "T5":
        n = kw.get("extra_ids", 100)
        if not any("<extra_id_" in c for c, _ in extra):
            extra += [(f"<extra_id_{i}>", {}) for i in range(n)]
    return named, extra


def load(path, **overrides) -> Pipeline:
    """The tokenizer of the directory ``path``; ``overrides`` are the
    keywords ``AutoTokenizer.from_pretrained`` takes (``KEYWORDS``)."""
    path = Path(path)
    unknown = sorted(set(overrides) - KEYWORDS)
    if unknown:
        raise refuse(f"the keyword(s) {', '.join(unknown)} of an HF "
                     "tokenizer")
    config = _json(path / "tokenizer_config.json")
    cls = _class_name(path, config)
    kw = dict(config, **overrides)
    legacy = "added_tokens_decoder" not in config
    if legacy:
        # transformers reads special_tokens_map.json only without an
        # added_tokens_decoder: its entries override the config's
        for key, value in _json(path / "special_tokens_map.json").items():
            if overrides.get(key):
                continue
            if key == "additional_special_tokens":
                have = kw.get(key) or []
                value = have + [v for v in value if v not in have]
            kw[key] = value
    if cls == "T5" and "add_prefix_space" in kw:
        # T5TokenizerFast rebuilds its pipeline from the SentencePiece model
        raise refuse(f"{path}: add_prefix_space on a T5 tokenizer",
                     SPM_ITEM)
    if cls == "Llama" and kw.get("add_prefix_space") is not None:
        # so does LlamaTokenizerFast (from_slow)
        raise refuse(f"{path}: add_prefix_space on a Llama tokenizer",
                     SPM_ITEM)
    if cls in _SPM_ONLY:
        raise refuse(f"{path}: the tokenizer class {cls}Tokenizer, which "
                     "transformers builds from the SentencePiece .model "
                     "alone", SPM_ITEM)
    if (path / "tokenizer.json").is_file():
        spec = _json(path / "tokenizer.json")
    elif cls in _WORDPIECE and (path / "vocab.txt").is_file():
        spec = bert_spec(path, kw)
    elif cls in ("Roberta", "GPT2") and (path / "vocab.json").is_file() \
            and (path / "merges.txt").is_file():
        spec = (roberta_spec if cls == "Roberta" else gpt2_spec)(path, kw)
    elif list(path.glob("*.model")):
        raise refuse(f"{path}: a SentencePiece .model with no "
                     "tokenizer.json", SPM_ITEM)
    else:
        raise refuse(f"{path}: a {cls} tokenizer directory without its "
                     "tokenizer.json")
    _class_rewrites(cls, spec, kw)
    m = spec["model"]
    vocab = (m["vocab"] if isinstance(m["vocab"], dict)
             else {p: i for i, (p, _) in enumerate(m["vocab"])})
    added: Dict[str, dict] = {}

    def add(content: str, flags: dict) -> None:
        """``tokenizers``' ``add_tokens``: an existing content takes the
        new flags; a new one the vocabulary's id, else the next free id."""
        tok = added_token(content, **flags)
        if content in added:
            if {k: added[content][k] for k in _TOKEN_FLAGS} != {
                    k: tok[k] for k in _TOKEN_FLAGS}:
                added[content].update(tok)
            return
        if content in vocab:
            tid = vocab[content]
        else:
            top = max([t["id"] for t in added.values()], default=None)
            tid = len(vocab) if top is None or top < len(vocab) else top + 1
        added[content] = dict(tok, id=tid)

    # tokenizer.json's ids are not read: its tokens are added again, in order
    for t in spec.get("added_tokens") or []:
        add(t["content"], {k: t[k] for k in _TOKEN_FLAGS if k in t})
    decoder = kw.get("added_tokens_decoder") or {}
    if legacy:
        decoder = {t["id"]: t for t in spec.get("added_tokens") or []}
    for _, t in sorted(decoder.items(), key=lambda x: int(x[0])):
        add(t["content"], {k: t[k] for k in _TOKEN_FLAGS if k in t})
    named, extra = _specials(cls, kw)
    for content, flags in list(named.values()) + extra:
        if content not in added:
            add(content, dict(flags, special=True))
    ids = {c: t["id"] for c, t in added.items()}

    def token_id(content: Optional[str]) -> Optional[int]:
        if content is None:
            return None
        tid = ids.get(content, vocab.get(content))
        unk = named.get("unk_token")
        return tid if tid is not None or unk is None else token_id(unk[0])

    post = spec.get("post_processor") or {}
    if post.get("type") == "TemplateProcessing":
        for t in post.get("special_tokens", {}).values():
            if t["ids"] == [None]:
                t["ids"] = [token_id(t["id"])]
    pad = named.get("pad_token")
    sep = named.get("sep_token")
    padding = spec.get("padding") or {}
    truncation = spec.get("truncation") or {}
    return Pipeline(
        spec, sorted(added.values(), key=lambda t: t["id"]),
        pad_id=token_id(pad[0]) if pad else None,
        sep_id=token_id(sep[0]) if sep else None,
        padding_side=kw.get("padding_side", padding.get(
            "direction", "left" if cls in _SPM_BPE else "right")
        ).lower(),
        truncation_side=kw.get("truncation_side", truncation.get(
            "direction", "right")).lower())
