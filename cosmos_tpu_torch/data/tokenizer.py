"""Byte-BPE tokenizer of the OpenAI CLIP vocabulary (counterpart of
``cosmos_tpu/data/tokenizer.py``: ``bytes_to_unicode``, ``SimpleTokenizer``,
``tokenize``, ``decode``).

The merge table (``cosmos_tpu_torch/assets/bpe_merges.json.gz``) is a byte
copy of the JAX package's.  The vocabulary is built the same way: 256 byte
symbols, their ``</w>`` variants, one entry per merge, then
``<start_of_text>`` and ``<end_of_text>``, 49408 ids in all.

The JAX package splits words with the ``regex`` module's pattern
``<special>|'s|'t|'re|'ve|'m|'ll|'d|[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+``
under ``IGNORECASE``.  This module has the same split with the standard
``re`` module: the letter, number and whitespace classes are built from
``unicodedata`` (categories ``L*`` and ``N*``; whitespace as ``regex``'s
``\\s``), and the case-insensitive literals from ``str.casefold``.  Under
``IGNORECASE`` the ``regex`` module also keeps out of the negated class a
mark whose other case is a letter (U+0345): such characters match no
alternative and are dropped, here too.  The two agree on every code point
that the Unicode version of ``unicodedata`` assigns.

Outputs are numpy int32 arrays of shape ``[N, context_length]``.
"""

from __future__ import annotations

import gzip
import html
import json
import re
import sys
import unicodedata
from functools import lru_cache
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:  # pragma: no cover - env without ftfy
    _HAS_FTFY = False

DEFAULT_CONTEXT_LENGTH = 77
_ASSETS = Path(__file__).resolve().parent.parent / "assets"
# regex's \s is the White_Space property: str.isspace() minus the four
# information separators
_NOT_WHITE_SPACE = frozenset("\x1c\x1d\x1e\x1f")


@lru_cache()
def default_merges_path() -> str:
    return str(_ASSETS / "bpe_merges.json.gz")


@lru_cache()
def bytes_to_unicode():
    """Reversible byte <-> printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    return text.strip()


def whitespace_clean(text: str) -> str:
    return " ".join(text.split()).strip()


def _ranges(points: List[int]) -> str:
    """A character-class body for sorted code points, as escaped ranges."""
    out, i = [], 0
    while i < len(points):
        j = i
        while j + 1 < len(points) and points[j + 1] == points[j] + 1:
            j += 1
        lo, hi = re.escape(chr(points[i])), re.escape(chr(points[j]))
        out.append(lo if i == j else f"{lo}-{hi}")
        i = j + 1
    return "".join(out)


@lru_cache()
def _classes():
    """(letters, numbers, whitespace, neither) class bodies, and a map from
    each ASCII letter to every character that casefolds to it."""
    letters, numbers, space, neither = [], [], [], []
    folds = {}
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        cat = unicodedata.category(c)
        if cat[0] == "L":
            letters.append(cp)
            # only a letter casefolds to an ASCII letter
            f = c.casefold()
            if len(f) == 1 and "a" <= f <= "z":
                folds.setdefault(f, []).append(c)
        elif cat[0] == "N":
            numbers.append(cp)
        elif cat[0] in "ZC" and c.isspace():
            if c not in _NOT_WHITE_SPACE:
                space.append(cp)
        elif cat not in ("Cn", "Cs") and any(
                len(v) == 1 and unicodedata.category(v)[0] in "LN"
                for v in (c.lower(), c.upper(), c.casefold())):
            neither.append(cp)
    return (_ranges(letters), _ranges(numbers), _ranges(space),
            _ranges(neither), {k: "".join(v) for k, v in folds.items()})


def _ci(literal: str, folds) -> str:
    """``literal`` as a pattern that matches it case-insensitively."""
    return "".join(f"[{re.escape(folds[c.lower()])}]"
                   if c.lower() in folds else re.escape(c) for c in literal)


def word_pattern(special_tokens: List[str]) -> "re.Pattern":
    """The JAX tokenizer's word split, for the standard ``re`` module."""
    letters, numbers, space, neither, folds = _classes()
    alternatives = [_ci(t, folds) for t in special_tokens]
    alternatives += [_ci(c, folds)
                     for c in ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")]
    alternatives += [f"[{letters}]+", f"[{numbers}]",
                     f"[^{space}{letters}{numbers}{neither}]+"]
    return re.compile("|".join(alternatives))


class SimpleTokenizer:
    """The JAX package's default tokenizer (``clean="lower"``, no extra
    special tokens, no reduction mask)."""

    def __init__(self, context_length: int = DEFAULT_CONTEXT_LENGTH):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(default_merges_path(), "rt", encoding="utf-8") as f:
            merges = [tuple(p) for p in json.load(f)]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        special_tokens = ["<start_of_text>", "<end_of_text>"]
        vocab.extend(special_tokens)
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {t: t for t in special_tokens}
        self.pat = word_pattern(special_tokens)
        self.vocab_size = len(self.encoder)
        self.all_special_ids = [self.encoder[t] for t in special_tokens]
        self.sot_token_id = self.all_special_ids[0]
        self.eot_token_id = self.all_special_ids[1]
        self.context_length = context_length

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(
                self.encoder[t] for t in self.bpe(token).split(" ")
            )
        return bpe_tokens

    def decode(self, tokens) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(
        self,
        texts: Union[str, List[str]],
        context_length: Optional[int] = None,
    ) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        context_length = context_length or self.context_length
        result = np.zeros((len(texts), context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


_default_tokenizer: Optional[SimpleTokenizer] = None


def _get_default() -> SimpleTokenizer:
    global _default_tokenizer
    if _default_tokenizer is None:
        _default_tokenizer = SimpleTokenizer()
    return _default_tokenizer


def tokenize(
    texts: Union[str, List[str]], context_length: int = DEFAULT_CONTEXT_LENGTH
) -> np.ndarray:
    return _get_default()(texts, context_length=context_length)


def decode(output_ids) -> str:
    return _get_default().decode(np.asarray(output_ids))
