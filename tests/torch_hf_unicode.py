"""The generator of ``cosmos_tpu_torch/assets/hf_unicode.json.gz``, the
Unicode tables of the port's HF tokenizer pipeline
(``cosmos_tpu_torch/data/hf_tokenizer.py``).

Run ``python tests/torch_hf_unicode.py`` in an environment with ``regex``
and ``tokenizers`` to rewrite the asset.  It holds code-point ranges:

- ``gcb_*``, ``incb_*``, ``extpict``: the Grapheme_Cluster_Break values,
  the Indic_Conjunct_Break values and Extended_Pictographic, as the
  ``regex`` module's tables give them (UAX #29's inputs);
- the sets where ``tokenizers`` reads older Unicode tables than the
  standard library's ``unicodedata``, found by running its components on
  every code point: what ``BertNormalizer``'s ``clean_text`` drops
  (``bert_drop``) and turns into a space (``bert_space``), what
  ``handle_chinese_chars`` pads (``bert_chinese``), what its
  ``strip_accents`` removes after NFD (``bert_marks``), what
  ``StripAccents`` removes (``strip_marks``), what ``BertPreTokenizer``
  isolates as punctuation (``bert_punct``), the characters its NFC, NFD,
  NFKC and NFKD tables do not know (``norm_unknown``: the port normalizes
  the runs between them with ``unicodedata``), and the word characters of
  the ``Whitespace`` pre-tokenizer (``word``).
"""

from __future__ import annotations

import gzip
import json
import sys
import unicodedata
from pathlib import Path

ASSET = (Path(__file__).resolve().parent.parent / "cosmos_tpu_torch"
         / "assets" / "hf_unicode.json.gz")
GCB = ("CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator",
       "Prepend", "SpacingMark", "L", "V", "T", "LV", "LVT")
INCB = ("Linker", "Consonant", "Extend")


def _ranges(points):
    out = []
    for p in sorted(points):
        if out and out[-1][1] == p - 1:
            out[-1][1] = p
        else:
            out.append([p, p])
    return out


def _all_chars() -> str:
    return "".join(chr(c) for c in range(sys.maxunicode + 1)
                   if not 0xD800 <= c < 0xE000)


def grapheme_tables() -> dict:
    import regex

    every = _all_chars()
    out = {}
    for v in GCB:
        out[f"gcb_{v}"] = _ranges(
            ord(c) for c in regex.findall(rf"\p{{Grapheme_Cluster_Break={v}}}",
                                          every))
    for v in INCB:
        out[f"incb_{v}"] = _ranges(
            ord(c) for c in regex.findall(
                rf"\p{{Indic_Conjunct_Break={v}}}", every))
    out["extpict"] = _ranges(
        ord(c) for c in regex.findall(r"\p{Extended_Pictographic}", every))
    return out


def _forms_unknown(chars) -> set:
    from tokenizers import normalizers as N

    forms = {"NFD": N.NFD(), "NFKD": N.NFKD(), "NFC": N.NFC(),
             "NFKC": N.NFKC()}
    unknown = set()
    for c in chars:
        for s in (c, "a" + c + "̴", c + "́", "e" + c,
                  c + "̴̖", "̖" + c + "̴",
                  "a̖" + c):
            if any(n.normalize_str(s) != unicodedata.normalize(f, s)
                   for f, n in forms.items()):
                unknown.add(ord(c))
                break
    return unknown


def tokenizers_tables() -> dict:
    from tokenizers import normalizers as N
    from tokenizers import pre_tokenizers as P

    chars = [c for c in _all_chars()]
    clean = N.BertNormalizer(clean_text=True, handle_chinese_chars=False,
                             strip_accents=False, lowercase=False)
    chinese = N.BertNormalizer(clean_text=False, handle_chinese_chars=True,
                               strip_accents=False, lowercase=False)
    marks = N.BertNormalizer(clean_text=False, handle_chinese_chars=False,
                             strip_accents=True, lowercase=False)
    strip = N.StripAccents()
    nfd = N.NFD()
    bert_pre = P.BertPreTokenizer()
    ws = P.Whitespace()
    out = {k: set() for k in ("bert_drop", "bert_space", "bert_chinese",
                              "bert_marks", "strip_marks", "bert_punct",
                              "word")}
    for c in chars:
        cp = ord(c)
        r = clean.normalize_str(c)
        if r == "":
            out["bert_drop"].add(cp)
        elif r == " " and c != " ":
            out["bert_space"].add(cp)
        if chinese.normalize_str(c) == f" {c} ":
            out["bert_chinese"].add(cp)
        if nfd.normalize_str(c) == c and marks.normalize_str("a" + c) == "a":
            out["bert_marks"].add(cp)
        if strip.normalize_str("a" + c) == "a":
            out["strip_marks"].add(cp)
        if [p for p, _ in bert_pre.pre_tokenize_str("a" + c + "b")] == [
                "a", c, "b"]:
            out["bert_punct"].add(cp)
        if [p for p, _ in ws.pre_tokenize_str("a" + c)] == ["a" + c]:
            out["word"].add(cp)
    assigned = [c for c in chars if unicodedata.category(c) != "Cn"]
    out["norm_unknown"] = _forms_unknown(assigned)
    return {k: _ranges(v) for k, v in out.items()}


def regex_unicode_version() -> str:
    """The newest Unicode version whose sample code point ``regex``
    assigns."""
    import regex

    samples = (("15.0.0", 0x1FAE8), ("15.1.0", 0x2FFC), ("16.0.0", 0x1C89),
               ("17.0.0", 0x10940))
    return [v for v, cp in samples
            if not regex.match(r"\p{Cn}", chr(cp))][-1]


def main() -> None:
    import regex
    import tokenizers

    doc = {"generator": "tests/torch_hf_unicode.py",
           "sources": {"regex": regex.__version__,
                       "regex_unicode": regex_unicode_version(),
                       "tokenizers": tokenizers.__version__,
                       "unicodedata": unicodedata.unidata_version},
           **grapheme_tables(), **tokenizers_tables()}
    with gzip.open(ASSET, "wt", encoding="utf-8") as f:
        json.dump(doc, f, separators=(",", ":"))


if __name__ == "__main__":
    main()
