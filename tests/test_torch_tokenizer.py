"""The port's byte-BPE tokenizer (cosmos_tpu_torch.data.tokenizer) against
cosmos_tpu's, which splits words with the `regex` module; the port's split
uses the standard `re` module with classes built from `unicodedata`.

Exact equality throughout.  The limit: the two are held to each other on
the code points that this Python's `unicodedata` assigns (Unicode 15.0 in
Python 3.12); the `regex` module may know a newer Unicode, whose extra
letters and numbers the port's classes do not have.
"""

import json
import random
import subprocess
import sys
import unicodedata
from pathlib import Path

import numpy as np
import pytest
import regex

from cosmos_tpu.data import tokenizer as jt
from cosmos_tpu_torch.data import tokenizer as pt

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = json.loads((Path(__file__).parent / "golden_tokens.json").read_text())
ASSIGNED = [cp for cp in range(sys.maxunicode + 1)
            if unicodedata.category(chr(cp)) not in ("Cn", "Cs")]


@pytest.fixture(scope="module")
def toks():
    return pt.SimpleTokenizer(), jt.SimpleTokenizer()


@pytest.mark.parametrize("case", GOLDEN,
                         ids=[c["text"][:20] or "<empty>" for c in GOLDEN])
def test_golden_tokens(toks, case):
    np.testing.assert_array_equal(
        toks[0]([case["text"]])[0], np.asarray(case["ids"], np.int32))


def test_vocab_and_specials(toks):
    port, ref = toks
    assert port.encoder == ref.encoder
    assert (port.sot_token_id, port.eot_token_id, port.vocab_size) == (
        49406, 49407, 49408)


@pytest.mark.parametrize("block", range(4))
def test_word_split_equals_regex_on_every_assigned_code_point(toks, block):
    # every assigned code point, in runs of 48 neighbours, through both
    # patterns (a quarter of them per case)
    port, ref = toks
    cps = ASSIGNED[block::4]
    for i in range(0, len(cps), 48):
        s = "".join(chr(c) for c in cps[i:i + 48])
        assert port.pat.findall(s) == regex.findall(ref.pat, s), s


CASES = {
    # contractions and special tokens, case-insensitively as regex does
    "literals": ["it's", "IT'S", "we're", "they'VE", "i'm", "you'll", "he'd",
                 "'ſ 'ſtart", "x'st", "<start_of_text>", "<START_OF_TEXT>",
                 "a<end_of_text>b", "!<start_of_text>", "don't'll''s"],
    # letters beyond \w and numbers beyond \d
    "unicode": ["x² ½ Ⅻ ⅻ ① ٣ ߁", "naïve café ǅ ͅ ͅa", "日本語のテキスト",
                "Ελληνικά ΣΊΣΥΦΟΣ", "emoji 😀👍🏽 end", "tab\tnew\nline",
                "\x1c\x1d sep    nbsp", "&amp;lt; html &quot;"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_listed_strings(toks, name):
    port, ref = toks
    texts = CASES[name]
    np.testing.assert_array_equal(port(texts), ref(texts))
    np.testing.assert_array_equal(pt.tokenize(texts, 32),
                                  jt.tokenize(texts, 32))


@pytest.mark.parametrize("seed", range(3))
def test_seeded_corpus_equals_jax(toks, seed):
    # all of ASCII and Latin-1 once, then random strings of BMP code points
    # assigned in this Unicode version, some with words and spaces mixed in
    port, ref = toks
    rng = random.Random(seed)
    bmp = [cp for cp in ASSIGNED if cp < 0x10000]
    texts = ["".join(chr(c) for c in range(32 * seed, 32 * seed + 96))]
    texts += ["".join(chr(c) for c in range(0xA0 + 32 * seed, 0x100))]
    for _ in range(60):
        parts = [chr(rng.choice(bmp)) for _ in range(rng.randint(1, 24))]
        if rng.random() < 0.5:
            parts += [" a photo of ", "'s ", "42"]
            rng.shuffle(parts)
        texts.append("".join(parts))
    np.testing.assert_array_equal(port(texts), ref(texts))
    for t in texts[:10]:
        assert port.encode(t) == ref.encode(t)
        assert port.decode(port.encode(t)) == ref.decode(ref.encode(t))


def test_truncation_keeps_eot(toks):
    ids = toks[0](["word " * 200])[0]
    assert ids.shape == (77,) and ids[-1] == 49407


def test_imports_without_regex():
    code = ("import sys; sys.modules['regex'] = None\n"
            "from cosmos_tpu_torch.data.tokenizer import tokenize\n"
            "print(tokenize(['a photo of a cat'])[0, :6].tolist())\n"
            "assert 'torch' not in sys.modules")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[49406, 320, 1125, 539, 320, 2368]"
