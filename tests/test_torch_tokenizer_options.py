"""The port's tokenizer options (cosmos_tpu_torch.data.tokenizer) against
cosmos_tpu.data.tokenizer.SimpleTokenizer: every ``clean`` (lower,
whitespace, canonicalize) with every ``reduction_mask`` (none, simple,
random, shuffle, syntax) and an additional special token, on long and short
captions, token for token.  JAX's random masks draw from the global
``random`` and ``np.random``; the port's from the generator it is given,
seeded equally.  ``syntax`` runs on both sides against one stand-in for
``nltk``: a fixed tagger, so that nouns, adjectives, verbs and the rest
are ordered as nltk's tags would order them, and one whose data is missing
(``LookupError``), where both fall back to a whitespace split.  Also
``get_tokenizer``'s context length and keyword arguments, and the
generator's kind checked.
"""

import random
import re
import sys
import types

import numpy as np
import pytest

from cosmos_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from cosmos_tpu.models.factory import get_tokenizer as jax_get_tokenizer
from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
from cosmos_tpu_torch.models.factory import get_tokenizer

CLEANS = ("lower", "whitespace", "canonicalize")
# "syntax-no-data": the syntax mask with nltk's data missing
MASKS = ("", "simple", "random", "shuffle", "syntax", "syntax-no-data")
SPECIAL = ["<mask>"]
CONTEXT = 20
SEED = 3
CAPTIONS = [
    "A Dog_running on the BEACH, with waves!!  and the sunset's glow " * 4
    + "<MASK> near tall trees",
    "Hello   World_Test <mask> it's",
    "Two cats sleep quietly on a warm red sofa while rain falls outside the "
    "old window of a small house",
    "",
]


def _nltk(has_data: bool) -> types.ModuleType:
    """A stand-in for nltk: words and punctuation split, tagged by a fixed
    rule (DT, JJ, VB*, NN*), or LookupError as without nltk's data."""
    def word_tokenize(text):
        if not has_data:
            raise LookupError("punkt")
        return re.findall(r"\w+|[^\w\s]", text)

    def tag(word):
        w = word.lower()
        if len(w) <= 3:
            return "DT"
        if w.endswith(("ing", "ed")):
            return "VBG"
        if w.endswith(("y", "ful", "all", "arm")):
            return "JJ"
        return "NNS" if w.endswith("s") else "NN"

    nltk = types.ModuleType("nltk")
    nltk.tokenize = types.SimpleNamespace(word_tokenize=word_tokenize)
    nltk.pos_tag = lambda words: [(w, tag(w)) for w in words]
    return nltk


def _rng(mask):
    if mask == "simple":
        return random.Random(SEED)
    if mask in ("random", "shuffle"):
        return np.random.RandomState(SEED)
    return None


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("clean", CLEANS)
def test_options_equal_jax(clean, mask, monkeypatch):
    if mask.startswith("syntax"):
        monkeypatch.setitem(sys.modules, "nltk",
                            _nltk(has_data=mask == "syntax"))
        mask = "syntax"
    kw = dict(context_length=CONTEXT, clean=clean, reduction_mask=mask,
              additional_special_tokens=SPECIAL)
    random.seed(SEED)
    np.random.seed(SEED)
    want = JaxTokenizer(**kw)(CAPTIONS)
    got = SimpleTokenizer(rng=_rng(mask), **kw)(CAPTIONS)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_get_tokenizer_context_and_options():
    for name in ("coca_ViT-B-32", "ViT-B-16", ""):
        assert (get_tokenizer(name).context_length
                == jax_get_tokenizer(name).context_length)
    assert get_tokenizer("coca_ViT-B-32").context_length == 76
    tok = get_tokenizer("ViT-B-16", context_length=16, clean="canonicalize",
                        additional_special_tokens=SPECIAL)
    want = jax_get_tokenizer("ViT-B-16", context_length=16,
                             clean="canonicalize",
                             additional_special_tokens=SPECIAL)
    np.testing.assert_array_equal(tok(CAPTIONS), want(CAPTIONS))
    with pytest.raises(TypeError, match="random.Random"):
        SimpleTokenizer(reduction_mask="simple",
                        rng=np.random.RandomState(0))
    with pytest.raises(TypeError, match="RandomState"):
        SimpleTokenizer(reduction_mask="random", rng=random.Random(0))
