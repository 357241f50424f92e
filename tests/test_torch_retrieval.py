"""Port's retrieval eval (cosmos_tpu_torch.training.retrieval / zero_shot /
evaluate) against cosmos_tpu's on the same synthetic features: metrics
equal exactly, and EOT truncation is exact on the port's model."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.training import retrieval as jr
from cosmos_tpu.training import zero_shot as jz
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.training import retrieval as tr
from cosmos_tpu_torch.training import zero_shot as tz
from cosmos_tpu_torch.training.evaluate import make_encoders

TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
            vision_image_size=64, text_width=128, text_heads=2)


def _data(n_img, per_img, seed):
    """Synthetic retrieval set with shuffled raw ids (caption ids are not
    row indices), ``per_img`` captions per image."""
    rng = np.random.default_rng(seed)
    img_ids = rng.permutation(1000)[:n_img] + 5000
    cap_ids = rng.permutation(10 * n_img * per_img)[:n_img * per_img] + 77
    img2txt, txt2img = {}, {}
    for j, c in enumerate(cap_ids):
        i = int(img_ids[j // per_img])
        img2txt.setdefault(i, []).append(int(c))
        txt2img[int(c)] = [i]
    captions = rng.integers(1, 49000, (len(cap_ids), 12))
    return SimpleNamespace(captions=captions, caption_ids=cap_ids,
                           img2txt=img2txt, txt2img=txt2img), img_ids


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compute_retrieval_metrics(seed):
    rng = np.random.default_rng(seed)
    sim = rng.standard_normal((13, 29)).astype(np.float32)
    img2txt = {i: sorted(rng.choice(29, 2, replace=False).tolist())
               for i in range(13) if i != 4}
    txt2img = {c: int(rng.integers(13)) for c in range(29)}
    assert tr.compute_retrieval_metrics(sim, img2txt, txt2img, "x/") == \
        jr.compute_retrieval_metrics(sim, img2txt, txt2img, "x/")


@pytest.mark.parametrize("n", [7, 16])
def test_get_clip_metrics(n):
    rng = np.random.default_rng(n)
    img = rng.standard_normal((n, 8)).astype(np.float32)
    txt = img + 0.7 * rng.standard_normal((n, 8)).astype(np.float32)
    want = jr.get_clip_metrics(img, txt, 14.3)
    got = tr.get_clip_metrics(img, txt, 14.3)
    assert got.keys() == want.keys()
    for k in want:
        assert float(got[k]) == float(want[k]), k


@pytest.mark.parametrize("eot_truncate", [False, True])
def test_evaluate_retrieval(eot_truncate):
    data, img_ids = _data(10, 3, 0)
    rng = np.random.default_rng(1)
    w_img = rng.standard_normal((4 * 4 * 3, 16)).astype(np.float32)
    w_txt = rng.standard_normal((49408, 16)).astype(np.float32) * 0.01
    images = rng.standard_normal((10, 4, 4, 3)).astype(np.float32)
    batches = [(images[s:s + 4], img_ids[s:s + 4]) for s in (0, 4, 8)]

    # the same deterministic "encoders" for both packages: a fixed
    # projection of the pixels, a mean of token embeddings
    def feats_img(x):
        return x.reshape(x.shape[0], -1) @ w_img

    def feats_txt(t):
        return w_txt[t].mean(axis=1)

    want = jr.evaluate_retrieval(
        lambda x: jnp.asarray(feats_img(np.asarray(x))),
        lambda t: jnp.asarray(feats_txt(np.asarray(t))),
        data, batches, batch_size=4, eot_truncate=eot_truncate)
    got = tr.evaluate_retrieval(
        lambda x: torch.from_numpy(feats_img(np.asarray(x))),
        lambda t: torch.from_numpy(feats_txt(np.asarray(t))),
        data, [(torch.from_numpy(x), i) for x, i in batches], batch_size=4,
        eot_truncate=eot_truncate)
    assert got == want


def test_encode_in_batches_pads_and_trims():
    seen = []

    def fn(x):
        seen.append(tuple(x.shape))
        return x[:, :2] * 2

    arr = np.arange(30, dtype=np.float32).reshape(10, 3)
    out = tr.encode_in_batches(fn, arr, 4)
    np.testing.assert_array_equal(out, arr[:, :2] * 2)
    assert seen == [(4, 3)] * 3


@pytest.mark.parametrize("multiple", [1, 8, 16])
def test_truncate_to_eot_matches_jax(multiple):
    rng = np.random.default_rng(multiple)
    toks = np.zeros((6, 77), np.int64)
    for i, e in enumerate(rng.integers(3, 30, 6)):
        toks[i, :e] = rng.integers(1, 49000, e)
        toks[i, e] = 49407
    want = jz.truncate_to_eot(toks, multiple)
    np.testing.assert_array_equal(tz.truncate_to_eot(toks, multiple), want)
    assert torch.equal(tz.truncate_to_eot(torch.from_numpy(toks), multiple),
                       torch.from_numpy(want))


def test_truncate_to_eot_is_exact_on_the_port():
    model = create_model("ViT-Tiny-Test", device="cpu", **TINY)
    assert tz.supports_eot_truncation(model)
    rng = np.random.default_rng(3)
    toks = np.zeros((5, 16), np.int64)
    for i, e in enumerate(rng.integers(2, 6, 5)):
        toks[i, :e] = rng.integers(1, 49000, e)
        toks[i, e] = 49407
    _, enc_text, enc_raw = make_encoders(model)
    short = tz.truncate_to_eot(toks, multiple=4)
    assert short.shape[1] < toks.shape[1]
    for enc in (enc_text, enc_raw):
        torch.testing.assert_close(enc(short), enc(toks), atol=1e-6,
                                   rtol=1e-6)


def test_supports_eot_truncation_gate():
    model = create_model("ViT-Tiny-Test", device="cpu",
                         text_no_causal_mask=True)
    assert not tz.supports_eot_truncation(model)
    assert not tz.supports_eot_truncation(object())


def test_make_encoders_normalise_on_model_device():
    model = create_model("ViT-Tiny-Test", device="cpu", **TINY)
    enc_img, enc_txt, enc_raw = make_encoders(model)
    img = enc_img(np.zeros((2, 64, 64, 3), np.float32))
    toks = np.array([[49406, 5, 49407, 0], [49406, 9, 9, 49407]])
    assert img.device.type == "cpu" and img.shape == (2, 64)
    torch.testing.assert_close(img.norm(dim=-1), torch.ones(2))
    torch.testing.assert_close(enc_txt(toks),
                               torch.nn.functional.normalize(enc_raw(toks)))
    assert not torch.is_inference_mode_enabled()
