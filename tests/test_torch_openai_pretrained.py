"""OpenAI's checkpoints and the pretrained registry: the port's
models/openai.py and models/pretrained.py against cosmos_tpu's.

config_from_openai_state_dict on the ViT and ModifiedResNet layouts;
load_openai_model from a TorchScript archive of float16 tensors (OpenAI's
releases are such archives) and from a plain state dict, to the file's
weights in float32 and JAX's exactly, and the ViT's features within 1e-5
of JAX's; the registry equal to JAX's;
resolve_pretrained offline: a path as it is, a tag from the cache, the
sha256 an OpenAI URL carries passing and failing, and the refusals, with
urllib made to raise if anything touches it.  The archives are written as
chip_smoke.py's phase 20 writes ViT-L-14's (``chip_smoke._Archive``).
"""

import hashlib
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.models import openai as jopenai
from cosmos_tpu.models import pretrained as jpretrained
from cosmos_tpu_torch.models import openai as popenai
from cosmos_tpu_torch.models import pretrained as ppretrained
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model
from chip_smoke import _Archive
from cosmos_tpu.models import checkpoint as jckpt
from test_torch_checkpoint_load import jax_random
from test_torch_towers import register_config

FEAT_TOL = dict(atol=1e-5, rtol=1e-5)
RN_NAME = "RN-Tiny-OpenAITest"


@pytest.fixture(scope="module", autouse=True)
def _rn_config(tmp_path_factory):
    register_config(tmp_path_factory.mktemp("configs"), RN_NAME,
                    {"image_size": 64, "layers": [1, 1, 1, 1], "width": 8})


def _openai_state_dict(kind, seed=4):
    """OpenAI-layout float16 weights (a port model's, with OpenAI's integer
    entries)."""
    name = "ViT-Tiny-Test" if kind == "vit" else RN_NAME
    sd = {k: v.half() for k, v in create_model(
        name, device="cpu", seed=seed).state_dict().items()}
    sd.update(input_resolution=torch.tensor(32), context_length=torch.tensor(
        16), vocab_size=torch.tensor(sd["token_embedding.weight"].shape[0]))
    return sd


@pytest.mark.parametrize("kind", ["vit", "rn"])
def test_config_from_openai_state_dict(kind):
    sd = _openai_state_dict(kind)
    assert (popenai.config_from_openai_state_dict(sd)
            == jopenai.config_from_openai_state_dict(sd))


@pytest.mark.parametrize("kind,form", [("vit", "torchscript"),
                                       ("vit", "state_dict"),
                                       ("rn", "state_dict")])
def test_load_openai_model(tmp_path, kind, form):
    sd = _openai_state_dict(kind)
    path = str(tmp_path / "openai.pt")
    if form == "torchscript":
        torch.jit.save(torch.jit.script(_Archive(sd)), path)
    else:
        torch.save(sd, path)
    tm = popenai.load_openai_model(path, device="cpu")
    assert tm.cfg.quick_gelu
    got = tm.state_dict()
    for k, v in got.items():
        assert v.dtype == torch.float32
        assert torch.equal(v, sd[k].float()), k
    if form == "state_dict" and kind == "vit":
        return          # JAX's side: the archive's case, the same weights
    if kind == "rn":
        # JAX's load_openai_model less its init, which no key of the file
        # leaves standing: the config, then torch_state_dict_to_params
        raw = jopenai.config_from_openai_state_dict(sd)
        register_config(tmp_path, "RN-OpenAI-Inferred", raw["vision_cfg"])
        _, ref = jax_random("RN-OpenAI-Inferred", quick_gelu=True)
        jp = jckpt.torch_state_dict_to_params(sd, ref)
    else:
        jm, jp = jopenai.load_openai_model(path)
        assert jm.cfg.quick_gelu
    want = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jp))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    if kind == "rn":
        return          # RN's forward: tests/test_torch_towers.py
    size = tm.cfg.vision_cfg.image_size
    x = np.random.default_rng(0).standard_normal(
        (2, size, size, 3)).astype(np.float32)
    ref = jax.jit(lambda p, im: jm.apply({"params": p}, im, False,
                                         method=jm.encode_image))(
        jp, jnp.asarray(x))
    with torch.no_grad():
        out = tm.encode_image(torch.from_numpy(x))
    np.testing.assert_allclose(out["image_features"].numpy(),
                               np.asarray(ref["image_features"]), **FEAT_TOL)


def test_registry_equals_jax():
    assert ppretrained._PRETRAINED == jpretrained._PRETRAINED
    assert ppretrained.list_pretrained() == jpretrained.list_pretrained()
    assert popenai.list_openai_models() == jopenai.list_openai_models()
    for model in ("ViT-B-16", "MobileCLIP-B", "nothing"):
        assert (ppretrained.list_pretrained_tags_by_model(model)
                == jpretrained.list_pretrained_tags_by_model(model))
        for tag in ("cosmos_cc3m", "openai", "datacompdr", "none"):
            assert (ppretrained.get_pretrained_cfg(model, tag)
                    == jpretrained.get_pretrained_cfg(model, tag))
            assert (ppretrained.is_pretrained_cfg(model, tag)
                    == jpretrained.is_pretrained_cfg(model, tag))
            assert (ppretrained.get_pretrained_url(model, tag)
                    == jpretrained.get_pretrained_url(model, tag))
    for tag in ("openai", "datacompdr", "webli"):
        assert (ppretrained.list_pretrained_models_by_tag(tag)
                == jpretrained.list_pretrained_models_by_tag(tag))


@pytest.fixture
def offline(monkeypatch, tmp_path):
    """A cache directory of its own, and urllib raising if touched."""
    def refuse(*a, **kw):
        raise AssertionError("the network was touched")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setenv("COSMOS_TPU_CACHE", str(tmp_path / "cache"))
    (tmp_path / "cache").mkdir()
    return tmp_path / "cache"


def test_default_cache_dir(offline, monkeypatch):
    assert ppretrained.default_cache_dir() == jpretrained.default_cache_dir()
    monkeypatch.delenv("COSMOS_TPU_CACHE")
    assert ppretrained.default_cache_dir() == jpretrained.default_cache_dir()


def test_path_and_cached_tag(offline, tmp_path):
    path = tmp_path / "weights.pt"
    path.write_bytes(b"x")
    assert ppretrained.resolve_pretrained("ViT-B-16", str(path)) == str(path)
    cached = offline / "cosmos_vitb16_cc3m.pt"
    cached.write_bytes(b"weights")
    assert ppretrained.resolve_pretrained("ViT-B-16", "cosmos_cc3m") == str(
        cached)


@pytest.mark.parametrize("case", ["absent", "hf_only", "bad_sha256"])
def test_refusals_name_the_roadmap_item(offline, case):
    model, tag = {"absent": ("ViT-B-32", "cosmos_yfcc15m"),
                  "hf_only": ("EVA02-B-16", "merged2b_s8b_b131k"),
                  "bad_sha256": ("ViT-B-32", "openai")}[case]
    if case == "bad_sha256":
        (offline / "ViT-B-32.pt").write_bytes(b"not the release")
    with pytest.raises(NotImplementedError, match="NEEDS_DOWNLOAD|Not queued"
                       ) as e:
        ppretrained.resolve_pretrained(model, tag)
    assert ppretrained.NEEDS_DOWNLOAD in str(e.value)
    url = ppretrained.get_pretrained_url(model, tag)
    if url:
        assert url in str(e.value)


def test_unknown_tag_as_jax(offline):
    with pytest.raises(ValueError) as want:
        jpretrained.resolve_pretrained("ViT-B-16", "no_such_tag")
    with pytest.raises(ValueError) as got:
        ppretrained.resolve_pretrained("ViT-B-16", "no_such_tag")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("good", [True, False], ids=["pass", "fail"])
def test_sha256_of_the_url(offline, monkeypatch, good):
    """A tag whose URL carries the file's sha256; the openai tag forces
    QuickGELU on create_model, as in the JAX package."""
    sd = _openai_state_dict("vit")
    path = offline / "tiny.pt"
    torch.jit.save(torch.jit.script(_Archive(sd)), str(path))
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    if not good:
        digest = digest[::-1]
    url = f"https://openaipublic.azureedge.net/clip/models/{digest}/tiny.pt"
    assert ppretrained._url_sha256(url) == jpretrained._url_sha256(url)
    monkeypatch.setitem(ppretrained._PRETRAINED, "ViT-Tiny-Test",
                        {"openai": {"url": url}})
    if not good:
        with pytest.raises(NotImplementedError, match="sha256"):
            create_model("ViT-Tiny-Test", device="cpu", pretrained="openai")
        return
    tm = create_model("ViT-Tiny-Test", device="cpu", pretrained="openai")
    assert tm.cfg.quick_gelu
    for k, v in tm.state_dict().items():
        assert torch.equal(v, sd[k].float()), k
    assert os.path.exists(path)
