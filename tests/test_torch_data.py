"""The port's host data pipeline (cosmos_tpu_torch.data, training/
data_pipeline.py) against cosmos_tpu's under the same seeds: caption
sampling, the multi-crop, eval and plain train transforms, shard lists,
tar reading, the train and val loaders, the retrieval data, and the
prefetcher's CPU path.  Every comparison is exact.

Images are PNG members (or JPEG read with `use_native_io=False` on both
sides), so that both sides decode with PIL; tests/test_torch_native_io.py
holds the native tar reader and DCT-scaled JPEG decode to JAX's.
"""

import random
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from cosmos_tpu.data import caption as jcap
from cosmos_tpu.data import datasets as jds
from cosmos_tpu.data import loader as jloader
from cosmos_tpu.data import transforms as jtf
from cosmos_tpu.data import webdataset as jwds
from cosmos_tpu.data.tokenizer import SimpleTokenizer as JaxTokenizer
from cosmos_tpu.training import data_pipeline as jpipe
from cosmos_tpu_torch.data import caption as pcap
from cosmos_tpu_torch.data import datasets as pds
from cosmos_tpu_torch.data import loader as ploader
from cosmos_tpu_torch.data import transforms as ptf
from cosmos_tpu_torch.data import webdataset as pwds
from cosmos_tpu_torch.data.prefetch import DevicePrefetcher, to_device
from cosmos_tpu_torch.data.synthetic import write_coco, write_shards
from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
from cosmos_tpu_torch.training import data_pipeline as ppipe

ROOT = Path(__file__).resolve().parents[1]
MODES = ["raw", "raw_pixelprose", "random", "random_pixelprose", "short",
         "long", "textcrop", "textcrop_pixelprose"]
METAS = [
    {"raw_caption": ["a cat on a mat"],
     "shortIB_captions": ["a cat. on a mat"], "shortSV_captions": [],
     "shortLLA_captions": ["one", "two"], "longIB_captions": ["x. y. z"],
     "longSV_captions": "a single string", "longLLA_captions": None},
    {"original_caption": "orig", "caption": "one.\ntwo</s>three. four"},
    {},
]


@pytest.mark.parametrize("mode", MODES)
def test_sample_captions_equal_jax(mode):
    k = 1 if mode == "raw" else 8
    for seed, meta in enumerate(METAS):
        for rep in range(3):
            got = pcap.sample_captions(meta, k, mode,
                                       random.Random(seed * 10 + rep))
            want = jcap.sample_captions(meta, k, mode,
                                        random.Random(seed * 10 + rep))
            assert got == want
    assert pcap.split_caption(METAS[1]["caption"]) == jcap.split_caption(
        METAS[1]["caption"])
    tok, jtok = SimpleTokenizer(context_length=16), JaxTokenizer(
        context_length=16)
    np.testing.assert_array_equal(
        pcap.sample_and_tokenize(METAS[0], k, tok, mode, random.Random(3)),
        jcap.sample_and_tokenize(METAS[0], k, jtok, mode, random.Random(3)))


def _image(seed, size=(71, 53), mode="RGB"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
    return Image.fromarray(arr).convert(mode)


@pytest.mark.parametrize("as_uint8", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_multicrop_equals_jax(seed, as_uint8):
    kw = dict(image_size=32, local_crops_number=3, crop_scale=0.4,
              local_size=16, as_uint8=as_uint8)
    img = _image(seed, mode="L" if seed == 2 else "RGB")
    got = ptf.MulticropAugmentation(**kw)(img, random.Random(seed))
    want = jtf.MulticropAugmentation(**kw)(img, random.Random(seed))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="2 global crops"):
        ptf.MulticropAugmentation(global_crops_number=3)


@pytest.mark.parametrize("mode,interp", [("shortest", "bicubic"),
                                         ("longest", "bilinear"),
                                         ("squash", "random")])
def test_eval_transform_equals_jax(mode, interp):
    args = SimpleNamespace(image_mean=[0.5, 0.4, 0.3], image_std=None,
                           image_interpolation=interp, image_resize_mode=mode)
    for size in ((71, 53), (40, 90), (32, 32)):
        img = _image(sum(size), size)
        np.testing.assert_array_equal(
            ptf.eval_transform_from_args(args, 32)(img),
            jtf.eval_transform_from_args(args, 32)(img))
        np.testing.assert_array_equal(ptf.EvalTransform(image_size=24)(img),
                                      jtf.EvalTransform(image_size=24)(img))


@pytest.mark.parametrize("aug_cfg", [None, {"scale": "0.5 1.0",
                                            "color_jitter_prob": 0.9,
                                            "gray_scale_prob": 0.5,
                                            "color_jitter": [0.3, 0.3, 0.2]}])
def test_train_transform_equals_jax(aug_cfg):
    for seed in range(4):
        img = _image(seed)
        got = ptf.image_transform_train(32, aug_cfg=aug_cfg, as_uint8=True)(
            img, random.Random(seed))
        want = jtf.image_transform_train(32, aug_cfg=aug_cfg, as_uint8=True)(
            img, random.Random(seed))
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pattern", [
    "cc3m-train-{0000..0011}.tar", "a{1,2}b{08..10}.tar",
    "s3://b/{x,y}/{0..2}.tar::local-{0..1}.tar", "plain.tar"])
def test_shard_lists_equal_jax(pattern):
    assert pwds.braceexpand(pattern) == jwds.braceexpand(pattern)
    assert pwds.expand_urls(pattern) == jwds.expand_urls(pattern)
    urls, _ = pwds.expand_urls(pattern)
    w = "::".join("2" for _ in pattern.split("::"))
    assert pwds.expand_urls(pattern, w) == jwds.expand_urls(pattern, w)
    for kw in (dict(), dict(process_index=1, process_count=2),
               dict(worker_index=1, worker_count=3, seed=5),
               dict(resampled=True, weights=[1.0] * len(urls),
                    worker_index=2, worker_count=3)):
        p, j = (mod.ShardedShardList(urls, **kw)
                for mod in (pwds, jwds))
        for epoch in range(3):
            assert list(p.epoch_shards(epoch)) == list(j.epoch_shards(epoch))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    write_shards(str(d / "train-{i:04d}.tar"), 2, 5, seed=0, fmt="png",
                 size_range=(36, 70))
    write_shards(str(d / "jpg-{i:04d}.tar"), 1, 3, seed=1, fmt="jpg",
                 size_range=(36, 70))
    write_shards(str(d / "val-{i:04d}.tar"), 1, 7, seed=2, fmt="png",
                 size_range=(36, 70))
    write_coco(str(d / "root" / "coco"), 5, seed=3, fmt="png",
               size_range=(36, 70))
    return d


def test_tar_reading_equals_jax(data_dir):
    for shard in ("train-0000.tar", "jpg-0000.tar"):
        got = list(pwds.tar_to_samples(str(data_dir / shard)))
        want = list(jwds.tar_to_samples(str(data_dir / shard)))
        assert got == want and len(got) in (3, 5)
        for g, w in zip(got, want):
            gi, gm = pwds.decode_sample(g)
            wi, wm = jwds.decode_sample(w)
            assert gm == wm
            np.testing.assert_array_equal(np.asarray(gi), np.asarray(wi))
    assert list(pwds.tar_to_samples(str(data_dir / "missing.tar"))) == []


def _train_cfgs(data_dir, **kw):
    urls = [str(data_dir / "train-0000.tar"), str(data_dir / "train-0001.tar")]
    common = dict(dict(urls=urls, batch_size=3, num_workers=1, image_size=32,
                       local_crops_number=2, local_size=16,
                       num_sampled_captions=4, context_length=16, seed=7),
                  **kw)
    return (ploader.WdsTrainConfig(**common, use_native_io=False),
            jloader.WdsTrainConfig(**common, use_native_io=False))


@pytest.mark.parametrize("multicrop", [True, False])
def test_wds_train_loader_equals_jax(data_dir, multicrop):
    # one worker process each: the same shards, samples and crops in the
    # same order, batch for batch, bit for bit
    pcfg, jcfg = _train_cfgs(data_dir, use_multicrop=multicrop)
    got_l, want_l = ploader.WdsTrainLoader(pcfg), jloader.WdsTrainLoader(jcfg)
    try:
        for got, want in zip(*(_take(x, 4) for x in (got_l, want_l))):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
        assert got["global_images"].shape == (
            (2, 3, 32, 32, 3) if multicrop else (1, 3, 32, 32, 3))
    finally:
        got_l.shutdown()
        want_l.shutdown()


def _take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


def test_inline_loader_and_synthetic_loader_equal_jax(data_dir):
    pcfg, jcfg = _train_cfgs(data_dir, num_workers=0)
    for got, want in zip(_take(ploader.WdsTrainLoader(pcfg), 2),
                         _take(jloader.WdsTrainLoader(jcfg), 2)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    pcfg, jcfg = _train_cfgs(data_dir, caption_sampling_mode="random")
    p, j = (ppipe.SyntheticTrainLoader(pcfg, 16),
            jpipe.SyntheticTrainLoader(jcfg, 16))
    for x in (p, j):
        x.dataset.image_size = 40
        x.set_epoch(2)
    for got, want in zip(_take(p, 2), _take(j, 2)):
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_val_loader_and_retrieval_data_equal_jax(data_dir):
    urls = [str(data_dir / "val-0000.tar")]
    got = list(ploader.WdsValLoader(urls, 3, image_size=32, context_length=16,
                                    num_samples=5))
    want = list(jloader.WdsValLoader(urls, 3, image_size=32,
                                     context_length=16, num_samples=5))
    assert [g[0].shape[0] for g in got] == [3, 2]
    for (gi, gt), (wi, wt) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gt, wt)
    coco = str(data_dir / "root" / "coco")
    got = pds.RetrievalData.load("coco", coco, SimpleTokenizer())
    want = jds.RetrievalData.load("coco", coco, JaxTokenizer())
    np.testing.assert_array_equal(got.captions, want.captions)
    np.testing.assert_array_equal(got.caption_ids, want.caption_ids)
    np.testing.assert_array_equal(got.image_ids, want.image_ids)
    assert (got.image_paths, got.img2txt, got.txt2img) == (
        want.image_paths, want.img2txt, want.txt2img)
    assert got.captions.shape == (25, 77)


def test_flickr_pairs_equal_jax(tmp_path):
    import json

    root = tmp_path / "flickr30k-images"
    root.mkdir()
    entries = [{"image": "flickr30k-images/a.jpg", "caption": ["x", "y"]},
               {"image": "flickr30k-images/b.jpg", "caption": "z"}]
    (root / "flickr30k_test.json").write_text(json.dumps(entries))
    got = pds.read_flickr_pairs(str(root))
    assert got == jds.read_flickr_pairs(str(root))
    assert pds.map_img_cap(got) == jds.map_img_cap(got)


def test_prefetcher_cpu_path_and_close():
    batches = [{"a": np.full((2, 3), i, np.uint8), "b": np.arange(4) + i}
               for i in range(5)]
    with DevicePrefetcher(iter(batches), "cpu", depth=2) as pf:
        got = list(pf)
    assert len(got) == 5
    for i, g in enumerate(got):
        assert isinstance(g["a"], torch.Tensor) and g["a"].device.type == "cpu"
        assert torch.equal(g["a"], torch.full((2, 3), i, dtype=torch.uint8))
        assert torch.equal(g["b"], torch.arange(4) + i)
    assert torch.equal(to_device(batches[1], torch.device("cpu"))["b"],
                       torch.arange(4) + 1)

    def endless():
        i = 0
        while True:
            yield {"a": np.zeros(1) + i}
            i += 1

    pf = DevicePrefetcher(endless(), "cpu", depth=2)
    assert float(next(pf)["a"]) == 0.0
    pf.close()
    assert not pf._thread.is_alive()
    with pytest.raises(StopIteration):
        next(pf)

    def failing():
        yield {"a": np.zeros(1)}
        raise RuntimeError("bad shard")

    pf = DevicePrefetcher(failing(), "cpu")
    next(pf)
    with pytest.raises(RuntimeError, match="bad shard"):
        next(pf)
    with pytest.raises(ValueError):
        DevicePrefetcher(iter(batches), "cpu", depth=0)


def test_worker_imports_do_not_import_torch():
    # what a loader worker imports: numpy, PIL and the standard library
    code = ("import sys\n"
            "import cosmos_tpu_torch.data.loader, cosmos_tpu_torch.data.caption\n"
            "import cosmos_tpu_torch.data.transforms, cosmos_tpu_torch.data.webdataset\n"
            "import cosmos_tpu_torch.data.tokenizer, cosmos_tpu_torch.data.datasets\n"
            "import cosmos_tpu_torch.data.synthetic\n"
            "import cosmos_tpu_torch.data.native\n"
            "cosmos_tpu_torch.data.native.load()\n"
            # the workers re-import __main__: the trainer's module
            "import cosmos_tpu_torch.training.main\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
