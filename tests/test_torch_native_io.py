"""The port's native data path (cosmos_tpu_torch/data/native.py over
csrc/tario.cpp) against cosmos_tpu's (cosmos_tpu/data/native.py over
native/tario.cpp): tar grouping, DCT-scaled JPEG decode and the training
loader's batches, all bit for bit; and the port's build (concurrent builds,
a failed build, libjpeg from Pillow's wheel).

The port compiles its own copy of tario.cpp with g++ against the libjpeg
6.2 headers it carries; the JAX package loads its committed library.
"""

import dataclasses
import io
import queue
import subprocess
import sys
import tarfile
import threading
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cosmos_tpu.data import loader as jloader
from cosmos_tpu.data import native as jnative
from cosmos_tpu.data import webdataset as jwds
from cosmos_tpu_torch.data import loader as ploader
from cosmos_tpu_torch.data import native
from cosmos_tpu_torch.data import webdataset as pwds
from cosmos_tpu_torch.data.synthetic import write_shards

ROOT = Path(__file__).resolve().parents[1]
REG = tarfile.REGTYPE
LONG = "a" * 120 + "/" + "b" * 40


def _write_tar(path, members):
    with tarfile.open(path, "w", format=tarfile.GNU_FORMAT) as tf:
        for name, data, kind in members:
            info = tarfile.TarInfo(name)
            info.type = kind
            if kind == REG:
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            else:
                info.linkname = "target" if kind == tarfile.SYMTYPE else ""
                tf.addfile(info)


def _truncated(path):
    """A shard cut in the middle of its third member's data."""
    full = str(path) + ".full"
    _write_tar(full, [("k1.jpg", b"x" * 1000, REG), ("k1.json", b"{}", REG),
                      ("k2.jpg", b"y" * 3000, REG), ("k2.json", b"{}", REG)])
    Path(path).write_bytes(Path(full).read_bytes()[:512 * 5 + 100])


TARS = {
    "plain": [("00001.jpg", b"img1", REG), ("00001.json", b"{}", REG),
              ("00002.jpg", b"img2", REG), ("00002.json", b"{2}", REG)],
    "dot_slash": [("./00001.jpg", b"a", REG), ("./00001.json", b"{}", REG),
                  ("./00002.jpg", b"b", REG), ("./00002.json", b"{}", REG)],
    "dotted_directory": [("v1.2/0001.jpg", b"a", REG),
                         ("v1.2/0001.json", b"{}", REG)],
    "repeated_extension": [("k.jpg", b"first", REG), ("k.json", b"{1}", REG),
                           ("k.jpg", b"second", REG), ("k.json", b"{2}", REG)],
    "gnu_long_names": [(LONG + ".jpg", b"1", REG), (LONG + ".json", b"{}", REG),
                       ("k2.JPG", b"2", REG)],
    "non_regular_members": [("dir", b"", tarfile.DIRTYPE),
                            ("k.jpg", b"1", REG),
                            ("k.lnk", b"", tarfile.SYMTYPE),
                            ("k.json", b"{}", REG)],
    "truncated": None,
}


@pytest.mark.parametrize("case", sorted(TARS))
def test_tar_grouping_equals_jax_and_tarfile(tmp_path, case):
    path = tmp_path / f"{case}.tar"
    if TARS[case] is None:
        _truncated(path)
    else:
        _write_tar(path, TARS[case])
    with native.NativeTarStream([str(path)]) as stream:
        got = list(stream)
    want = list(jnative.NativeTarStream([str(path)]))
    assert got == want
    assert got == list(pwds.tar_to_samples(str(path)))
    assert got and all(isinstance(s["__key__"], bytes) for s in got)
    if case == "repeated_extension":
        assert [s["jpg"] for s in got] == [b"first", b"second"]


def test_stream_reads_several_shards_in_order(tmp_path):
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"s{i}.tar"))
        _write_tar(paths[-1], [(f"{i}.jpg", b"x", REG), (f"{i}.txt", b"t", REG)])
    got = [s["__key__"] for s in native.NativeTarStream(paths, capacity=1)]
    assert got == [b"0", b"1", b"2"]
    assert list(native.NativeTarStream([str(tmp_path / "missing.tar")])) == []


# --- decode ---------------------------------------------------------------

ENCODINGS = {
    "baseline_444": dict(mode="RGB", subsampling=0),
    "baseline_420": dict(mode="RGB", subsampling=2),
    "progressive_420": dict(mode="RGB", subsampling=2, progressive=True),
    "grayscale": dict(mode="L"),
}


def _jpeg(short, encoding, seed=0):
    """A smooth seeded image, short side ``short``, as JPEG bytes."""
    kw = dict(ENCODINGS[encoding])
    mode = kw.pop("mode")
    rng = np.random.default_rng([seed, short])
    w, h = short + 16, short
    coarse = rng.integers(0, 256, (h // 64 + 2, w // 64 + 2, 3), np.uint8)
    img = Image.fromarray(coarse).resize((w, h), Image.BILINEAR)
    buf = io.BytesIO()
    img.convert(mode).save(buf, "JPEG", quality=90, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("encoding", sorted(ENCODINGS))
@pytest.mark.parametrize("short,denom", [(300, 1), (900, 2), (1800, 4),
                                         (3600, 8)])
def test_decode_equals_jax_bit_for_bit(short, denom, encoding):
    data = _jpeg(short, encoding)
    lib = native.load()
    assert native.scale_denom(lib, data, 448) == denom
    assert native.scale_denom(lib, data, None) == 1
    got = {}
    for min_size in (None, 448):
        got[min_size] = native.decode_jpeg_scaled(data, min_size)
        want = jnative.decode_jpeg_scaled(data, min_size)
        assert got[min_size].dtype == np.uint8 and got[min_size].shape[2] == 3
        np.testing.assert_array_equal(got[min_size], want)
    assert min(got[448].shape[:2]) == -(-short // denom)
    # at denominator 1 the native decode gives PIL's bits (both run
    # libjpeg-turbo's integer IDCT and fancy upsampling)
    pil = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    np.testing.assert_array_equal(got[None], pil)


def _cmyk_jpeg():
    buf = io.BytesIO()
    Image.new("CMYK", (40, 24), (10, 80, 160, 20)).save(buf, "JPEG")
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["cmyk", "corrupt"])
def test_refused_jpeg_gives_none_and_decode_sample_takes_pil(kind):
    data = (_cmyk_jpeg() if kind == "cmyk"
            else b"\xff\xd8\xff\xe0" + bytes(range(200)))
    assert native.decode_jpeg_scaled(data, 448) is None
    assert jnative.decode_jpeg_scaled(data, 448) is None
    sample = {"__key__": b"k", "jpg": data, "txt": b"a caption"}
    got = pwds.decode_sample(sample, jpeg_decoder=native.decode_jpeg_scaled)
    want = jwds.decode_sample(sample,
                              jpeg_decoder=jnative.decode_jpeg_scaled)
    if kind == "corrupt":
        assert got is None and want is None
        return
    assert got[1] == want[1] == {"raw_caption": ["a caption"]}
    assert got[0].mode == want[0].mode == "CMYK"
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))


# --- the loader -----------------------------------------------------------

def _worker_batches(loader_module, cfg, worker, n):
    """The first ``n`` batches of worker ``worker``'s loop (in a daemon
    thread, left blocked on its full queue): a worker's own sequence, which
    the loader's arrival order interleaves."""
    out = queue.Queue(maxsize=n)
    threading.Thread(target=loader_module._worker_loop,
                     args=(cfg, worker, 0, out, queue.Queue()),
                     daemon=True).start()
    return [out.get(timeout=60) for _ in range(n)]


def _take(loader, n):
    it = iter(loader)
    try:
        return [next(it) for _ in range(n)]
    finally:
        loader.shutdown()


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_native_loader_batches_equal_jax(tmp_path):
    assert jnative.available()   # JAX's side takes its native path
    urls = write_shards(str(tmp_path / "big-{i:04d}.tar"), 2, 3, seed=5,
                        size_range=(896, 960))
    common = dict(urls=urls, batch_size=3, num_workers=2, image_size=32,
                  local_crops_number=2, local_size=16, num_sampled_captions=4,
                  context_length=16, seed=7, use_native_io=True)
    pcfg = ploader.WdsTrainConfig(**common)
    jcfg = jloader.WdsTrainConfig(**common)
    # each worker's batches (one a shard, so one an epoch), bit for bit
    want = []
    for worker in range(2):
        got = _worker_batches(ploader, pcfg, worker, 2)
        want += _worker_batches(jloader, jcfg, worker, 2)
        for g, w in zip(got, want[-2:]):
            _assert_same(g, w)
    # the loaders' worker processes deliver those batches
    for loader in (ploader.WdsTrainLoader(pcfg), jloader.WdsTrainLoader(jcfg)):
        for got in _take(loader, 2):
            assert any(all(np.array_equal(got[k], w[k]) for k in w)
                       for w in want)
    # the DCT scale engaged: a 1/8 decode crops other pixels than PIL's
    pil = dataclasses.replace(pcfg, use_native_io=False)
    assert not np.array_equal(_worker_batches(ploader, pil, 0, 1)[0][
        "global_images"], want[0]["global_images"])


# --- the build --------------------------------------------------------------

def test_concurrent_builds_leave_one_whole_library(tmp_path):
    code = ("import sys\n"
            "from cosmos_tpu_torch.data import native\n"
            "lib = native.load(build_dir=sys.argv[1])\n"
            "assert native.decode_jpeg_scaled(open(sys.argv[2], 'rb').read())"
            ".shape == (300, 316, 3)\n"
            "assert 'torch' not in sys.modules\n")
    jpeg = tmp_path / "x.jpg"
    jpeg.write_bytes(_jpeg(300, "baseline_420"))
    out = tmp_path / "build"
    procs = [subprocess.Popen([sys.executable, "-c", code, str(out),
                               str(jpeg)], cwd=ROOT, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    assert [f.name for f in out.glob("*.so")] == [
        native.library_path(build_dir=out).name]


def test_a_failed_build_raises_naming_the_compiler(tmp_path):
    with pytest.raises(RuntimeError, match="no-such-cxx"):
        native.load(compiler="no-such-cxx", build_dir=tmp_path)
    assert not list(tmp_path.glob("*.so"))
    assert native.available()


def test_links_pillow_s_libjpeg_without_a_system_one(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_SYSTEM_LIB_GLOBS", ())
    assert "pillow.libs" in native.find_libjpeg()
    lib = native.load(build_dir=tmp_path)
    data = _jpeg(900, "progressive_420")
    got = native._decode(lib, data, native.scale_denom(lib, data, 448))
    np.testing.assert_array_equal(got, native.decode_jpeg_scaled(data, 448))
    monkeypatch.setattr(native.importlib.util, "find_spec", lambda name: None)
    with pytest.raises(RuntimeError, match="no libjpeg 6.2 library"):
        native.find_libjpeg()
