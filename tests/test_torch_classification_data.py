"""The port's classification eval data (cosmos_tpu_torch.data.classification,
data.datasets.ImageFolderDataset and the ImageNet / classification-set keys
of training.data_pipeline.get_data) against cosmos_tpu's, sample for
sample, on small seeded layouts of each set's own files."""

import os
import pickle

import numpy as np
import pytest
from PIL import Image

from cosmos_tpu.data import classification as jcls
from cosmos_tpu.data import datasets as jds
from cosmos_tpu.data import transforms as jtf
from cosmos_tpu.training import data_pipeline as jdp
from cosmos_tpu.training import params as jparams
from cosmos_tpu_torch.data import classification as pcls
from cosmos_tpu_torch.data import datasets as pds
from cosmos_tpu_torch.data import transforms as ptf
from cosmos_tpu_torch.data.synthetic import write_cifar10, write_image_folder
from cosmos_tpu_torch.training import data_pipeline as pdp
from cosmos_tpu_torch.training import params as pparams


def _image(path, rng, size=(20, 14)):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), np.uint8)
                    ).save(path, format="PNG")


def _cifar100(root, rng):
    d = root / "cifar-100-python"
    d.mkdir(parents=True)
    with open(d / "test", "wb") as f:
        pickle.dump({b"data": rng.integers(0, 256, (7, 3072), np.uint8),
                     b"fine_labels": [int(v) for v in
                                      rng.integers(0, 100, 7)]}, f)


def _food101(root, rng):
    classes = ["ramen", "apple_pie", "baby_back_ribs"]
    (root / "meta").mkdir(parents=True)
    (root / "meta" / "classes.txt").write_text("\n".join(classes) + "\n")
    lines = [f"{c}/{i}" for i, c in enumerate(classes * 2)]
    (root / "meta" / "test.txt").write_text("\n".join(lines) + "\n")
    for line in lines:
        _image(str(root / "images" / f"{line}.jpg"), rng)


def _sun397(root, rng):
    classes = ["/a/abbey", "/b/bakery/shop", "/a/airport"]
    (root / "Partitions").mkdir(parents=True)
    (root / "ClassName.txt").write_text("\n".join(classes) + "\n\n")
    lines = [f"{c}/sun_{i}.jpg" for i, c in enumerate(classes * 2)]
    (root / "Partitions" / "Testing_01.txt").write_text("\n".join(lines))
    for line in lines:
        _image(str(root) + line, rng)


def _aircraft(root, rng):
    variants = ["Boeing 737-200", "A320", "DC-3"]
    (root / "data").mkdir(parents=True)
    (root / "data" / "variants.txt").write_text("\n".join(variants) + "\n")
    lines = [f"{1000 + i} {v}" for i, v in enumerate(variants * 2)]
    (root / "data" / "images_variant_test.txt").write_text(
        "\n".join(lines) + "\n")
    for line in lines:
        _image(str(root / "data" / "images" / f"{line.split()[0]}.jpg"), rng)


def _dtd(root, rng):
    classes = ["striped", "banded", "zigzagged"]
    lines = [f"{c}/{c}_{i:04d}.jpg" for i, c in enumerate(classes * 2)]
    (root / "labels").mkdir(parents=True)
    (root / "labels" / "test1.txt").write_text("\n".join(lines) + "\n")
    for line in lines:
        _image(str(root / "images" / line), rng)


def _pets(root, rng):
    names = ["Abyssinian_100", "great_pyrenees_12", "Bengal_7",
             "american_pit_bull_terrier_3"]
    (root / "annotations").mkdir(parents=True)
    (root / "annotations" / "test.txt").write_text(
        "# header\n" + "\n".join(f"{n} {i + 1} 1 1" for i, n in
                                 enumerate(names)) + "\n")
    for n in names:
        _image(str(root / "images" / f"{n}.jpg"), rng)


def _flowers(root, rng):
    from scipy.io import savemat

    labels = rng.integers(1, 103, 9)
    savemat(root / "imagelabels.mat", {"labels": labels[None]})
    savemat(root / "setid.mat", {"tstid": np.array([[2, 5, 9, 1]])})
    for i in range(1, 10):
        _image(str(root / "jpg" / f"image_{i:05d}.jpg"), rng)


def _cars(root, rng):
    from scipy.io import savemat

    annos = np.zeros((1, 4), dtype=[("class", "O"), ("fname", "O")])
    for i in range(4):
        annos[0, i] = (np.array([[int(rng.integers(1, 197))]]),
                       np.array([f"{i:05d}.jpg"]))
        _image(str(root / "cars_test" / f"{i:05d}.jpg"), rng)
    savemat(root / "cars_test_annos_withlabels.mat", {"annotations": annos})


def _caltech(root, rng):
    base = root / "101_ObjectCategories"
    for c in ("accordion", "BACKGROUND_Google", "Faces", "airplanes"):
        for i in range(2):
            _image(str(base / c / f"image_{i:04d}.jpg"), rng)


LAYOUTS = {
    "cifar10": lambda root, rng: write_cifar10(str(root), 6, seed=4),
    "cifar100": _cifar100, "food101": _food101, "sun397": _sun397,
    "aircraft": _aircraft, "fgvc_aircraft": _aircraft, "dtd": _dtd,
    "pets": _pets, "oxford_pets": _pets, "flowers": _flowers,
    "flowers102": _flowers, "stanford_car": _cars, "caltech101": _caltech,
}


def _same_samples(got, want):
    assert len(got) == len(want) > 0
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gl == wl and isinstance(gl, int)
        if isinstance(ws, np.ndarray):
            np.testing.assert_array_equal(gs, ws)
        else:
            assert gs == ws


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_reader_matches_jax(name, tmp_path):
    LAYOUTS[name](tmp_path, np.random.default_rng(len(name)))
    got = pcls.ClassificationDataset(
        name, str(tmp_path), transform=ptf.EvalTransform(image_size=16))
    want = jcls.ClassificationDataset(
        name, str(tmp_path), transform=jtf.EvalTransform(image_size=16))
    _same_samples(got.samples, want.samples)
    for i in range(len(want)):
        img, label = got[i]
        want_img, want_label = want[i]
        assert label == want_label
        np.testing.assert_array_equal(img, want_img)


def test_reader_names_and_unknown_set():
    assert sorted(pcls._READERS) == sorted(jcls._READERS) == sorted(LAYOUTS)
    with pytest.raises(KeyError, match="unknown classification dataset"):
        pcls.ClassificationDataset("imagenet_sketch", ".")


@pytest.mark.parametrize("numeric,max_per_class", [(False, None),
                                                   (True, None),
                                                   (False, 2)])
def test_image_folder_matches_jax(numeric, max_per_class, tmp_path):
    # 12 classes: numeric order (2 before 10) differs from the names'
    write_image_folder(str(tmp_path), 12, 3, seed=5, numeric=numeric,
                       size_range=(20, 40))
    got = pds.ImageFolderDataset(str(tmp_path),
                                 ptf.EvalTransform(image_size=16),
                                 max_per_class=max_per_class)
    want = jds.ImageFolderDataset(str(tmp_path),
                                  jtf.EvalTransform(image_size=16),
                                  max_per_class=max_per_class)
    assert got.class_to_idx == want.class_to_idx
    if numeric:
        assert got.class_to_idx == {str(i): i for i in range(12)}
    assert got.samples == want.samples
    assert len(got) == 12 * (max_per_class or 3)
    for i in (0, len(got) - 1):
        np.testing.assert_array_equal(got[i][0], want[i][0])
        assert got[i][1] == want[i][1]


def test_get_data_eval_keys_match_jax(tmp_path):
    write_image_folder(str(tmp_path / "val"), 3, 2, seed=6,
                       size_range=(20, 40))
    write_image_folder(str(tmp_path / "v2"), 11, 1, seed=7, numeric=True,
                       size_range=(20, 40))
    cls_dir = tmp_path / "classification"
    write_cifar10(str(cls_dir / "cifar10"), 5, seed=8)
    _aircraft(cls_dir / "fgvc_aircraft", np.random.default_rng(9))
    # a set whose reader fails falls back to class folders
    write_image_folder(str(cls_dir / "dtd"), 2, 2, seed=10,
                       size_range=(20, 40))
    argv = ["--imagenet-val", str(tmp_path / "val"),
            "--imagenet-v2", str(tmp_path / "v2"),
            "--classification-data-dir", str(cls_dir),
            "--zeroshot-eval-datasets", "cifar10, fgvc_aircraft,dtd,pets,",
            "--batch-size", "4"]
    got = pdp.get_data(pparams.parse_args(argv), None, image_size=16)
    want = jdp.get_data(jparams.parse_args(argv), None, image_size=16)
    assert sorted(got) == sorted(want) == [
        "aircraft", "cifar10", "dtd", "imagenet-v2", "imagenet-val"]
    for key in want:
        for (gi, gl), (wi, wl) in zip(got[key], want[key]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
    assert isinstance(got["dtd"].dataset, pds.ImageFolderDataset)
