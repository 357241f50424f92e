"""The port's CSV training data (cosmos_tpu_torch.data.datasets.CsvDataset,
training/data_pipeline.py CsvTrainLoader and get_data's csv branch) against
cosmos_tpu's on the same seeded PNG rows: the batches, bit for bit, over
two epochs at one and two processes, the disjoint per-process slices, the
two errors and the dataset type read from the file extension.  Both sides
decode with PIL."""

import logging
from types import SimpleNamespace

import numpy as np
import pytest

from cosmos_tpu.data import datasets as jds
from cosmos_tpu.data import loader as jloader
from cosmos_tpu.training import data_pipeline as jpipe
from cosmos_tpu_torch.data import datasets as pds
from cosmos_tpu_torch.data import loader as ploader
from cosmos_tpu_torch.data.synthetic import write_csv
from cosmos_tpu_torch.training import data_pipeline as ppipe
from cosmos_tpu_torch.training import params as pparams

ROWS = 20


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    return write_csv(str(tmp_path_factory.mktemp("csv")), ROWS, seed=3,
                     size_range=(40, 72))


def _cfgs(**kw):
    common = dict(dict(urls=[], batch_size=3, num_workers=0, image_size=32,
                       local_crops_number=2, local_size=16,
                       num_sampled_captions=4, context_length=16, seed=7,
                       caption_sampling_mode="textcrop"), **kw)
    return (ploader.WdsTrainConfig(**common, use_native_io=False),
            jloader.WdsTrainConfig(**common, use_native_io=False))


def _loaders(path, **kw):
    pcfg, jcfg = _cfgs(**kw)
    keys = ("filepath", "title", "\t")
    return (ppipe.CsvTrainLoader(pcfg, path, *keys),
            jpipe.CsvTrainLoader(jcfg, path, *keys))


def test_csv_dataset_equals_jax(csv_path):
    p = pds.CsvDataset(csv_path, transform=None)
    j = jds.CsvDataset(csv_path, transform=None)
    assert len(p) == len(j) == ROWS
    assert p.images == j.images and p.captions == j.captions


@pytest.mark.parametrize("process_count", [1, 2])
@pytest.mark.parametrize("multicrop", [True, False])
def test_csv_batches_equal_jax(csv_path, process_count, multicrop):
    """Epochs 0 and 1 on one long-lived iterator, as the trainer drives
    it: each process's batches equal JAX's, images and tokens."""
    for index in range(process_count):
        p, j = _loaders(csv_path, use_multicrop=multicrop,
                        process_index=index, process_count=process_count)
        pit, jit = iter(p), iter(j)
        for epoch in (0, 1):
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            for _ in range(2):
                got, want = next(pit), next(jit)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k])
        assert got["global_images"].shape[:2] == ((2, 3) if multicrop
                                                  else (1, 3))


def test_processes_read_disjoint_rows(csv_path, monkeypatch):
    """One pass: each of 2 processes reads its strided slice of the same
    shuffle, and the two slices share no row."""
    import PIL.Image

    original = PIL.Image.open
    seen = {0: [], 1: []}
    for index in (0, 1):
        p, _ = _loaders(csv_path, process_index=index, process_count=2,
                        batch_size=ROWS // 2, use_multicrop=False)
        monkeypatch.setattr(PIL.Image, "open",
                            lambda path, *a, _o=seen[index], **k:
                            _o.append(path) or original(path, *a, **k))
        next(iter(p))
    assert len(seen[0]) == len(seen[1]) == ROWS // 2
    assert not set(seen[0]) & set(seen[1])
    assert len(set(seen[0]) | set(seen[1])) == ROWS


def test_too_few_rows_for_a_batch_raises(csv_path):
    for loader in (ppipe.CsvTrainLoader, jpipe.CsvTrainLoader):
        cfg = _cfgs(batch_size=ROWS // 2 + 1, process_count=2)[
            loader is jpipe.CsvTrainLoader]
        with pytest.raises(ValueError, match="fewer than one batch"):
            loader(cfg, csv_path, "filepath", "title", "\t")


def test_a_pass_without_readable_images_raises(tmp_path, caplog):
    bad = tmp_path / "bad.csv"
    bad.write_text("filepath\ttitle\n" + "".join(
        f"{tmp_path}/missing-{i}.png\ta caption\n" for i in range(4)))
    for loader in _loaders(str(bad), batch_size=2, use_multicrop=False):
        with caplog.at_level(logging.WARNING):
            with pytest.raises(RuntimeError, match="no readable images"):
                next(iter(loader))
        assert "unreadable image" in caplog.text
        caplog.clear()


@pytest.mark.parametrize("path,want", [("x.csv", "csv"), ("x.tsv", "csv"),
                                       ("s-{0..3}.tar", "webdataset"),
                                       (None, "none")])
def test_dataset_type_from_the_extension(path, want):
    args = SimpleNamespace(dataset_type="auto", train_data=path)
    assert ppipe._detect_dataset_type(args) == want
    assert jpipe._detect_dataset_type(args) == want


def test_get_data_builds_the_csv_loader(csv_path):
    args = pparams.parse_args(["--train-data", csv_path, "--batch-size", "4",
                               "--workers", "0"])
    data = ppipe.get_data(args, None, image_size=32, context_length=16)
    info = data["train"]
    assert isinstance(info.dataloader, ppipe.CsvTrainLoader)
    # every row an epoch: ROWS // batch steps
    assert (info.num_samples, info.num_batches) == (ROWS, ROWS // 4)
