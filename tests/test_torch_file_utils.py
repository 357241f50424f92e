"""The port's remote checkpoint sync (cosmos_tpu_torch.training.file_utils)
against cosmos_tpu's, with no network: fsspec's local ``file`` protocol and
``aws`` replaced by a stub on ``PATH``.  Then one trainer run on the CPU
with the flags this sync, the step profiler and the encoder export hang
on: ``--remote-sync``, ``--profile-steps 1`` and ``--trace``."""

import json
import os
import stat
import sys
from pathlib import Path

import pytest
import torch

from cosmos_tpu.training import file_utils as jfu
from cosmos_tpu_torch.data.synthetic import write_csv
from cosmos_tpu_torch.training import file_utils as pfu
from cosmos_tpu_torch.training import main as pmain


def _tree(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("fu", [pfu, jfu], ids=["port", "jax"])
def test_fsspec_sync_copies_by_size_and_skips_latest(fu, tmp_path):
    """Both packages' sync; the port's also leaves out a checkpoint in
    writing (``*.tmp``), which JAX's copies."""
    src, dst = tmp_path / "src", tmp_path / "dst"
    (src / "sub").mkdir(parents=True)
    (src / "epoch_1.pt").write_bytes(b"abc")
    (src / "sub" / "epoch_2.pt").write_bytes(b"defg")
    (src / "epoch_latest.pt").write_bytes(b"skip me")
    (src / "epoch_3.pt.tmp").write_bytes(b"half")
    assert fu.remote_sync(str(src), str(dst), protocol="fsspec")
    tmp = {} if fu is pfu else {"epoch_3.pt.tmp": b"half"}
    (src / "epoch_3.pt.tmp").unlink()
    assert _tree(dst) == {"epoch_1.pt": b"abc", "sub/epoch_2.pt": b"defg",
                          **tmp}
    # same size: not copied again (sizes come from the remote's metadata);
    # another size: copied
    (src / "epoch_1.pt").write_bytes(b"xyz")
    (src / "sub" / "epoch_2.pt").write_bytes(b"hijkl")
    assert fu.remote_sync(str(src), str(dst), protocol="fsspec")
    assert _tree(dst) == {"epoch_1.pt": b"abc", "sub/epoch_2.pt": b"hijkl",
                          **tmp}


def test_fsspec_sync_reports_a_failure(tmp_path):
    # a remote path that is a file cannot take a directory's contents
    (tmp_path / "src").mkdir()
    (tmp_path / "src" / "epoch_1.pt").write_bytes(b"a")
    (tmp_path / "remote").write_bytes(b"a file")
    assert not pfu.remote_sync(str(tmp_path / "src"),
                               str(tmp_path / "remote"), protocol="fsspec")


@pytest.mark.parametrize("rc", [0, 3])
def test_s3_sync_runs_aws_s3_sync(rc, tmp_path, monkeypatch):
    """``aws s3 sync <local> <remote> --exclude *epoch_latest*`` (and, in
    the port, ``--exclude *.tmp``) through a stub ``aws`` on PATH that
    records its arguments; its exit code is the result, as in JAX."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    log = tmp_path / "calls.jsonl"
    stub = bin_dir / "aws"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import json, sys\n"
        f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n"
        f"sys.exit({rc})\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    results = [fu.remote_sync("ckpts", "s3://bucket/run", protocol="s3")
               for fu in (pfu, jfu)]
    assert results == [rc == 0] * 2
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    jax_call = ["s3", "sync", "ckpts", "s3://bucket/run", "--exclude",
                "*epoch_latest*"]
    assert calls == [jax_call + ["--exclude", "*.tmp"], jax_call]


def test_sync_process_and_remote_open(tmp_path):
    p = pfu.start_sync_process(5, "a", "b", "fsspec")
    assert p.daemon and not p.is_alive()
    assert p._args == (5, "a", "b", "fsspec")
    (tmp_path / "f.txt").write_text("hello")
    with pfu.remote_open(str(tmp_path / "f.txt"), "r") as f:
        assert f.read() == "hello"


def test_file_utils_imports_no_torch():
    import subprocess

    code = ("import sys\n"
            "import cosmos_tpu_torch.training.file_utils\n"
            "assert 'torch' not in sys.modules and 'fsspec' not in "
            "sys.modules\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_trainer_syncs_profiles_and_traces(tmp_path):
    """Two epochs of two steps on a CSV: the synced checkpoints equal the
    written ones byte for byte (no epoch_latest), the first step's Chrome
    trace is written, and the exported encoders give the trained-from
    initial model's features."""
    csv_path = write_csv(str(tmp_path / "data"), 16, sep=",")
    argv = ["--train-data", csv_path, "--csv-separator", ",",
            "--model", "ViT-Tiny-Test", "--precision", "fp32",
            "--batch-size", "4", "--epochs", "2", "--steps-per-epoch", "2",
            "--workers", "0", "--logs-dir", str(tmp_path / "logs"),
            "--name", "run", "--lr", "1e-4", "--warmup", "1",
            "--remote-sync", str(tmp_path / "remote"),
            "--remote-sync-protocol", "fsspec",
            "--remote-sync-frequency", "1", "--save-most-recent",
            "--profile-steps", "1", "--trace", "--val-frequency", "0"]
    metrics = pmain.main(argv, device="cpu")
    run = tmp_path / "logs" / "run"
    ckpts = _tree(run / "checkpoints")
    assert sorted(ckpts) == ["epoch_1.pt", "epoch_2.pt", "epoch_latest.pt"]
    del ckpts["epoch_latest.pt"]
    assert _tree(tmp_path / "remote") == ckpts
    trace = json.loads((run / "profile" / "rank0.trace.json").read_text())
    assert trace["traceEvents"]
    losses = [line["loss"] for s in metrics["train_epoch_stats"]
              for line in s["logged"]]
    assert len(losses) == 4 and all(map(torch.isfinite, map(torch.tensor,
                                                            losses)))

    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.models.trace import load_traced

    encoders = load_traced(str(run / "traced"))
    assert sorted(encoders) == ["encode_image", "encode_text"]
    model = create_model("ViT-Tiny-Test", device="cpu")   # seed 0, as run
    images = torch.rand(4, 32, 32, 3)
    tokens = torch.randint(1, 49000, (4, 16))
    with torch.no_grad():
        want = model.encode_image(images, True)["image_features"]
        torch.testing.assert_close(encoders["encode_image"](images), want,
                                   atol=1e-6, rtol=0)
        want = model.encode_text(tokens, True)["text_features"]
        torch.testing.assert_close(encoders["encode_text"](tokens), want,
                                   atol=1e-6, rtol=0)
