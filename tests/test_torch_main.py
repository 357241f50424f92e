"""The port's trainer entry point (cosmos_tpu_torch.training.main) on the
CPU, against cosmos_tpu.training.main: the flag surface, the refusal of
every unported flag, checkpoints the JAX package reads, a resumed run
that is bitwise equal to an uninterrupted one, and one parity run of the
two trainers from the same weights and shards (float32, 2 steps; train and
val loss within rtol 1e-4).  Also the attention routing at a head count
with no head group.

All at ViT-Tiny-Test (head dim 16: both sides take their plain attention
paths) on PNG shards, so both sides decode with PIL.  JAX runs on the 8
virtual CPU devices of tests/conftest.py, its --batch-size is per device:
the port, on one device, gets 8 times it, so that both loaders batch the
same samples.
"""

import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
from cosmos_tpu.models import checkpoint as jckpt
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.ops import fused_attention as jfa
from cosmos_tpu.training import params as jparams
from cosmos_tpu_torch.data.synthetic import write_coco, write_shards
from cosmos_tpu_torch.models import attention as pattn
from cosmos_tpu_torch.ops import fused_attention as pfa
from cosmos_tpu_torch.training import main as pmain
from cosmos_tpu_torch.training import params as pparams

COSMOS_FLAGS = ["--cosmos", "--output-all", "--attentional-pool",
                "--add-zero-attn"]
RECIPE = ["--model", "ViT-Tiny-Test", "--dataset-type", "webdataset",
          "--use-imagecrop-aug", "--local-crops-number", "2",
          "--caption-sampling-mode", "textcrop", "--num-sampled-captions", "3",
          *COSMOS_FLAGS, "--fix-momentum", "--precision", "fp32",
          "--log-every-n-steps", "1", "--workers", "1", "--lr", "1e-3",
          "--warmup", "1", "--seed", "3"]


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    # the tiny model's matmuls gain nothing from many threads, and the
    # test processes share the machine's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _capture_parser(module):
    """(the parser parse_args builds, the namespace of no flags)."""
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, *a, **kw):
        seen["parser"] = self
        return orig(self, *a, **kw)

    argparse.ArgumentParser.parse_args = grab
    try:
        ns = module.parse_args([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"], ns


def test_flag_surface_equals_jax():
    pp, pns = _capture_parser(pparams)
    jp, jns = _capture_parser(jparams)
    assert vars(pns) == vars(jns)
    flags = lambda p: {(s, a.dest, repr(a.default), str(a.choices), a.nargs)
                       for a in p._actions for s in a.option_strings}
    assert flags(pp) == flags(jp)
    assert len(vars(pns)) >= 120


UNPORTED_ARGV = {
    "huggingface": ["--huggingface-model-name", "m"],
    # a pretrained tag for the distillation model that is not cached needs
    # a download
    "distill-tag": ["--distill-model", "ViT-B-32", "--distill-pretrained",
                    "cosmos_cc3m"],
}


@pytest.mark.parametrize("name", sorted(UNPORTED_ARGV))
def test_unported_flag_raises(name, tmp_path, monkeypatch):
    monkeypatch.setenv("COSMOS_TPU_CACHE", str(tmp_path / "no_cache"))
    argv = UNPORTED_ARGV[name] + ["--logs-dir", str(tmp_path)]
    # each refusal names its ROADMAP item by title
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, ") as e:
        pmain.main(argv, device="cpu")
    assert pmain.NEEDS_DOWNLOAD in str(e.value), e.value
    assert not os.listdir(tmp_path)   # refused before anything ran


def test_every_unported_entry_is_exercised():
    args = {name: pparams.parse_args(argv)
            for name, argv in UNPORTED_ARGV.items()}
    for flag, is_set, _ in pmain.UNPORTED:
        assert any(is_set(a) for a in args.values()), flag
        assert not is_set(pparams.parse_args([])), flag


def _coca_argv(shards, logs, name, model, *extra):
    """A CoCa run of 2 steps of 4 rows, no evals."""
    return ["--model", model, "--dataset-type", "webdataset",
            "--precision", "fp32", "--log-every-n-steps", "1",
            "--workers", "0", "--lr", "1e-3", "--warmup", "1", "--seed", "3",
            "--train-data", str(shards / "train-{0000..0001}.tar"),
            "--batch-size", "4", "--train-num-samples", "8", "--epochs", "1",
            "--logs-dir", str(logs), "--name", name, *extra]


def test_coca_is_told_by_its_config_not_its_name(shards, tmp_path,
                                                 monkeypatch):
    """A CoCa config registered under a name without "coca" is CoCa to
    the trainer and to the step: under --fsdp the trainer runs its CoCa
    step (the caption loss among the logged metrics)."""
    from cosmos_tpu_torch import create_model
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.models.coca import CoCa
    from cosmos_tpu_torch.training.train import (TrainStepConfig,
                                                 make_train_step)

    monkeypatch.setitem(pconfig._EXTRA_CONFIGS, "Captioner-Tiny",
                        R.coca_trainer_config()[1])
    assert pconfig.is_coca_config("Captioner-Tiny")
    assert not pconfig.is_coca_config("ViT-Tiny-Test")
    model = create_model("Captioner-Tiny", device="cpu")
    assert isinstance(model, CoCa) and pconfig.is_coca(model)
    with pytest.raises(ValueError, match="CoCa step"):
        make_train_step(model, None, TrainStepConfig(cosmos=False))
    out = pmain.main(_coca_argv(shards, tmp_path, "captioner",
                                "Captioner-Tiny", "--fsdp",
                                "--train-num-samples", "4"), device="cpu")
    (line,) = out["train_epoch_stats"][0]["logged"]
    assert line["loss"] == pytest.approx(
        line["contrastive_loss"] + line["caption_loss"], rel=1e-6)
    with pytest.raises(SystemExit):
        pparams.parse_args(["--model", "Captioner-Tiny", "--cosmos"])


def test_coca_trains_under_fsdp_on_one_rank(shards, tmp_path, monkeypatch):
    """--model coca_Tiny-Test --fsdp without a world: a process group of
    the one process, 2 steps of the CoCa step under FSDP, and a gathered
    checkpoint that is whole and loads into the unsharded CoCa."""
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.models.checkpoint import load_checkpoint
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.parallel import distributed

    name, cfg = R.coca_trainer_config()
    monkeypatch.setitem(pconfig._EXTRA_CONFIGS, name, cfg)
    out = pmain.main(_coca_argv(shards, tmp_path, "coca_fsdp", name,
                                "--fsdp"), device="cpu")
    logged = out["train_epoch_stats"][0]["logged"]
    assert len(logged) == 2
    for line in logged:
        assert np.isfinite(line["loss"])
        assert line["loss"] == pytest.approx(
            line["contrastive_loss"] + line["caption_loss"], rel=1e-6)
    # the process group of the one process is gone with the run
    assert not distributed.is_initialized()
    path = tmp_path / "coca_fsdp" / "checkpoints" / "epoch_1.pt"
    ckpt = _load(path)
    whole = create_model(name, device="cpu").state_dict()
    for which in ("student", "teacher"):
        assert {k: v.shape for k, v in ckpt[which].items()} == {
            k: v.shape for k, v in whole.items()}
    model = load_checkpoint(create_model(name, device="cpu"), str(path),
                            strict=True)
    _assert_same_bits(model.state_dict(), ckpt["student"])
    assert ckpt["num_updates"] == 2


def test_pretrained_tag_and_missing_cuda_raise(tmp_path, monkeypatch):
    # a registry tag whose file is not in the cache needs a download
    monkeypatch.setenv("COSMOS_TPU_CACHE", str(tmp_path / "no_cache"))
    with pytest.raises(NotImplementedError, match="download"):
        pmain.main(["--pretrained", "cosmos_cc3m", "--logs-dir",
                    str(tmp_path), "--model", "ViT-B-16"], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmain.main(["--logs-dir", str(tmp_path)])


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    write_shards(str(d / "train-{i:04d}.tar"), 2, 8, seed=0, fmt="png",
                 size_range=(36, 72))
    write_shards(str(d / "val-{i:04d}.tar"), 1, 4, seed=1, fmt="png",
                 size_range=(36, 72))
    write_coco(str(d / "root" / "coco"), 6, seed=2, fmt="png",
               size_range=(36, 72))
    return d


def _train_argv(shards, logs, name, *extra):
    return RECIPE + [
        "--train-data", str(shards / "train-{0000..0001}.tar"),
        "--logs-dir", str(logs), "--name", name, *extra]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def _assert_same_bits(a, b, where=""):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _assert_same_bits(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_bits(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.fixture(scope="module")
def resumed_runs(shards, tmp_path_factory):
    """An uninterrupted 2-epoch run, and a 1-epoch run resumed for a
    second: 4 steps an epoch over both shards (one full pass), one loader
    worker.  The cosine LR and momentum schedules span --epochs, which
    differs between the runs; so the LR is constant after a warm-up of 6
    updates (which the resumed run must continue at update 4) and the
    momentum is fixed."""
    logs = tmp_path_factory.mktemp("logs")
    common = ["--batch-size", "4", "--train-num-samples", "16",
              "--save-most-recent", "--lr-scheduler", "const",
              "--warmup", "6"]
    m_full = pmain.main(_train_argv(shards, logs, "full", *common,
                                    "--epochs", "2"), device="cpu")
    pmain.main(_train_argv(shards, logs, "split", *common, "--epochs", "1"),
               device="cpu")
    m_resumed = pmain.main(_train_argv(shards, logs, "split", *common,
                                       "--epochs", "2", "--resume", "latest"),
                           device="cpu")
    return logs, m_full, m_resumed


def test_resume_is_bitwise_equal_to_an_uninterrupted_run(resumed_runs):
    logs, m_full, m_resumed = resumed_runs
    full = _load(logs / "full" / "checkpoints" / "epoch_2.pt")
    resumed = _load(logs / "split" / "checkpoints" / "epoch_2.pt")
    latest = _load(logs / "split" / "checkpoints" / "epoch_latest.pt")
    for key in ("epoch", "student", "teacher", "optimizer", "step",
                "num_updates"):
        _assert_same_bits(full[key], resumed[key], key)
        _assert_same_bits(latest[key], resumed[key], key)
    assert (resumed["epoch"], resumed["step"], resumed["num_updates"]) == (
        2, 8, 8)
    # the resumed run logged only epoch 1, starting at update 4 of the
    # warm-up
    stats = m_resumed["train_epoch_stats"]
    assert [s["epoch"] for s in stats] == [1]
    lr = stats[0]["logged"][0]["lr"]
    assert lr == pytest.approx(1e-3 * 5 / 6, rel=1e-12)
    assert m_full["train_loss"] == m_resumed["train_loss"]


def test_jax_reads_the_port_checkpoint(resumed_runs):
    logs, _, _ = resumed_runs
    path = str(logs / "full" / "checkpoints" / "epoch_1.pt")
    ckpt = _load(path)
    jm, jp = jax_create_model("ViT-Tiny-Test", precision="fp32", cosmos=True,
                              output_all=True, attentional_pool=True,
                              add_zero_attn=True, seed=11)
    for which in ("student", "teacher"):
        params = jckpt.load_checkpoint(jm, jp, path, which=which)
        back = jckpt.params_to_torch_state_dict(
            jax.tree_util.tree_map(np.asarray, params))
        assert set(back) == set(ckpt[which])
        for k, v in back.items():
            np.testing.assert_array_equal(np.asarray(v),
                                          ckpt[which][k].numpy(), err_msg=k)
    assert not all(torch.equal(ckpt["student"][k], ckpt["teacher"][k])
                   for k in ckpt["student"])


def test_eval_only_retrieval_loads_student_and_teacher(resumed_runs,
                                                      shards, tmp_path):
    from cosmos_tpu_torch.data.datasets import RetrievalData
    from cosmos_tpu_torch.data.tokenizer import SimpleTokenizer
    from cosmos_tpu_torch.models.factory import create_model
    from cosmos_tpu_torch.training.evaluate import evaluate_model

    logs, _, _ = resumed_runs
    path = str(logs / "full" / "checkpoints" / "epoch_1.pt")
    got = pmain.main(["--model", "ViT-Tiny-Test", *COSMOS_FLAGS,
                      "--eval-mode", "retrieval", "--pretrained", path,
                      "--data-root-dir", str(shards / "root"),
                      "--logs-dir", str(tmp_path), "--name", "eval"],
                     device="cpu")
    data = {"coco-retrieval": RetrievalData.load(
        "coco", str(shards / "root" / "coco"), SimpleTokenizer())}
    ckpt = _load(path)
    for prefix, which in (("", "student"), ("ema_", "teacher")):
        model = create_model("ViT-Tiny-Test", "amp", device="cpu",
                             cosmos=True, output_all=True,
                             attentional_pool=True, add_zero_attn=True)
        model.load_state_dict(ckpt[which])
        want = evaluate_model(model, data, prefix=prefix, batch_size=64,
                              image_size=32)
        assert len(want) == 10
        assert {k: got[k] for k in want} == want


def test_skip_scheduler_and_grad_clip(shards, tmp_path):
    m = pmain.main(_train_argv(shards, tmp_path, "clip", "--batch-size", "4",
                               "--train-num-samples", "8", "--epochs", "1",
                               "--skip-scheduler", "--grad-clip-norm", "0.5",
                               "--prefetch-depth", "0"), device="cpu")
    logged = m["train_epoch_stats"][0]["logged"]
    assert [line["lr"] for line in logged] == [1e-3, 1e-3]
    assert all(np.isfinite(line["grad_norm"]) for line in logged)


def test_parity_with_the_jax_trainer(shards, tmp_path):
    from cosmos_tpu.training.main import main as jax_main

    _, jp = jax_create_model("ViT-Tiny-Test", precision="fp32", cosmos=True,
                             output_all=True, attentional_pool=True,
                             add_zero_attn=True, seed=5)
    sd = jckpt.params_to_torch_state_dict(
        jax.tree_util.tree_map(np.asarray, jp))
    init = str(tmp_path / "init.pt")
    torch.save({k: torch.tensor(np.asarray(v)) for k, v in sd.items()}, init)
    ndev = jax.local_device_count()
    per_device = 2
    common = ["--train-num-samples", str(2 * ndev * per_device),
              "--epochs", "1", "--pretrained", init,
              "--val-data", str(shards / "val-0000.tar"),
              # one val batch on both sides: the in-batch loss depends on
              # the batch, and JAX's val batch is per device
              "--val-num-samples", str(per_device), "--no-eval-teacher"]
    want = jax_main(_train_argv(shards, tmp_path, "jax", *common,
                                "--batch-size", str(per_device)))
    got = pmain.main(_train_argv(shards, tmp_path, "port", *common,
                                 "--batch-size", str(per_device * ndev)),
                     device="cpu")
    assert len(got["train_epoch_stats"][0]["logged"]) == 2
    for key in ("train_loss", "train_clip_loss", "train_distill_loss",
                "clip_val_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    assert got["num_samples"] == want["num_samples"] == per_device


@pytest.mark.parametrize("heads,dh", [(3, 64), (5, 64), (2, 64), (3, 128)])
def test_head_group_routing_equals_jax(heads, dh):
    # JAX sends a head count with no head group (odd at Dh 64) to its XLA
    # path; the port's gate now agrees, so such a layer takes the stock path
    d = heads * dh
    assert pfa.supported(heads, d) == jfa.supported(heads, d)
    assert pfa.supported(heads, d) == (not (heads % 2 and dh == 64))
    from cosmos_tpu.models.attention import MultiheadAttention as JaxMHA

    rng = np.random.default_rng(heads)
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    jmod = JaxMHA(num_heads=heads, dtype=jnp.float32, use_flash=True)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), causal=True)
    want = jmod.apply(params, jnp.asarray(x), causal=True)
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    mod = pattn.MultiheadAttention(d, heads)
    mod.load_state_dict({
        "in_proj_weight": torch.from_numpy(p["in_proj_kernel"].T.copy()),
        "in_proj_bias": torch.from_numpy(p["in_proj_bias"].copy()),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"].copy())})
    calls = []
    orig = pattn.fused_attention_qkv
    pattn.fused_attention_qkv = lambda *a: calls.append(a) or orig(*a)
    try:
        with torch.no_grad():
            got = mod(torch.from_numpy(x), causal=True)
    finally:
        pattn.fused_attention_qkv = orig
    assert bool(calls) == pfa.supported(heads, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_coca_trainer_trains_evaluates_and_resumes(shards, tmp_path,
                                                   monkeypatch):
    """coca_Tiny-Test with the tokenizer's vocabulary (its own 512 ids
    cannot hold the BPE tokens of the shards' captions) and
    --coca-caption-loss-weight 1.0: the CoCa step (its two losses,
    summed), the val and COCO retrieval evals of student and teacher
    (CoCa's encoders return bare features), a checkpoint that
    models/checkpoint.py loads back into CoCa, and --resume latest into a
    second epoch."""
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.models.checkpoint import load_checkpoint
    from cosmos_tpu_torch.models.factory import create_model

    name = "coca_Tiny-Test-49408"
    cfg = pconfig.get_model_config("coca_Tiny-Test")
    cfg["text_cfg"] = dict(cfg["text_cfg"], vocab_size=49408)
    monkeypatch.setitem(pconfig._EXTRA_CONFIGS, name, cfg)
    argv = ["--model", name, "--dataset-type", "webdataset",
            "--precision", "fp32", "--log-every-n-steps", "1",
            "--workers", "1", "--lr", "1e-3", "--warmup", "1", "--seed", "3",
            "--coca-caption-loss-weight", "1.0",
            "--train-data", str(shards / "train-{0000..0001}.tar"),
            "--batch-size", "4", "--train-num-samples", "8",
            "--val-data", str(shards / "val-0000.tar"),
            "--val-num-samples", "4", "--data-root-dir", str(shards / "root"),
            "--save-most-recent", "--logs-dir", str(tmp_path),
            "--name", "coca"]
    first = pmain.main(argv + ["--epochs", "1"], device="cpu")
    logged = first["train_epoch_stats"][0]["logged"]
    assert len(logged) == 2
    for line in logged:
        assert line["loss"] == pytest.approx(
            line["contrastive_loss"] + line["caption_loss"], rel=1e-6)
        # a caption CE near ln(49408) at weight 1 (the default 2 doubles
        # it)
        assert 8.0 < line["caption_loss"] < 14.0
    for prefix in ("", "ema_"):
        assert 0.0 <= first[f"{prefix}coco_image_to_text_R@1"] <= 1.0
        assert np.isfinite(first[f"{prefix}clip_val_loss"])
    path = tmp_path / "coca" / "checkpoints" / "epoch_1.pt"
    ckpt = _load(path)
    model = load_checkpoint(create_model(name, device="cpu"),
                            str(path), strict=True)
    _assert_same_bits(model.state_dict(), ckpt["student"])
    resumed = pmain.main(argv + ["--epochs", "2", "--resume", "latest"],
                         device="cpu")
    assert [s["epoch"] for s in resumed["train_epoch_stats"]] == [1]
    assert _load(tmp_path / "coca" / "checkpoints" / "epoch_2.pt")[
        "step"] == 4
