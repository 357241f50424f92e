"""Training an HF text tower in the port against cosmos_tpu, on the CPU:

  - one plain CLIP step on a BERT tower under ``mean_pooler`` against
    JAX's ``make_train_step`` (metrics, student and teacher within 1e-5 in
    float32; the pooler, which the loss does not reach, still decays);
  - ``frozen_mask`` and ``wd_mask`` against JAX's, leaf for leaf through
    the weight bridge, for every ``--lock-text-unlocked-layers`` and
    LayerNorm state; T5 under ``--lock-text`` raises in both;
  - the sharded step's refusals on an HF tower, JAX's (FSDP and tensor
    parallelism take the tower: ``test_torch_tp.py``);
  - the port's trainer on a registered tiny HF config: ``--dataset-type
    synthetic --lock-text``, 2 steps, a checkpoint, ``--resume latest``.
"""

import json

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import (TrainStepConfig, frozen_mask,
                                             wd_mask)


def test_clip_step_equals_jax():
    kw = H.model_kw("bert", text_hf_pooler_type="mean_pooler")
    jm, jp = H.jax_model(kw)
    batch = H.step_batch("bert")
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    cosmos=False)
    mesh = create_mesh(1)
    state, metrics = H.run_jax(
        jax_train.make_train_step(jm, opt, mesh, cfg),
        jax_train.create_train_state(jp, opt, mesh), shard_batch(batch, mesh))
    want = {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": H.to_port(state.params),
            "teacher": H.to_port(state.teacher_params)}

    model = H.port_model(kw, H.to_port(jp))
    popt = create_optimizer(model, scheduler.const_lr(R.LR, 0, 10),
                            beta1=R.BETA1, beta2=0.98, eps=R.EPS,
                            weight_decay=0.5)
    pcfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                           lr_schedule=scheduler.const_lr(R.LR, 0, 10),
                           log_grad_norm=True, cosmos=False)
    pstate = create_train_state(model, popt)
    got = make_train_step(model, popt, pcfg)(pstate, H.as_torch(batch))
    assert set(got) == set(want["metrics"])
    for k, w in want["metrics"].items():
        H.close(float(got[k]), w, k)
    for which, module in (("student", pstate.student),
                          ("teacher", pstate.teacher)):
        sd = module.state_dict()
        assert set(sd) == set(want[which])
        for n, w in want[which].items():
            H.close(sd[n].numpy(), w.numpy(), f"{which} {n}")
    # the pooler takes no gradient under mean pooling and is decayed
    name = "text.transformer.pooler.dense.weight"
    before = H.to_port(jp)[name]
    assert wd_mask(model)[name]
    assert not torch.equal(pstate.student.state_dict()[name], before)


def _per_leaf(mask_tree, params) -> dict:
    """A JAX mask tree as {torch key: bool}, through the bridge."""
    full = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, bool(m)),
                                  mask_tree, params)
    return {k: bool(v.all()) for k, v in H.to_port(full).items()}


@pytest.fixture(scope="module")
def towers():
    """(JAX params, port model) of a 3-layer BERT tower and a T5 tower."""
    out = {}
    for arch in ("bert", "t5"):
        kw = H.model_kw(arch, text_hf_model_config=dict(
            H.HF[arch], **({"num_hidden_layers": 3} if arch == "bert"
                           else {})))
        _, jp = H.jax_model(kw)
        out[arch] = (jp, H.port_model(kw))
    return out


@pytest.mark.parametrize("unlocked", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("freeze_ln", [None, True, False])
def test_lock_text_mask_equals_jax(towers, unlocked, freeze_ln):
    jp, model = towers["bert"]
    kw = dict(lock_text=True, text_unlocked_layers=unlocked,
              text_freeze_layer_norm=freeze_ln)
    want = _per_leaf(jax_train.frozen_mask(jp, **kw), jp)
    got = frozen_mask(model, **kw)
    assert got == want
    assert not any(v for k, v in got.items()
                   if k.startswith(("text.proj", "text.transformer.pooler")))
    # the image lock beside it
    kw = dict(lock_image=True, unlocked_groups=2, **kw)
    assert frozen_mask(model, **kw) == _per_leaf(
        jax_train.frozen_mask(jp, **kw), jp)


@pytest.mark.parametrize("arch", ["bert", "t5"])
def test_decay_mask_equals_jax(towers, arch):
    jp, model = towers[arch]
    assert wd_mask(model) == _per_leaf(jax_train.wd_mask(jp), jp)


def test_t5_lock_text_raises_in_both(towers):
    jp, model = towers["t5"]
    for fn, tree in ((jax_train.frozen_mask, jp), (frozen_mask, model)):
        with pytest.raises(NotImplementedError, match="encoder.layer"):
            fn(tree, lock_text=True)
    # the image lock alone takes a T5 tower
    assert not any(v for k, v in frozen_mask(model, lock_image=True).items()
                   if k.startswith("text."))


@pytest.mark.parametrize("mode", ["fsdp", "tp"])
def test_sharded_modes_are_refused(mode):
    """FSDP and TP place an HF tower (``test_torch_tp.py`` runs them); the
    sharded step refuses on it only what JAX's GSPMD step refuses, with
    its message."""
    import types

    from cosmos_tpu_torch.parallel.fsdp import fsdp_placements
    from cosmos_tpu_torch.parallel.tp import tp_param_placements
    from cosmos_tpu_torch.training import train as T

    model = create_model("ViT-B-16", device="cpu", **H.model_kw("bert"))
    placed = (fsdp_placements(model, 2) if mode == "fsdp"
              else tp_param_placements(model))
    assert set(placed) == {n for n, _ in model.named_parameters()}
    mesh = types.SimpleNamespace(mesh_dim_names=(
        ("data",) if mode == "fsdp" else ("data", "model")))
    kw = dict(siglip=True, cosmos=False)
    with pytest.raises(ValueError) as want:
        jax_train.make_train_step_gspmd(None, None, None,
                                        jax_train.TrainStepConfig(**kw))
    with pytest.raises(ValueError) as got:
        T.make_train_step_gspmd(model, None, mesh, T.TrainStepConfig(**kw))
    assert str(got.value) == str(want.value)


def test_trainer_locks_checkpoints_and_resumes(tmp_path, monkeypatch):
    """A registered BERT-tower config through the trainer: --lock-text
    with one unlocked layer keeps the embeddings and layer 0 at their
    bits, the checkpoint loads back, and --resume latest continues."""
    from cosmos_tpu_torch.models import config as pconfig
    from cosmos_tpu_torch.models.checkpoint import load_checkpoint
    from cosmos_tpu_torch.training import main as pmain

    name = "hf-bert-tiny-test"
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({
        "embed_dim": 32,
        "vision_cfg": {"image_size": 16, "patch_size": 8, "width": 32,
                       "layers": 1, "head_width": 16},
        "text_cfg": {"context_length": 16, "hf_model_pretrained": False,
                     "hf_model_config": dict(H.HF["bert"],
                                             vocab_size=49408)}}))
    monkeypatch.setattr(pconfig, "_EXTRA_CONFIGS",
                        dict(pconfig._EXTRA_CONFIGS))
    pconfig.add_model_config(str(path))
    argv = ["--model", name, "--dataset-type", "synthetic",
            "--train-num-samples", "8", "--batch-size", "4",
            "--precision", "fp32", "--workers", "1", "--lr", "1e-3",
            "--warmup", "1", "--seed", "3", "--log-every-n-steps", "1",
            "--lock-text", "--lock-text-unlocked-layers", "1",
            "--save-most-recent", "--logs-dir", str(tmp_path),
            "--name", "hf"]
    first = pmain.main(argv + ["--epochs", "1"], device="cpu")
    assert len(first["train_epoch_stats"][0]["logged"]) == 2
    init = create_model(name, device="cpu", seed=3).state_dict()
    ckpt = tmp_path / "hf" / "checkpoints" / "epoch_1.pt"
    model = load_checkpoint(create_model(name, device="cpu"), str(ckpt),
                            strict=True)
    sd = model.state_dict()
    frozen = frozen_mask(model, lock_text=True, text_unlocked_layers=1)
    assert any(frozen.values()) and not all(frozen.values())
    for key, is_frozen in frozen.items():
        assert torch.equal(sd[key], init[key]) == is_frozen, key
    resumed = pmain.main(argv + ["--epochs", "2", "--resume", "latest"],
                         device="cpu")
    assert [s["epoch"] for s in resumed["train_epoch_stats"]] == [1]
    assert torch.load(tmp_path / "hf" / "checkpoints" / "epoch_2.pt",
                      weights_only=True)["step"] == 4
