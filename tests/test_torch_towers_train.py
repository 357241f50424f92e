"""One plain-CLIP training step of the port on each tower family (the
timm ViT with the MCi stem, EVA02, ConvNeXt, FastViT/MCi, ModifiedResNet)
against cosmos_tpu's make_train_step from the same weights and uint8
batch: the loss, every gradient and the updated student and teacher; the
trunks' remat against none.  Then
the trainer entry point (cosmos_tpu_torch.training.main) on a tiny EVA02
config: a plain-CLIP epoch with val and COCO retrieval evals and a
checkpoint, and a resumed second epoch.

The towers are test_torch_towers.py's tiny geometries.  The port's text
tower (head dim 64) and MCi-ViT trunk take the kernel route, K1 forward and
K2 backward, whose wrappers run their plain versions on the CPU; JAX runs
its XLA attention.
"""

import jax
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.data.synthetic import write_coco, write_shards
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.ops import fused_attention as pfa
from cosmos_tpu_torch.training import main as pmain
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig
from test_torch_towers import (RN_CONFIG, _image_size, _overrides,
                               register_config)

B, LR, BETA1, EPS = 4, 1e-3, 0.9, 1e-3
STEP_TOWERS = ["vit_mci", "eva", "convnext", "fastvit", "resnet"]
EVA_CONFIG = "EVA02-Tiny-PortTest"


@pytest.fixture(scope="module", autouse=True)
def _configs(tmp_path_factory):
    d = tmp_path_factory.mktemp("configs")
    register_config(d, RN_CONFIG, {"image_size": 64, "layers": [1, 1, 1, 1],
                                   "width": 8})
    register_config(d, EVA_CONFIG, {"timm_model_name": "eva02_porttest",
                                    "timm_pool": "token",
                                    "timm_proj": "linear",
                                    "image_size": 32},
                    vocab_size=49408)   # the tokenizer's ids


def _batch(size, seed):
    rng = np.random.default_rng(seed)
    return {"global_images": rng.integers(0, 256, (2, B, size, size, 3),
                                          np.uint8),
            "texts": rng.integers(1, 255, (2, B, 16)).astype(np.int32)}


def _adam_mu(state):
    if hasattr(state, "mu"):
        return state.mu
    if isinstance(state, (tuple, list)):
        for s in state:
            mu = _adam_mu(s)
            if mu is not None:
                return mu
    return None


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


@pytest.mark.parametrize("kind", STEP_TOWERS)
def test_plain_clip_step_matches_jax(kind, monkeypatch):
    name, ov = _overrides(kind)
    jm, jp = H.jax_create_fast(name, use_flash=False, seed=2, **ov)
    init = _sd(jp)
    batch = _batch(_image_size(kind), 5)

    lr = jax_sched.const_lr(LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=BETA1, beta2=0.98, eps=EPS,
                                     weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(cosmos=False, momentum_teacher=0.9,
                                    fix_momentum=True, lr_schedule=lr)
    mesh = create_mesh(1)
    step = jax_train.make_train_step(jm, opt, mesh, cfg)
    state = jax_train.create_train_state(jp, opt, mesh)
    state, metrics = H.run_jax(step, state,
                               shard_batch(batch, mesh, batch_axis=1))
    want = {k: float(v) for k, v in metrics.items()}
    want_g = _sd(jax.tree_util.tree_map(lambda m: np.asarray(m) / (1 - BETA1),
                                        _adam_mu(state.opt_state)))
    want_s, want_t = _sd(state.params), _sd(state.teacher_params)

    calls = []
    orig = pfa.fused_attention_qkv

    def counted(*a, **kw):
        calls.append(a[0].requires_grad)
        return orig(*a, **kw)

    monkeypatch.setattr("cosmos_tpu_torch.models.attention."
                        "fused_attention_qkv", counted)
    tm = create_model(name, device="cpu", **ov)
    tm.load_state_dict(init, strict=True)
    plr = scheduler.const_lr(LR, 0, 10)
    popt = create_optimizer(tm, plr, beta1=BETA1, beta2=0.98, eps=EPS,
                            weight_decay=0.5)
    pstate = create_train_state(tm, popt)
    pstep = make_train_step(tm, popt, TrainStepConfig(
        cosmos=False, momentum_teacher=0.9, fix_momentum=True,
        lr_schedule=plr))
    got = pstep(pstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    # the text tower's block (and the MCi trunk's) on K1's route, with a
    # gradient, so K2's runs in the backward
    assert calls == [True] * (2 if kind == "vit_mci" else 1)

    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), want[k], rtol=1e-4,
                                   err_msg=k)
    grads = {n: p.grad for n, p in tm.named_parameters()}
    assert set(grads) == set(want_g)
    for n, w in want_g.items():
        w = w.numpy()
        # a bias gradient sums ~70 token gradients of magnitude ~0.5: float32
        # sums in another order leave a few 1e-6 absolute on an element that
        # cancels to ~1e-2 (EVA02's patch bias: 1.9e-6)
        np.testing.assert_allclose(grads[n].numpy(), w, rtol=1e-4,
                                   atol=5e-6 * max(1.0, np.abs(w).max()),
                                   err_msg=n)
    for module, want_p in ((pstate.student, want_s),
                           (pstate.teacher, want_t)):
        got_p = module.state_dict()
        assert set(got_p) == set(want_p)
        for n, w in want_p.items():
            np.testing.assert_allclose(got_p[n].numpy(), w.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=n)


def test_trainer_trains_evaluates_and_resumes_a_tower(tmp_path):
    """main([...]) on the tiny EVA02 config, plain CLIP on the CPU: one
    epoch with val loss, COCO retrieval and a checkpoint, then --resume
    latest for a second; the checkpoint loads back into the model."""
    write_shards(str(tmp_path / "train-{i:04d}.tar"), 2, 8, seed=0,
                 fmt="png", size_range=(36, 72))
    write_shards(str(tmp_path / "val-{i:04d}.tar"), 1, 4, seed=1, fmt="png",
                 size_range=(36, 72))
    write_coco(str(tmp_path / "root" / "coco"), 6, seed=2, fmt="png",
               size_range=(36, 72))

    def run(*extra):
        return pmain.main([
            "--model", EVA_CONFIG, "--dataset-type", "webdataset",
            "--train-data", str(tmp_path / "train-{0000..0001}.tar"),
            "--train-num-samples", "16", "--batch-size", "4",
            "--val-data", str(tmp_path / "val-0000.tar"),
            "--val-num-samples", "4",
            "--data-root-dir", str(tmp_path / "root"),
            "--use-imagecrop-aug", "--local-crops-number", "0",
            "--caption-sampling-mode", "textcrop",
            "--num-sampled-captions", "2", "--precision", "fp32",
            "--workers", "1", "--lr", "1e-3", "--warmup", "1",
            "--log-every-n-steps", "1", "--save-most-recent",
            "--logs-dir", str(tmp_path / "logs"), "--name", "eva", *extra],
            device="cpu")

    first = run("--epochs", "1")
    second = run("--epochs", "2", "--resume", "latest")
    for m in (first, second):
        assert np.isfinite(m["train_loss"])
        assert np.isfinite(m["clip_val_loss"])
    assert [s["epoch"] for s in second["train_epoch_stats"]] == [1]
    assert any(k.startswith("coco") for k in first)
    ckpt = torch.load(tmp_path / "logs" / "eva" / "checkpoints" /
                      "epoch_2.pt", map_location="cpu", weights_only=True)
    assert ckpt["epoch"] == 2
    model = create_model(EVA_CONFIG, device="cpu")
    model.load_state_dict(ckpt["student"], strict=True)
    assert "visual.trunk.blocks.0.attn.q_proj.weight" in ckpt["student"]


@pytest.mark.parametrize("kind", ["vit_mci", "eva", "convnext", "fastvit"])
def test_tower_remat_gives_the_gradients_of_no_remat(kind):
    """--grad-checkpointing recomputes each trunk block in the backward:
    the same loss and gradients as without it."""
    name, ov = _overrides(kind)
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(_image_size(kind), 6).items()}
    grads = []
    for remat in (False, True):
        tm = create_model(name, device="cpu", grad_checkpointing=remat,
                          seed=3, **ov)
        img = tm.encode_image(batch["global_images"][0].float())
        txt = tm.encode_text(batch["texts"][0].long())
        loss = (img["image_features"] @ txt["text_features"].T).square() \
            .mean()
        loss.backward()
        grads.append({n: p.grad.clone() for n, p in tm.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for n in grads[0]:
        torch.testing.assert_close(grads[1][n], grads[0][n], rtol=1e-5,
                                   atol=1e-7, msg=n)
