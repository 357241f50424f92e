"""The port's training-step options against cosmos_tpu, and every newly
ported trainer flag through cosmos_tpu_torch.training.main on the CPU:
LiT locking (``frozen_mask`` key for key against JAX's through the weight
bridge's names; clipping over the trainable tensors only, against JAX's
optax chain), remat under each policy (the same step as without it, with
the kernel path's plain versions run again in the backward), the exact
accumulation with patch dropout (the big batch's step; one draw for both
passes), and main([...], device="cpu") with each flag set of
chip_smoke.py's phase 15 plus a resumed run, bitwise.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.data.synthetic import write_shards
from cosmos_tpu_torch.models import vit as pvit
from cosmos_tpu_torch.models.convert import (_count_blocks, build_name_map,
                                             state_dict_from_jax_params)
from cosmos_tpu_torch.ops import fused_attention as pfa
from cosmos_tpu_torch.training import main as pmain
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import (TrainStepConfig, freeze,
                                             frozen_mask)

TINY = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
            vision_width=32, vision_layers=2, vision_head_width=16,
            text_context_length=12, text_vocab_size=128, text_width=32,
            text_heads=2, text_layers=2)
# head dim 64 in both towers: the self-attentions take the kernel path
# (on the CPU, K1's and K2's plain versions)
KERNEL_TINY = dict(embed_dim=64, vision_width=128, vision_head_width=64,
                   vision_image_size=64, text_width=128, text_heads=2)
COSMOS = dict(cosmos=True, output_all=True, attentional_pool=True,
              add_zero_attn=True)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pair():
    jm, jp = H.jax_create_fast("ViT-B-16", seed=0, **COSMOS, **TINY)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    tm = create_model("ViT-B-16", device="cpu", **COSMOS, **TINY)
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    return jp, tm


def _by_port_name(tree, params):
    """A JAX pytree shaped like ``params`` as {port state-dict key: leaf},
    through the weight bridge's name map."""
    out = {}
    for key, path, _ in build_name_map(_count_blocks(params["visual"]),
                                       _count_blocks(params["text"])):
        node = tree
        try:
            for p in path:
                node = node[p]
        except KeyError:
            continue
        out[key] = node
    return out


# (lock_image, lock_text, unlocked_groups, text_unlocked_layers,
#  text_freeze_layer_norm); 2 layers a tower, so 4 image lock groups
LOCK_CASES = {
    "image": (True, False, 0, 0, None),
    "image-groups-1": (True, False, 1, 0, None),
    "image-groups-2": (True, False, 2, 0, None),
    "image-groups-3": (True, False, 3, 0, None),
    "image-groups-stem": (True, False, 4, 0, None),
    "text": (False, True, 0, 0, None),
    "text-layers-1": (False, True, 0, 1, None),
    "text-layers-all": (False, True, 0, 5, None),
    "text-ln-trainable": (False, True, 0, 0, False),
    "text-ln-frozen": (False, True, 0, 1, True),
    "both": (True, True, 2, 1, None),
    "none": (False, False, 3, 1, False),
}


@pytest.mark.parametrize("case", sorted(LOCK_CASES))
def test_frozen_mask_equals_jax(pair, case):
    jp, tm = pair
    args = LOCK_CASES[case]
    want = _by_port_name(jax_train.frozen_mask(jp, *args), jp)
    got = frozen_mask(tm, *args)
    assert set(got) == set(want) == set(tm.state_dict())
    assert got == {k: bool(v) for k, v in want.items()}


def test_frozen_mask_refuses_groups_past_the_stem(pair):
    jp, tm = pair
    with pytest.raises(ValueError, match="exceeds"):
        jax_train.frozen_mask(jp, lock_image=True, unlocked_groups=5)
    with pytest.raises(ValueError, match="exceeds"):
        frozen_mask(tm, lock_image=True, unlocked_groups=5)


def test_clipping_sees_the_trainable_tensors_only(pair):
    """JAX's test_grad_clip_excludes_frozen_params: gradients of 1e3 in
    the locked image tower and 1e-3 elsewhere, clipped at 10x the
    trainable norm.  JAX zeroes the frozen gradients before the clip; the
    port's optimizer never holds the frozen tensors.  Both leave the
    trainable update unclipped and the frozen weights where they were."""
    jp, _ = pair
    tm = create_model("ViT-B-16", device="cpu", **COSMOS, **TINY)
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    mask_tree = jax_train.frozen_mask(jp, lock_image=True)
    grads = jax.tree_util.tree_map(
        lambda f, x: np.full_like(x, 1e3 if f else 1e-3), mask_tree, jp)
    trainable = optax.global_norm(jax.tree_util.tree_map(
        lambda f, g: jnp.zeros_like(g) if f else g, mask_tree, grads))
    clip = float(trainable) * 10.0
    lr = jax_sched.const_lr(1e-2, 0, 10)
    tx = jax_train.create_optimizer(lr, lock_image=True, grad_clip_norm=clip,
                                    weight_decay=0.0)
    params = jax.tree_util.tree_map(jnp.asarray, jp)
    updates, _ = tx.update(grads, tx.init(params), params)
    want = state_dict_from_jax_params(jax.tree_util.tree_map(
        np.asarray, optax.apply_updates(params, updates)))

    mask = frozen_mask(tm, lock_image=True)
    freeze(tm, mask)
    opt = create_optimizer(tm, scheduler.const_lr(1e-2, 0, 10),
                           grad_clip_norm=clip, weight_decay=0.0)
    port_grads = state_dict_from_jax_params(grads)
    assert port_grads["visual.proj"].max() == 1e3 and mask["visual.proj"]
    for n, p in tm.named_parameters():
        if p.requires_grad:
            p.grad = port_grads[n]
    opt.step()
    got = tm.state_dict()
    init = state_dict_from_jax_params(jp)
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
        if mask[n]:
            assert torch.equal(got[n], init[n]), n
        else:   # moved by the unclipped step: about lr
            assert (got[n] - init[n]).abs().max() > 0.5e-2, n


def _batch(seed, b, size=64, length=16, vocab=49000):
    """uint8 crops (2 global of ``size`` px, 2 local of half that) and 3
    caption views of batch ``b``."""
    rng = np.random.default_rng(seed)
    return {
        "global_images": torch.from_numpy(rng.integers(
            0, 256, (2, b, size, size, 3), np.uint8)),
        "local_images": torch.from_numpy(rng.integers(
            0, 256, (2, b, size // 2, size // 2, 3), np.uint8)),
        "texts": torch.from_numpy(rng.integers(1, vocab, (3, b, length))),
    }


def _tiny_batch(seed, b):
    """A batch at TINY's sizes: 16 px globals, 12-token captions."""
    return _batch(seed, b, size=16, length=12, vocab=127)


def _one_step(model, batch, **cfg_kw):
    # AdamW's first step is lr·g/(|g| + eps): a large eps keeps it a smooth
    # function of the gradient, so the float noise of a gradient that is
    # zero in exact arithmetic (an attention's key bias) stays noise
    opt = create_optimizer(model, scheduler.const_lr(1e-3, 0, 10), eps=1e-3)
    step = make_train_step(model, opt, TrainStepConfig(**cfg_kw))
    state = create_train_state(model, opt)
    m = step(state, batch)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return m, grads, state


@pytest.mark.parametrize("policy", ["", "nothing_saveable", "dots_saveable",
                                    "checkpoint_dots",
                                    "dots_with_no_batch_dims_saveable",
                                    "checkpoint_dots_with_no_batch_dims",
                                    "everything_saveable"])
def test_remat_step_equals_no_remat(policy, monkeypatch):
    """JAX's test_remat_policy_step_matches_no_remat: one COSMOS step with
    each policy gives the loss, gradients and updated weights of the step
    without remat, to the bit on the CPU; and every block that gets a
    gradient runs K1's plain version again in the backward, but under
    ``everything_saveable``, which keeps the operator's output (JAX's
    policies treat the Pallas call so)."""
    calls = []
    orig = pfa.fused_attention_qkv_reference
    monkeypatch.setattr(pfa, "fused_attention_qkv_reference",
                        lambda *a: calls.append(a[0].shape) or orig(*a))
    batch = _batch(4, 2)
    runs = []
    for remat in (False, True):
        calls.clear()
        model = create_model("ViT-Tiny-Test", device="cpu", **COSMOS,
                             **KERNEL_TINY, grad_checkpointing=remat,
                             remat_policy=policy)
        m, grads, state = _one_step(model, batch)
        runs.append((m, grads, state.student.state_dict(), len(calls)))
    (m0, g0, s0, n0), (m1, g1, s1, n1) = runs
    assert m1["loss"].item() == m0["loss"].item()
    assert g0.keys() == g1.keys()
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    # the student's 3 tower calls with a gradient (globals, locals, the
    # captions) x 2 blocks
    assert n1 - n0 == (0 if policy == "everything_saveable" else 3 * 2)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="'offload_dots'"):
        create_model("ViT-Tiny-Test", device="cpu", grad_checkpointing=True,
                     remat_policy="offload_dots")


def test_accum_exact_equals_the_big_batch_step():
    """JAX's test_grad_accumulation_matches_big_batch_exactly: 2 micro-
    batches of 2 give the step of one batch of 4."""
    big = _tiny_batch(5, 4)
    halves = {k: torch.stack([v[:, :2], v[:, 2:]]) for k, v in big.items()}
    runs = []
    for batch, accum in ((big, 1), (halves, 2)):
        model = create_model("ViT-B-16", device="cpu", **TINY, seed=3)
        runs.append(_one_step(model, batch, cosmos=False, accum_freq=accum,
                              log_grad_norm=True))
    (m0, g0, st0), (m1, g1, st1) = runs
    np.testing.assert_allclose(m1["loss"].item(), m0["loss"].item(),
                               rtol=1e-5)
    np.testing.assert_allclose(m1["grad_norm"].item(),
                               m0["grad_norm"].item(), rtol=1e-4)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-4,
                                   atol=1e-6 * max(1.0, g0[n].abs().max()),
                                   err_msg=n)
    p0, p1 = st0.student.state_dict(), st1.student.state_dict()
    for n in p0:
        np.testing.assert_allclose(p1[n].numpy(), p0[n].numpy(), rtol=2e-4,
                                   atol=2e-5, err_msg=n)


def test_accum_exact_takes_one_draw_for_both_passes(monkeypatch):
    """Patch dropout under the exact accumulation: each micro-batch's
    cached and re-forwarded features come from the same draw, the draws
    of the two micro-batches differ, and another seed draws apart."""
    seen = []
    orig = pvit.patch_dropout

    def spy(x, prob, generator=None, **kw):
        out = orig(x, prob, generator, **kw)
        seen.append(out.detach().clone())
        return out

    monkeypatch.setattr(pvit, "patch_dropout", spy)
    batch = {k: torch.stack([v, v]) for k, v in _tiny_batch(6, 2).items()}
    losses = []
    for seed in (0, 0, 1):
        seen.clear()
        model = create_model("ViT-B-16", device="cpu", **TINY, seed=3,
                             force_patch_dropout=0.5)
        m, _, _ = _one_step(model, batch, cosmos=False, accum_freq=2,
                            seed=seed)
        losses.append(m["loss"].item())
        # pass 1: micro 0 globals, locals, micro 1 ...; pass 2 the same
        assert len(seen) == 8
        first, second = seen[:4], seen[4:]
        for a, b in zip(first, second):
            assert torch.equal(a, b)
        # the two micro-batches hold the same images and draw apart
        assert not torch.equal(first[0], first[2])
        assert first[0].shape[1] == 1 + 2   # class token + 2 of 4 patches
    assert losses[0] == losses[1] != losses[2]


# --- the trainer -------------------------------------------------------

COSMOS_FLAGS = ["--cosmos", "--output-all", "--attentional-pool",
                "--add-zero-attn", "--use-imagecrop-aug",
                "--local-crops-number", "2", "--caption-sampling-mode",
                "textcrop", "--num-sampled-captions", "3"]
BASE = ["--model", "ViT-Tiny-Test", "--dataset-type", "webdataset",
        "--precision", "fp32", "--log-every-n-steps", "1", "--workers", "1",
        "--lr", "1e-3", "--warmup", "1", "--seed", "3", "--fix-momentum",
        "--batch-size", "4", "--epochs", "1"]
# chip_smoke.py phase 15's flag sets, and the flags no set there has;
# (flags, micro-batches a step)
FLAG_SETS = {
    "clip": (["--accum-freq", "2", "--force-patch-dropout", "0.5",
              "--grad-checkpointing"], 2),
    "cosmos-locked": (COSMOS_FLAGS + [
        "--lock-image", "--lock-image-unlocked-groups", "2", "--lock-text",
        "--lock-text-unlocked-layers", "1", "--init-last-layer",
        "--grad-checkpointing", "--remat-policy",
        "dots_with_no_batch_dims_saveable"], 1),
    "siglip": (["--siglip", "--accum-freq", "2"], 2),
    "distill": (["--distill-model", "ViT-Tiny-Test"], 1),
    "cosmos-flash-off": (COSMOS_FLAGS + ["--flash-attention", "off"], 1),
    "cosmos-flash-on-text-ln": (COSMOS_FLAGS + [
        "--use-flash-attention", "--lock-text",
        "--no-lock-text-freeze-layer-norm"], 1),
}


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    write_shards(str(d / "train-{i:04d}.tar"), 2, 8, seed=0, fmt="png",
                 size_range=(36, 72))
    model = create_model("ViT-Tiny-Test", device="cpu", seed=9)
    torch.save(model.state_dict(), str(d / "distill.pt"))
    return d


def _argv(shards, logs, name, *extra):
    return BASE + ["--train-data", str(shards / "train-{0000..0001}.tar"),
                   "--logs-dir", str(logs), "--name", name, *extra]


def _load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("name", sorted(FLAG_SETS))
def test_main_runs_each_flag_set(shards, tmp_path, name):
    flags, accum = FLAG_SETS[name]
    if name == "distill":
        flags = flags + ["--distill-pretrained", str(shards / "distill.pt")]
    # 2 steps of batch 4 x the micro-batches
    m = pmain.main(_argv(shards, tmp_path, name, "--train-num-samples",
                         str(8 * accum), *flags), device="cpu")
    stats = m["train_epoch_stats"][0]
    assert stats["steps"] == 2
    losses = [line["loss"] for line in stats["logged"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert all(0 < line["logit_scale"] <= 100 for line in stats["logged"])
    ckpt = _load(tmp_path / name / "checkpoints" / "epoch_1.pt")
    student, teacher = ckpt["student"], ckpt["teacher"]
    if name == "siglip":
        assert "logit_bias" in student and "contrastive_loss" in \
            stats["logged"][0]
    if name == "distill":
        # the frozen model is never saved: only the student's tensors
        assert set(student) == set(create_model(
            "ViT-Tiny-Test", device="cpu").state_dict())
        assert "distill_loss" in stats["logged"][0]
    if name in ("cosmos-locked", "cosmos-flash-on-text-ln"):
        model = create_model("ViT-Tiny-Test", device="cpu", seed=3, **COSMOS)
        init = model.state_dict()
        first = "visual.transformer.resblocks.0.attn.in_proj_weight"
        last = "transformer.resblocks.1.attn.in_proj_weight"
        if name == "cosmos-locked":
            mask = frozen_mask(model, lock_image=True, lock_text=True,
                               unlocked_groups=2, text_unlocked_layers=1)
            assert torch.equal(student[first], init[first])
            # --init-last-layer: the student's and the teacher's last
            # blocks are redrawn apart
            assert not torch.equal(student[last], init[last])
            assert not torch.equal(teacher[last], student[last])
        else:
            mask = frozen_mask(model, lock_text=True,
                               text_freeze_layer_norm=False)
            # the text LayerNorms stay trainable, the rest of the text
            # tower is frozen
            assert torch.equal(student[last], init[last])
            assert not torch.equal(student["ln_final.weight"],
                                   init["ln_final.weight"])
        for k, frozen in mask.items():
            if frozen and k != last:
                assert torch.equal(student[k], init[k]), k
        # the optimizer's state holds the trainable tensors only
        assert len(ckpt["optimizer"]["state"]) == sum(
            not f for f in mask.values()) < len(mask)


def test_resume_with_accum_and_lock_is_bitwise(shards, tmp_path):
    """An uninterrupted 2-epoch run against 1 epoch resumed for a second,
    under --accum-freq 2 and --lock-image: the same student, teacher and
    optimizer state (the trainable tensors only) to the bit."""
    common = ["--train-num-samples", "16", "--accum-freq", "2",
              "--lock-image", "--lock-image-unlocked-groups", "1",
              "--save-most-recent", "--lr-scheduler", "const", "--warmup",
              "6", *COSMOS_FLAGS]
    pmain.main(_argv(shards, tmp_path, "full", *common, "--epochs", "2"),
               device="cpu")
    pmain.main(_argv(shards, tmp_path, "split", *common, "--epochs", "1"),
               device="cpu")
    pmain.main(_argv(shards, tmp_path, "split", *common, "--epochs", "2",
                     "--resume", "latest"), device="cpu")
    full = _load(tmp_path / "full" / "checkpoints" / "epoch_2.pt")
    resumed = _load(tmp_path / "split" / "checkpoints" / "epoch_2.pt")
    assert (resumed["epoch"], resumed["step"], resumed["num_updates"]) == (
        2, 4, 4)
    for key in ("student", "teacher"):
        assert full[key].keys() == resumed[key].keys()
        for k in full[key]:
            assert torch.equal(full[key][k], resumed[key][k]), (key, k)
    opt_full, opt_resumed = full["optimizer"], resumed["optimizer"]
    assert opt_full["param_groups"] == opt_resumed["param_groups"]
    assert opt_full["state"].keys() == opt_resumed["state"].keys()
    for i, st in opt_full["state"].items():
        for k, v in st.items():
            assert torch.equal(v, opt_resumed["state"][i][k]), (i, k)
    # the optimizer holds the trainable tensors only: of the image
    # tower's, visual.proj
    model = create_model("ViT-Tiny-Test", device="cpu", **COSMOS)
    mask = frozen_mask(model, lock_image=True, unlocked_groups=1)
    n_trainable = sum(not f for f in mask.values())
    assert len(opt_full["state"]) == n_trainable < len(mask)
    assert os.path.exists(tmp_path / "split" / "checkpoints" /
                          "epoch_latest.pt")
