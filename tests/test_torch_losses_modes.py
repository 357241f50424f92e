"""The port's SigLIP and distillation losses, patch dropout, last-layer
re-initialisation, logit bias and the attention's use_flash tri-state
against cosmos_tpu on the same inputs (float32 unless stated).

JAX draws patch-dropout scores from its key and the port from a torch
generator, so the parity tests hand the port the indices JAX keeps
(``keep_idx``); the port's own draws are held to their invariants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_hf_cases as H
from cosmos_tpu.losses import contrastive as jloss
from cosmos_tpu.models import attention as jattn
from cosmos_tpu.models import layers as jlayers
from cosmos_tpu.training import evaluate as jeval
from cosmos_tpu_torch.losses import DistillClipLoss, SigLipLoss
from cosmos_tpu_torch.models import attention as pattn
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.models.init_utils import reinit_last_transformer_layer
from cosmos_tpu_torch.models.layers import patch_dropout
from cosmos_tpu_torch.training.evaluate import evaluate_on_split
from cosmos_tpu_torch.training.train import patch_drop_generator

# a ViT-B-16 layout cut to 2 layers of width 32 (head dim 16)
TINY = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
            vision_width=32, vision_layers=2, vision_head_width=16,
            text_context_length=12, text_vocab_size=128, text_width=32,
            text_heads=2, text_layers=2)
SIGLIP = dict(init_logit_scale=float(np.log(10.0)), init_logit_bias=-10.0)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _features(seed, *shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _leaf(x):
    return torch.from_numpy(np.asarray(x)).requires_grad_(True)


def _grad_close(got, want, rtol=1e-5):
    """rtol of each element, and of the tensor's largest magnitude for the
    elements near zero (float32 sums in another order)."""
    want = np.asarray(want)
    np.testing.assert_allclose(_np(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("b,d,views,bias", [
    (4, 8, 1, -10.0), (6, 16, 3, 0.5), (5, 8, 2, None)])
def test_siglip_loss_equals_jax(b, d, views, bias):
    img, txt = _features(b, views, b, d), _features(b + 1, views, b, d)
    scale = np.float32(np.exp(1.3))
    args = (jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
            None if bias is None else jnp.asarray(np.float32(bias)))
    argnums = (0, 1, 2) if bias is None else (0, 1, 2, 3)
    want, want_g = jax.value_and_grad(
        lambda *a: jloss.SigLipLoss()(*a), argnums=argnums)(*args)

    t_args = [_leaf(img), _leaf(txt), _leaf(scale)]
    t_args.append(None if bias is None else _leaf(np.float32(bias)))
    got = SigLipLoss()(*t_args, output_dict=True)["contrastive_loss"]
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for t, w in zip(t_args, want_g):
        _grad_close(t.grad, w)


@pytest.mark.parametrize("b,d,views", [(4, 8, 1), (6, 16, 2), (3, 8, 3)])
def test_distill_loss_equals_jax_and_stops_at_the_frozen_features(b, d,
                                                                  views):
    img, txt = _features(1, views, b, d), _features(2, views, b, d)
    d_img, d_txt = _features(3, views, b, d), _features(4, views, b, d)
    scale, d_scale = np.float32(14.0), np.float32(20.0)

    def jfn(i, t, s, di, dt, ds):
        out = jloss.DistillClipLoss()(i, t, s, di, dt, ds, output_dict=True)
        return out["contrastive_loss"] + out["distill_loss"], out

    (_, want), want_g = jax.value_and_grad(jfn, argnums=(0, 1, 2, 3, 4, 5),
                                           has_aux=True)(
        *(jnp.asarray(x) for x in (img, txt, scale, d_img, d_txt, d_scale)))
    leaves = [_leaf(x) for x in (img, txt, scale, d_img, d_txt, d_scale)]
    got = DistillClipLoss()(*leaves, output_dict=True)
    (got["contrastive_loss"] + got["distill_loss"]).backward()
    for k in ("contrastive_loss", "distill_loss"):
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5,
                                   err_msg=k)
    for t, w in zip(leaves[:3], want_g[:3]):
        _grad_close(t.grad, w)
    # the frozen model's features take no gradient, as JAX's stop_gradient
    # gives them none; its logit scale none either (in JAX a parameter of
    # the model the step never differentiates)
    for t, w in zip(leaves[3:5], want_g[3:5]):
        assert t.grad is None
        assert not np.asarray(w).any()
    assert leaves[5].grad is None


@pytest.mark.parametrize("prob,exclude_first", [
    (0.5, True), (0.25, True), (0.75, True), (0.5, False)])
def test_patch_dropout_with_jax_indices_equals_jax(prob, exclude_first):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 17, 8)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    want = jlayers.patch_dropout(jnp.asarray(x), key, prob, exclude_first)
    # the indices JAX keeps: its top-k over its normal scores
    n = 16 if exclude_first else 17
    keep = jax.lax.top_k(jax.random.normal(key, (3, n)),
                         max(1, int(n * (1 - prob))))[1]
    got = patch_dropout(torch.from_numpy(x), prob,
                        keep_idx=torch.from_numpy(np.asarray(keep)).long(),
                        exclude_first_token=exclude_first)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,prob", [(196, 0.5), (36, 0.5), (16, 0.9),
                                    (4, 0.99)])
def test_patch_dropout_draw_keeps_the_class_token_and_count(n, prob):
    x = torch.arange(2 * (n + 1), dtype=torch.float32).reshape(2, n + 1, 1)
    out = patch_dropout(x, prob, patch_drop_generator(0, 0))
    keep = max(1, int(n * (1 - prob)))
    assert out.shape == (2, keep + 1, 1)
    assert torch.equal(out[:, 0], x[:, 0])
    for row in range(2):   # distinct patch tokens of their own row
        kept = out[row, 1:, 0]
        assert len(set(kept.tolist())) == keep
        assert set(kept.tolist()) <= set(x[row, 1:, 0].tolist())
    assert torch.equal(patch_dropout(x, 0.0), x)


def test_patch_drop_generator_keys_on_seed_step_and_micro_batch():
    def draw(*key):
        return torch.randn(64, generator=patch_drop_generator(*key))

    base = draw(0, 3)
    assert torch.equal(base, draw(0, 3))
    assert torch.equal(draw(1, 2, 1), draw(1, 2, 1))
    for other in ((1, 3), (0, 4), (0, 3, 0), (0, 3, 1)):
        assert not torch.equal(base, draw(*other)), other
    assert not torch.equal(draw(0, 3, 0), draw(0, 3, 1))


def test_vision_tower_drops_only_with_a_generator():
    tm = create_model("ViT-B-16", device="cpu", force_patch_dropout=0.5,
                      **TINY)
    imgs = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, 16, 3)).astype(np.float32))
    seen = []
    hook = tm.visual.transformer.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[1]))
    with torch.no_grad():
        a = tm.encode_image(imgs)["image_features"]
        b = tm.encode_image(imgs)["image_features"]
        tm.visual(imgs, patch_drop=patch_drop_generator(0, 0))
    hook.remove()
    assert torch.equal(a, b)
    assert seen == [5, 5, 3]   # 1 + 4 patches; 1 + 2 kept


def test_reinit_last_layer_redraws_only_the_last_blocks():
    kw = dict(TINY, vision_width=256, vision_head_width=64, text_width=256,
              text_heads=4)
    student = create_model("ViT-B-16", device="cpu", seed=0, **kw)
    teacher = create_model("ViT-B-16", device="cpu", seed=0, **kw)
    before = {k: v.clone() for k, v in student.state_dict().items()}
    reinit_last_transformer_layer(student, torch.Generator().manual_seed(1))
    reinit_last_transformer_layer(teacher, torch.Generator().manual_seed(2))
    s, t = student.state_dict(), teacher.state_dict()
    width, layers = 256, 2
    stds = {"attn.in_proj_weight": width ** -0.5,
            "attn.out_proj.weight": width ** -0.5 * (2 * layers) ** -0.5,
            "mlp.c_fc.weight": (2 * width) ** -0.5,
            "mlp.c_proj.weight": width ** -0.5 * (2 * layers) ** -0.5}
    redrawn = {f"{tower}.resblocks.1.{name}"
               for tower in ("visual.transformer", "transformer")
               for name in stds}
    for k, v in before.items():
        if k in redrawn:
            std = stds[k.split("resblocks.1.")[1]]
            # OpenCLIP's stds, which JAX's init_utils uses
            assert abs(s[k].std().item() / std - 1) < 0.05, k
            assert abs(s[k].mean().item()) < 0.05 * std, k
            assert not torch.equal(s[k], v), k
            assert not torch.equal(s[k], t[k]), k   # independent draws
        else:
            assert torch.equal(s[k], v), k


@pytest.fixture(scope="module")
def siglip_pair():
    jm, jp = H.jax_create_fast("ViT-B-16", seed=4, **SIGLIP, **TINY)
    tm = create_model("ViT-B-16", device="cpu", **SIGLIP, **TINY)
    tm.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    return jm, jp, tm


def test_logit_bias_crosses_the_bridge_and_enters_the_logits(siglip_pair):
    jm, jp, tm = siglip_pair
    assert tm.logit_bias.item() == pytest.approx(-10.0)
    assert tm.logit_scale.item() == pytest.approx(np.log(10.0))
    rng = np.random.default_rng(1)
    imgs = rng.standard_normal((3, 16, 16, 3)).astype(np.float32)
    toks = rng.integers(1, 127, (3, 12))
    want = jm.apply({"params": jp}, jnp.asarray(imgs),
                    jnp.asarray(toks, jnp.int32), method=jm.get_logits)
    out = jm.apply({"params": jp}, jnp.asarray(imgs),
                   jnp.asarray(toks, jnp.int32))
    with torch.no_grad():
        got = tm.get_logits(torch.from_numpy(imgs), torch.from_numpy(toks))
        got_out = tm(torch.from_numpy(imgs), torch.from_numpy(toks))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(_np(got_out["logit_bias"]),
                               np.asarray(out["logit_bias"]))


@pytest.mark.parametrize("siglip", [False, True])
def test_val_loss_of_clip_and_siglip_models_equals_jax(siglip):
    kw = dict(SIGLIP if siglip else {}, **TINY)
    jm, jp = H.jax_create_fast("ViT-B-16", seed=6, **kw)
    tm = create_model("ViT-B-16", device="cpu", **kw)
    tm.load_state_dict(state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jp)), strict=True)
    rng = np.random.default_rng(2)
    batches = [(rng.standard_normal((4, 16, 16, 3)).astype(np.float32),
                rng.integers(1, 127, (4, 12)).astype(np.int64))
               for _ in range(2)]
    want = jeval.evaluate_on_split(jm, jp, batches, keyword="v")
    got = evaluate_on_split(tm, batches, keyword="v")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def _mha_pair(use_flash, d=128, heads=2, dtype=torch.float32):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jmod = jattn.MultiheadAttention(num_heads=heads, dtype=jdt,
                                    use_flash=use_flash)
    x = np.random.default_rng(3).standard_normal((2, 9, d)).astype(np.float32)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), causal=True)
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    mod = pattn.MultiheadAttention(d, heads, dtype=dtype, use_flash=use_flash)
    mod.load_state_dict({
        "in_proj_weight": torch.from_numpy(p["in_proj_kernel"].T.copy()),
        "in_proj_bias": torch.from_numpy(p["in_proj_bias"].copy()),
        "out_proj.weight": torch.from_numpy(p["out_proj"]["kernel"].T.copy()),
        "out_proj.bias": torch.from_numpy(p["out_proj"]["bias"].copy())})
    return jmod, params, mod, x


@pytest.mark.parametrize("flag", ["off", "on", "auto"])
@pytest.mark.parametrize("causal", [True, False])
def test_use_flash_routing_equals_jax(flag, causal, monkeypatch):
    """JAX's resolve_fused: 'off' never takes the kernel, 'on' takes it
    where the gate admits it; 'auto' is the kernel path in the port (on
    the CPU its plain version) where JAX's CPU backend picks XLA."""
    from cosmos_tpu.ops import fused_attention as jfa

    use_flash = {"off": False, "on": True, "auto": None}[flag]
    jmod, params, mod, x = _mha_pair(use_flash)
    j_calls, t_calls = [], []
    orig_j, orig_t = jfa.fused_attention_qkv, pattn.fused_attention_qkv
    monkeypatch.setattr(jfa, "fused_attention_qkv",
                        lambda *a: j_calls.append(1) or orig_j(*a))
    monkeypatch.setattr(pattn, "fused_attention_qkv",
                        lambda *a: t_calls.append(1) or orig_t(*a))
    want = jmod.apply(params, jnp.asarray(x), causal=causal)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), causal=causal)
    assert bool(j_calls) == jattn.resolve_fused(use_flash)
    assert bool(t_calls) == (flag != "off")
    if flag != "auto":
        assert bool(t_calls) == bool(j_calls)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_off_outputs_equal_jax_xla_path(dtype):
    """use_flash=False: the plain path with logits in the compute dtype,
    JAX's use_flash=False path, in float32 and bfloat16."""
    jmod, params, mod, x = _mha_pair(False, dtype=dtype)
    want = jmod.apply(params, jnp.asarray(x), causal=True)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), causal=True)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
