"""The port's CoCa (cosmos_tpu_torch.models.coca, losses.CoCaLoss, the CoCa
step) against cosmos_tpu's on the CPU.

Equal widths (coca_Tiny-Test, every width 32): JAX's parameters are drawn
with numpy from a seed at the shapes jax.eval_shape gives (no JAX init is
compiled) and carried across by the weight bridge (state_dict_from_jax_params,
which must fill the port's model exactly).  Held to JAX in float32: the
forward's outputs within 1e-5 (absolute), the CLS pad mask and the text
tower on captions with pads, CoCaLoss within 1e-6 (relative), one CoCa
train step at one layer a tower and in the decoder (loss within 1e-5,
every updated parameter within 1e-5 relative; tests/test_torch_dp_train.py
holds the step at full depth on 2 ranks), greedy, top-k-1 and beam-search
tokens bit for bit, and the nucleus filter.  The exported encoders
(--trace) give the live features, and the FLOPs/params report counts
JAX's parameters.

Unequal widths (coca_ViT-B-32's 768/512/512, 12 and 8 heads, 256 queries,
at 1 layer a tower and 64 px): JAX's model still raises, the port's
pooler equals torch.nn.MultiheadAttention(512, 8, kdim=768, vdim=768) with
the same weights in float64 within 1e-10, and the whole model runs forward
and backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from cosmos_tpu.losses import CoCaLoss as JaxCoCaLoss
from cosmos_tpu.models import coca as jcoca
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.factory import init_model_params
from cosmos_tpu.models.text import coca_cls_pad_mask as jax_cls_pad_mask
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (CoCa, CoCaLoss, create_model, create_optimizer,
                              create_train_state, make_train_step)
from cosmos_tpu_torch.models import coca as pcoca
from cosmos_tpu_torch.models.attention import AttentionalPooler
from cosmos_tpu_torch.models.config import build_clip_cfg
from cosmos_tpu_torch.models.convert import (model_name_map,
                                             state_dict_from_jax_params)
from cosmos_tpu_torch.models.factory import init_weights
from cosmos_tpu_torch.models.text import coca_cls_pad_mask
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig

FWD_TOL = dict(atol=1e-5, rtol=0)
# relative: the caption losses here are O(10), where float32's spacing
# is 2e-6
LOSS_TOL = dict(rtol=1e-6, atol=0)
STEP_LOSS_TOL = dict(atol=1e-5, rtol=0)
STEP_PARAM_TOL = dict(rtol=1e-5, atol=1e-7)
POOLER_TOL = dict(atol=1e-10, rtol=0)
SOT, EOT, CTX = 510, 511, 12
GEN = dict(seq_len=8, sot_token_id=SOT, eot_token_id=EOT, min_seq_len=2)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _draw(jm):
    """JAX's parameters of ``jm`` drawn with numpy at the shapes
    jax.eval_shape gives."""
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: init_model_params(jm)))


@pytest.fixture(scope="module")
def pair():
    """(JAX CoCa, its parameters drawn with numpy, the port's CoCa holding
    the same weights)."""
    jm, _ = jax_create_model("coca_Tiny-Test", init_params=False,
                             use_flash=False)
    jp = _draw(jm)
    tm = create_model("coca_Tiny-Test", device="cpu")
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    return jm, jp, tm


def _one_layer_port():
    """The port's coca_Tiny-Test at one layer a tower and in the
    decoder."""
    cfg = build_clip_cfg("coca_Tiny-Test", {"vision_layers": 1,
                                            "text_layers": 1})
    return CoCa(dataclasses.replace(cfg, multimodal_cfg=dataclasses.replace(
        cfg.multimodal_cfg, layers=1)))


def _one_layer_pair():
    """``pair`` at one layer a tower and in the decoder: JAX's step
    compiles in two thirds of the time.  The step at coca_Tiny-Test's
    depth is held to JAX's in tests/test_torch_dp_train.py (2 ranks)."""
    jm, _ = jax_create_model("coca_Tiny-Test", init_params=False,
                             use_flash=False, vision_layers=1,
                             text_layers=1)
    mm = dataclasses.replace(jm.cfg.multimodal_cfg, layers=1)
    jm = jm.clone(cfg=dataclasses.replace(jm.cfg, multimodal_cfg=mm))
    jp = _draw(jm)
    tm = _one_layer_port()
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    return jm, jp, tm


def _inputs(seed, b=3):
    """Images and captions, two of them padded after a few tokens."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    text = rng.integers(1, EOT, (b, CTX)).astype(np.int32)
    text[:, 0] = SOT
    text[1, 6] = EOT
    text[1, 7:] = 0
    text[2, 2] = EOT
    text[2, 3:] = 0
    return images, text


def _t(a):
    return torch.from_numpy(np.asarray(a)).long() if np.asarray(
        a).dtype.kind == "i" else torch.from_numpy(np.asarray(a))


def test_weight_map_fills_the_port_model(pair):
    _, jp, tm = pair
    sd = state_dict_from_jax_params(jp)
    assert set(sd) == set(tm.state_dict())
    # the name map covers every parameter at unequal widths too (LiT
    # locking reads it), and keeps OpenCLIP's CoCa names
    big = create_model("coca_ViT-B-32", device="meta")
    names = {k for k, _, _ in model_name_map(big)}
    assert {n for n, _ in big.named_parameters()} <= names
    for key in ("text.cls_emb", "text_decoder.cross_attn.0.ln_1_kv.weight",
                "text_decoder.text_projection", "attn_pool.query",
                "ln_attn_pool.weight", "visual.proj"):
        assert key in sd


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """JAX's forward on ``_inputs(0)`` with and without text, and its text
    tower on ``_inputs(1)``'s captions, under one jit."""
    jm, jp, _ = pair

    def run(p, x, t, t2):
        return (jm.apply({"params": p}, x, t),
                jm.apply({"params": p}, x, None),
                jm.apply({"params": p}, t2, False, method=jm._encode_text))

    return jax.jit(run)(jp, *_inputs(0), _inputs(1)[1])


def test_forward_equals_jax(pair, jax_outputs):
    _, _, tm = pair
    images, text = _inputs(0)
    want, want_img, _ = jax_outputs
    with torch.no_grad():
        got = tm(_t(images), _t(text))
        got_img = tm(_t(images))
    assert set(got) == set(want)
    for key in ("image_features", "text_features", "logits", "logit_scale"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **FWD_TOL)
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert set(got_img) == set(want_img) == {"image_features", "image_embs"}
    for key in got_img:
        np.testing.assert_allclose(got_img[key].numpy(),
                                   np.asarray(want_img[key]), err_msg=key,
                                   **FWD_TOL)


def test_cls_pad_mask_and_text_tower_on_padded_captions(pair, jax_outputs):
    _, _, tm = pair
    _, text = _inputs(1)
    np.testing.assert_array_equal(
        coca_cls_pad_mask(_t(text), 0).numpy(),
        np.asarray(jax_cls_pad_mask(jnp.asarray(text), 0)))
    want_latent, want_tokens = jax_outputs[2]
    with torch.no_grad():
        latent, tokens = tm._encode_text(_t(text), normalize=False)
    np.testing.assert_allclose(latent.numpy(), np.asarray(want_latent),
                               **FWD_TOL)
    np.testing.assert_allclose(tokens.numpy(), np.asarray(want_tokens),
                               **FWD_TOL)


@pytest.mark.parametrize("clip_weight", [0.0, 1.0])
def test_coca_loss_equals_jax(clip_weight):
    rng = np.random.default_rng(int(clip_weight) + 5)
    img = rng.standard_normal((4, 16)).astype(np.float32)
    txt = rng.standard_normal((4, 16)).astype(np.float32)
    logits = rng.standard_normal((4, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(1, 50, (4, 7)).astype(np.int32)
    labels[1, 4:] = 0
    labels[3, 1:] = 0
    scale = np.float32(14.3)
    kw = dict(caption_loss_weight=2.0, clip_loss_weight=clip_weight)
    want = JaxCoCaLoss(**kw)(img, txt, logits, labels, scale,
                             output_dict=True)
    got = CoCaLoss(**kw)(_t(img), _t(txt), _t(logits), _t(labels),
                         torch.tensor(scale), output_dict=True)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **LOSS_TOL)


def test_train_step_equals_jax():
    jm, jp, tm = _one_layer_pair()
    b, lr_value, beta1, eps = 4, 1e-3, 0.9, 1e-3
    rng = np.random.default_rng(9)
    batch = {"global_images": rng.integers(0, 256, (2, b, 32, 32, 3),
                                           np.uint8),
             "texts": rng.integers(1, EOT, (2, b, CTX)).astype(np.int32)}
    batch["texts"][0, 1, 5:] = 0
    cfg_kw = dict(cosmos=False, coca=True, coca_caption_loss_weight=1.5,
                  coca_contrastive_loss_weight=1.0, momentum_teacher=0.9,
                  fix_momentum=True, log_grad_norm=True)

    jlr = jax_sched.const_lr(lr_value, 0, 10)
    opt = jax_train.create_optimizer(jlr, beta1=beta1, beta2=0.98, eps=eps,
                                     weight_decay=0.5)
    mesh = create_mesh(1)
    jstep = jax_train.make_train_step(
        jm, opt, mesh, jax_train.TrainStepConfig(lr_schedule=jlr, **cfg_kw))
    jstate = jax_train.create_train_state(jp, opt, mesh)
    jstate, jmetrics = jstep(jstate, shard_batch(batch, mesh, batch_axis=1))

    lr = scheduler.const_lr(lr_value, 0, 10)
    popt = create_optimizer(tm, lr, beta1=beta1, beta2=0.98, eps=eps,
                            weight_decay=0.5)
    step = make_train_step(tm, popt, TrainStepConfig(lr_schedule=lr,
                                                     **cfg_kw))
    state = create_train_state(tm, popt)
    metrics = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})

    for key in ("loss", "contrastive_loss", "caption_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(jmetrics[key]), err_msg=key,
                                   **STEP_LOSS_TOL)
    for which, params in (("student", jstate.params),
                          ("teacher", jstate.teacher_params)):
        want = state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, params))
        got = getattr(state, which).state_dict()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                       err_msg=f"{which} {k}",
                                       **STEP_PARAM_TOL)


@pytest.fixture(scope="module")
def images_for_generation():
    return np.random.default_rng(11).standard_normal(
        (2, 32, 32, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_greedy(pair, images_for_generation):
    """JAX's greedy tokens, its generate under one jit as its docstring
    runs it."""
    jm, jp, _ = pair
    return jax.jit(lambda p, x: jcoca.generate(
        jm, p, x, generation_type="greedy", **GEN))(
            jp, images_for_generation)


@pytest.mark.parametrize("mode", ["greedy", "top_k1", "beam"])
def test_generation_equals_jax(pair, images_for_generation, jax_greedy,
                               mode):
    jm, jp, tm = pair
    x = images_for_generation
    if mode == "beam":
        want = jax.jit(lambda p, x: jcoca.beam_search_generate(
            jm, p, x, num_beams=3, **GEN))(jp, x)
        got = pcoca.beam_search_generate(tm, _t(x), num_beams=3, **GEN)
    else:
        # JAX's generate takes its greedy branch for top_k with k = 1, so
        # its top-k-1 tokens are its greedy tokens
        kw = (dict(generation_type="greedy") if mode == "greedy"
              else dict(generation_type="top_k", top_k=1))
        want = jax_greedy
        got = pcoca.generate(tm, _t(x), **GEN, **kw)
    assert got.shape == (2, GEN["seq_len"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_top_p_filter(logits, top_p):
    """The nucleus filter of cosmos_tpu.models.coca.generate, as written
    there."""
    sorted_logits = jnp.sort(logits, axis=-1)[:, ::-1]
    probs = jax.nn.softmax(sorted_logits, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = jnp.sum((cum - probs) < top_p, axis=-1)
    cutoff = jnp.take_along_axis(sorted_logits, (keep - 1)[:, None], axis=1)
    return jnp.where(logits < cutoff, -1e30, logits)


@pytest.mark.parametrize("top_p", [1e-6, 0.1, 0.5, 0.9])
def test_top_p_filter_equals_jax(top_p):
    logits = np.random.default_rng(13).standard_normal(
        (4, 64)).astype(np.float32) * 3
    want = np.asarray(_jax_top_p_filter(jnp.asarray(logits), top_p))
    got = pcoca.top_p_filter(_t(logits), top_p).numpy()
    np.testing.assert_array_equal(got, want)


def test_tiny_top_p_is_greedy(pair, images_for_generation):
    _, _, tm = pair
    x = _t(images_for_generation)
    greedy = pcoca.generate(tm, x, generation_type="greedy", **GEN)
    nucleus = pcoca.generate(tm, x, generation_type="top_p", top_p=1e-6,
                             generator=torch.Generator().manual_seed(0),
                             **GEN)
    assert torch.equal(greedy, nucleus)


def test_jax_coca_vit_b32_still_raises():
    jm, _ = jax_create_model("coca_ViT-B-32", init_params=False)
    with pytest.raises(TypeError, match="dot_general"):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 224, 224, 3)),
                       jnp.zeros((1, 76), jnp.int32))


def test_pooler_at_unequal_widths_equals_torch_mha_float64():
    pooler = AttentionalPooler(512, 768, n_queries=256, num_heads=8,
                               dtype=torch.float64).double()
    init_weights(pooler, torch.Generator().manual_seed(0))
    with torch.no_grad():
        pooler.attn.in_proj_bias.normal_(
            generator=torch.Generator().manual_seed(1))
        for ln in (pooler.ln_q, pooler.ln_k):
            ln.weight.uniform_(0.5, 1.5)
            ln.bias.normal_()
    ref = torch.nn.MultiheadAttention(512, 8, kdim=768, vdim=768,
                                      batch_first=True, dtype=torch.float64)
    ref.load_state_dict({k: v for k, v in pooler.attn.state_dict().items()})
    x = torch.randn(2, 49, 768, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = pooler(x)
        kv = F.layer_norm(x, (768,), pooler.ln_k.weight, pooler.ln_k.bias)
        q = F.layer_norm(pooler.query, (512,), pooler.ln_q.weight,
                         pooler.ln_q.bias).expand(2, 256, 512)
        want = ref(q, kv, kv, need_weights=False)[0]
    assert got.shape == (2, 256, 512) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), **POOLER_TOL)


def test_vit_b32_widths_run_forward_and_backward():
    cfg = build_clip_cfg("coca_ViT-B-32", {"vision_layers": 1,
                                           "text_layers": 1,
                                           "vision_image_size": 64})
    cfg = dataclasses.replace(cfg, multimodal_cfg=dataclasses.replace(
        cfg.multimodal_cfg, layers=1))
    model = CoCa(cfg)
    init_weights(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(4)
    images = _t(rng.standard_normal((2, 64, 64, 3)).astype(np.float32))
    text = _t(rng.integers(1, 49407, (2, 76)))
    out = model(images, text)
    assert out["logits"].shape == (2, 75, 49408)
    assert out["image_features"].shape == out["text_features"].shape == (
        2, 512)
    loss = sum(CoCaLoss()(out["image_features"], out["text_features"],
                          out["logits"], out["labels"], out["logit_scale"]))
    loss.backward()
    assert torch.isfinite(loss)
    assert model.attn_pool.attn.k_proj_weight.grad.shape == (512, 768)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_trace_and_profiler_take_coca(pair, tmp_path):
    from cosmos_tpu_torch.models.trace import (load_traced, save_traced,
                                               trace_model)
    from cosmos_tpu_torch.training.profiler import profile_model

    _, jp, _ = pair
    # one layer: the export's time grows with the graph
    tm = _one_layer_port().eval()
    init_weights(tm, torch.Generator().manual_seed(0))
    save_traced(trace_model(tm, batch_size=3), str(tmp_path))
    encoders = load_traced(str(tmp_path))
    images, text = _inputs(2)
    with torch.no_grad():
        for name, x in (("encode_image", _t(images)),
                        ("encode_text", _t(text))):
            assert torch.equal(encoders[name](x), getattr(tm, name)(x))
    row = profile_model("coca_Tiny-Test", device="cpu")
    count = lambda tree: sum(np.size(x) for x in  # noqa: E731
                             jax.tree_util.tree_leaves(tree))
    assert row["mparams"] == round(count(jp) / 1e6, 2)
    assert row["image_mparams"] == round(count(jp["visual"]) / 1e6, 2)


@pytest.mark.parametrize("pool_type", ["first", "last"])
def test_text_tower_pool_types_equal_jax(pool_type):
    """The text tower refuses HF towers only: JAX's other pool types."""
    from test_torch_checkpoint_load import jax_random

    jm, jp = jax_random("ViT-Tiny-Test", text_pool_type=pool_type)
    tm = create_model("ViT-Tiny-Test", device="cpu",
                      text_pool_type=pool_type)
    tm.load_state_dict(state_dict_from_jax_params(jp), strict=True)
    text = np.random.default_rng(6).integers(1, 49407, (3, 16)).astype(
        np.int32)
    want = jax.jit(lambda p, t: jm.apply({"params": p}, t, False,
                                         method=jm.encode_text))(jp, text)
    with torch.no_grad():
        got = tm.encode_text(_t(text))
    np.testing.assert_allclose(got["text_features"].numpy(),
                               np.asarray(want["text_features"]), **FWD_TOL)


@pytest.mark.parametrize("itemsize", [2, 4])
def test_k1_gate_admits_coca_vision_geometry(itemsize):
    """coca_ViT-B-32's vision self-attention, L 50 at width 768 with 12
    heads, goes to the kernel on both sides."""
    from cosmos_tpu.ops import fused_attention as jfa
    from cosmos_tpu_torch.ops import fused_attention as pfa

    assert pfa.supported(12, 768, 50, itemsize)
    assert jfa.supported(12, 768, 50, itemsize=itemsize)
