"""The port's tensor parallelism (``cosmos_tpu_torch/parallel/tp.py``, DTensor
placement over the 'model' axis, K1/K2's batch-only sharding rule, K5/K6's
column and hidden sharding rules) against cosmos_tpu's ``parallel/tp.py``
and GSPMD step, on gloo ranks of the CPU (tests/torch_dp_ranks.py).

With no process: the placements equal JAX's ``tp_spec`` leaf for leaf for
the native towers, CoCa and the timm ViT, EVA02, ConvNeXt and FastViT
trunks, and ``make_train_step_gspmd`` refuses what JAX's refuses, with its
messages.  One spawn of 4 ranks runs the TP encoders on (2, 2) and (4, 1)
meshes for a batch no data axis divides (and EVA02's trunk on (2, 2), and
a BERT and a T5 text tower),
the TP train step on (2, 2) through K1 and K2 (head dim 64, so the
kernels' CPU versions run; the test counts their calls), the same step
under ``FUSED_LN``, under ``fuse_ln`` (K5 and K6 on each rank's local
shard) with and without ``FUSED_LN``, coca_Tiny-Test's step, a CoCa of
unequal widths (its pooler's separate q/k/v column-parallel), a
data-parallel step whose checkpoint a TP state resumes, and the trainer:
COSMOS tensor parallel then under FSDP x TP, CoCa under FSDP then tensor
parallel, an HF tower under FSDP with --lock-text then FSDP x TP; and the
plain-CLIP step of a BERT and a T5 text tower under TP, FSDP over 4 ranks
and FSDP x TP, each against JAX's GSPMD step under its FSDP x TP placement
(one function, whatever the placement), T5's q the one sharded leaf of
the text tower.  The features, the loss and the updated student and teacher lie
within ``rtol=1e-5, atol=1e-5`` of JAX's (the largest error found: 4.2e-07)
or, for the CoCa JAX does not build, of the port's unsharded step.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.models import convnext as jconvnext
from cosmos_tpu.models import eva as jeva
from cosmos_tpu.models import fastvit as jfastvit
from cosmos_tpu.models import timm_model as jtimm
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.models.factory import init_model_params
from cosmos_tpu.parallel import tp as jax_tp
from cosmos_tpu.parallel.mesh import DATA_AXIS
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch.models import convnext as pconvnext
from cosmos_tpu_torch.models import eva as peva
from cosmos_tpu_torch.models import fastvit as pfastvit
from cosmos_tpu_torch.models import timm_model as ptimm
from cosmos_tpu_torch.models.convert import (build_name_map,
                                             model_name_map,
                                             state_dict_from_jax_params,
                                             vision_entries)
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.parallel import tp
from test_torch_siglip import jax_model

TOL = dict(rtol=1e-5, atol=1e-5)
# head dim 64: K1 and K2 take the self-attentions
KERNEL_TINY = dict(vision_width=128, vision_head_width=64, text_width=128,
                   text_heads=2)
EVA = dict(name="eva02_tp_porttest", patch_size=8, width=48, layers=1,
           heads=2, scale_mlp=True, scale_attn=True, image_size=16)
EVA_MODEL = dict(vision_timm_model_name=EVA["name"], vision_timm_pool="token",
                 vision_timm_proj="linear", vision_image_size=16,
                 text_width=128, text_heads=2)
for _m in (jeva, peva):
    _m.register_eva(**EVA)
for _m in (jconvnext, pconvnext):
    _m.register_convnext("convnext_tp_porttest", depths=(1, 1, 2, 1),
                         dims=(8, 16, 32, 64))
for _m in (jfastvit, pfastvit):
    _m.register_fastvit("fastvit_tp_porttest", layers=(1, 1, 2, 1),
                        dims=(8, 16, 32, 64))
for _m in (jtimm, ptimm):
    _m.register_timm_vit("vit_tp_porttest", patch_size=8, width=128,
                         layers=1, heads=2, image_size=32)
TOWERS = {
    "native": ("ViT-B-16", dict(R.TINY, **R.COSMOS)),
    "vit": ("MobileCLIP-B", dict(vision_timm_model_name="vit_tp_porttest",
                                 vision_image_size=32, vision_timm_proj="mlp",
                                 vision_timm_proj_bias=True)),
    "eva": ("ViT-Tiny-Test", EVA_MODEL),
    "convnext": ("convnext_base_w", dict(
        vision_timm_model_name="convnext_tp_porttest", vision_image_size=64)),
    "fastvit": ("MobileCLIP-S1", dict(
        vision_timm_model_name="fastvit_tp_porttest", vision_image_size=64)),
    "coca": ("coca_Tiny-Test", {}),
    "siglip": ("ViT-B-16", dict(R.TINY, **R.SIGLIP_TOWERS)),
    "hf_bert": ("ViT-B-16", H.model_kw("bert")),
    "hf_t5": ("ViT-B-16", H.model_kw("t5")),
}
# the HF towers' sharded steps and encoders: the vision tower at head dim 64
# (K1, K2), the tiny BERT (mean pooling: its pooler takes no gradient) and
# T5, whose SelfAttention q is JAX's one column-parallel leaf of an HF tree
HF_TP = {arch: dict(H.model_kw(arch), vision_width=128, vision_head_width=64,
                    **({"text_hf_pooler_type": "mean_pooler"}
                       if arch == "bert" else {}))
         for arch in ("bert", "t5")}
# the port's sharded modes of an HF tower: (kind, mesh shape)
HF_MODES = {"tp": ("tp", (2, 2)), "fsdp": ("fsdp", ()),
            "fsdp_tp": ("fsdp_tp", (2, 2))}
# the SigLIP towers at head dim 64 (K1, K2), the embedding at the ViT's
# width (no projection), stepped as plain CLIP: JAX's GSPMD step refuses
# the SigLIP loss
SIGLIP_TP = dict(KERNEL_TINY, embed_dim=128, **R.SIGLIP_TOWERS)


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _cfg(lr, mode="cosmos"):
    return jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                     lr_schedule=lr, log_grad_norm=True,
                                     **R.STEP_MODES[mode][1])


def jax_coca():
    """JAX's coca_Tiny-Test and parameters drawn with numpy at the shapes
    ``jax.eval_shape`` gives (no JAX init is compiled)."""
    jm, _ = jax_create_model("coca_Tiny-Test", init_params=False,
                             use_flash=False)
    rng = np.random.default_rng(1)
    jp = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.3).astype(np.float32),
        jax.eval_shape(lambda: init_model_params(jm)))
    return jm, jp


def _jax_tp_step(jm, jp, batch, mesh, mode="cosmos"):
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    state = jax_train.create_train_state_gspmd(
        jax.tree_util.tree_map(np.array, jp), opt, mesh)
    step = jax_train.make_train_step_gspmd(jm, opt, mesh, _cfg(lr, mode))
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS))),
        batch)
    state, metrics = H.run_jax(step, state, sharded)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params), "teacher": _sd(state.teacher_params)}


def _jax_encoders(jm, jp, shape, images, texts):
    mesh = jax_tp.create_tp_mesh(*shape, jax.devices()[:shape[0] * shape[1]])
    sharded, enc_image, enc_text = jax_tp.make_tp_encoders(jm, jp, mesh)
    out = {"text": np.asarray(enc_text(sharded, texts))}
    if images is not None:
        out["image"] = np.asarray(enc_image(sharded, images))
    return out


def _jax_fsdp_tp_step(jm, jp, batch, mesh):
    """JAX's plain-CLIP GSPMD step under its FSDP x TP placement
    (``create_train_state_fsdp`` on the (data, model) mesh): the function
    every sharded mode of the port computes."""
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    state = jax_train.create_train_state_fsdp(
        jax.tree_util.tree_map(np.array, jp), opt, mesh, min_size=256)
    step = jax_train.make_train_step_gspmd(jm, opt, mesh, _cfg(lr, "clip"))
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS))),
        batch)
    state, metrics = H.run_jax(step, state, sharded)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params), "teacher": _sd(state.teacher_params)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(0)
    # 5 images and 7 captions: no data axis of 2 or 4 divides them
    images = rng.standard_normal((5, 16, 16, 3)).astype(np.float32)
    texts = rng.integers(1, 127, (7, 12)).astype(np.int32)
    native = dict(R.TINY, **KERNEL_TINY)
    encoders = {
        "enc_2x2": ("ViT-B-16", native, (2, 2), None),
        "enc_4x1": ("ViT-B-16", native, (4, 1), None),
        "enc_eva_2x2": ("ViT-Tiny-Test", EVA_MODEL, (2, 2), EVA)}
    models, payload = {}, {}
    for case, (name, kw, shape, eva) in encoders.items():
        # the (4, 1) mesh's model is the (2, 2) one's: one JAX init
        models[case] = (models["enc_2x2"] if case == "enc_4x1"
                        else H.jax_create_fast(name, seed=1, **kw))
        payload[case] = ("tp_encoders", dict(
            init=_sd(models[case][1]), images=images,
            texts=texts.astype(np.int64), shape=shape, name=name,
            model_kw=kw, eva=eva))
    jm, jp = H.jax_create_fast("ViT-B-16", seed=1, **native, **R.COSMOS)
    # JAX's K5/K6 in interpret mode; its attention on the XLA path, the
    # same function as its kernel's, which compiles faster
    jm_fuse, _ = jax_create_model("ViT-B-16", init_params=False,
                                  fuse_ln=True, use_flash=False, **native,
                                  **R.COSMOS)
    jm_coca, jp_coca = jax_coca()
    jm_siglip, jp_siglip = jax_model(dict(R.TINY, **SIGLIP_TP))
    batch = R.step_batch(4, 1)
    # padded captions in the first data rank's rows only: its caption
    # cross-entropy averages fewer tokens than the second's
    coca_batch = R.coca_step_batch(4)
    data = str(tmp_path_factory.mktemp("tp_trainer"))
    R.write_trainer_data(data)
    # an epoch tensor parallel, then resumed under FSDP x TP
    # (2 data ranks of 2 rows: 8 samples make the 2 steps of an epoch)
    tp_argv = ("--mesh-shape", "2,2", "--train-num-samples", "8")
    payload["trainer"] = ("trainer_runs", dict(argvs=[
        R.trainer_argv(data, "tp", *tp_argv, "--epochs", "1"),
        R.trainer_argv(data, "tp", *tp_argv, "--fsdp", "--epochs", "2",
                       "--resume", "latest")]))
    # CoCa: an epoch under FSDP (4 data ranks of 2 rows), then resumed
    # tensor parallel on (2, 2)
    payload["coca_trainer"] = ("trainer_runs", dict(
        config=R.coca_trainer_config(), argvs=[
            R.coca_trainer_argv(data, "coca", "--fsdp",
                                "--train-num-samples", "16", "--epochs", "1"),
            R.coca_trainer_argv(data, "coca", *tp_argv, "--epochs", "2",
                                "--resume", "latest")]))
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    step = dict(init=_sd(jp), batch=batch, model_kw=KERNEL_TINY)
    # every leaf moved off its init (whose biases are zeros), so that a
    # bias added on every rank of the model group shows
    noise = np.random.default_rng(2)
    jp_fuse = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + np.float32(0.05) * noise.standard_normal(
            np.shape(x)).astype(np.float32), jp)
    fuse = dict(step, init=_sd(jp_fuse), kind="tp", shape=(2, 2),
                model_kw=dict(KERNEL_TINY, fuse_ln=True))
    unequal = R.unequal_coca()
    with R.registered(unequal):
        unequal_init = R.perturbed(create_model(
            unequal[0], device="cpu", seed=1).state_dict())
    coca = dict(kind="tp", shape=(2, 2), batch=coca_batch, mode="coca")
    coca_init = _sd(jp_coca)
    coca_images = rng.standard_normal((5, 32, 32, 3)).astype(np.float32)
    payload.update({
        "enc_coca_2x2": ("tp_encoders", dict(
            init=coca_init, images=coca_images, texts=texts.astype(np.int64),
            shape=(2, 2), name="coca_Tiny-Test", model_kw={})),
        "dp_fuse_ln": ("sharded_step", dict(fuse, kind="dp", shape=())),
        "dp": ("sharded_step", dict(step, kind="dp", save=ckpt)),
        "tp": ("sharded_step", dict(step, kind="tp", shape=(2, 2))),
        "tp_fused_ln": ("sharded_step", dict(step, kind="tp", shape=(2, 2),
                                             fused_ln=True)),
        "tp_fuse_ln": ("sharded_step", fuse),
        "tp_fuse_ln_fused_ln": ("sharded_step", dict(fuse, fused_ln=True)),
        "tp_coca": ("sharded_step", dict(coca, init=coca_init)),
        "tp_siglip": ("sharded_step", dict(
            kind="tp", shape=(2, 2), init=_sd(jp_siglip), batch=batch,
            mode="clip", model_kw=SIGLIP_TP)),
        "tp_coca_unequal": ("sharded_step", dict(
            coca, init=unequal_init, config=unequal)),
        "resume_tp": ("resumed", dict(kind="tp", shape=(2, 2),
                                      path=f"{ckpt}/epoch_1.pt",
                                      model_kw=KERNEL_TINY)),
    })
    # the HF towers: each sharded mode's step on padded captions, the TP
    # encoders; then an HF trainer under --fsdp and --lock-text, resumed
    # under FSDP x TP
    hf = {arch: H.jax_model(kw, seed=3) for arch, kw in HF_TP.items()}
    hf_batch = {arch: H.step_batch(arch) for arch in hf}
    hf_texts = {arch: H.tokens(arch, n=7, seed=4) for arch in hf}
    for arch, (jm_hf, jp_hf) in hf.items():
        for mode, (kind, shape) in HF_MODES.items():
            payload[f"hf_{mode}_{arch}"] = ("sharded_step", dict(
                kind=kind, shape=shape, init=_sd(jp_hf), batch=hf_batch[arch],
                mode="clip", model_kw=HF_TP[arch]))
        payload[f"enc_hf_{arch}"] = ("tp_encoders", dict(
            init=_sd(jp_hf), images=images, texts=hf_texts[arch].astype(
                np.int64), shape=(2, 2), name="ViT-B-16",
            model_kw=HF_TP[arch]))
    lock = ("--lock-text", "--lock-text-unlocked-layers", "1")
    hf_model = R.hf_trainer_config()
    payload["hf_trainer"] = ("trainer_runs", dict(config=hf_model, argvs=[
        R.coca_trainer_argv(data, "hf", "--fsdp", "--train-num-samples",
                            "16", "--epochs", "1", *lock, model=hf_model[0]),
        R.coca_trainer_argv(data, "hf", *tp_argv, "--fsdp", "--epochs", "2",
                            "--resume", "latest", *lock,
                            model=hf_model[0])]))
    ranks = R.start(R.beyond_rank, 4, payload)
    mesh = jax_tp.create_tp_mesh(2, 2, jax.devices()[:4])
    want = {case: _jax_encoders(*models[case], encoders[case][2],
                                jnp.asarray(images), jnp.asarray(texts))
            for case in encoders}
    for arch, (jm_hf, jp_hf) in hf.items():
        want[f"hf_{arch}"] = _jax_fsdp_tp_step(jm_hf, jp_hf, hf_batch[arch],
                                               mesh)
        want[f"enc_hf_{arch}"] = _jax_encoders(jm_hf, jp_hf, (2, 2), None,
                                               jnp.asarray(hf_texts[arch]))
    want["tp"] = _jax_tp_step(jm, jp, batch, mesh)
    want["tp_fuse_ln"] = _jax_tp_step(jm_fuse, jp_fuse, batch, mesh)
    want["tp_coca"] = _jax_tp_step(jm_coca, jp_coca, coca_batch, mesh,
                                   "coca")
    want["tp_siglip"] = _jax_tp_step(jm_siglip, jp_siglip, batch, mesh,
                                     "clip")
    with R.registered(unequal):
        want["tp_coca_unequal"] = R.port_step("coca", unequal_init,
                                              coca_batch, config=unequal)
    want["enc_coca_2x2"] = _port_coca_features(coca_init, coca_images, texts)
    ranks = ranks()
    saved = torch.load(f"{ckpt}/epoch_1.pt", map_location="cpu",
                       weights_only=True)
    return {"want": want, "ranks": ranks, "saved": saved}


def _port_coca_features(init, images, texts):
    """The unsharded port CoCa's normalised features (JAX's
    ``make_tp_encoders`` indexes CoCa's bare features as a dict and
    fails)."""
    model = create_model("coca_Tiny-Test", device="cpu").eval()
    model.load_state_dict(init, strict=True)
    with torch.no_grad():
        return {"image": model.encode_image(torch.from_numpy(images)).numpy(),
                "text": model.encode_text(torch.from_numpy(
                    texts.astype(np.int64))).numpy()}




def _close(got, want, what):
    assert set(got) == set(want), what
    for n, w in want.items():
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(got[n]), w, rtol=TOL["rtol"],
            atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
            err_msg=f"{what} {n}")


# --- placement ----------------------------------------------------------

def _torch_dim(d, tf):
    if d is None or tf is None:
        return d
    return {"t": lambda: 1 - d, "conv": lambda: (2, 3, 1, 0)[d]}[tf]()


def _jax_param_shapes(name, kw):
    """JAX's parameter tree of a model as zeros, from its shapes alone (a
    COSMOS model's poolers take part only in its full forward, which
    ``H.jax_model`` traces)."""
    if kw.get("cosmos"):
        return jax.tree_util.tree_map(np.zeros_like, H.jax_model(kw)[1])
    if name.startswith("coca"):
        return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                      jax_coca()[1])
    jm, _ = jax_create_model(name, init_params=False, **kw)
    size = jm.cfg.vision_cfg.image_size
    shapes = jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1, jm.cfg.text_cfg.context_length), jnp.int32))
    return jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                  shapes["params"])


@pytest.mark.parametrize("tower", sorted(TOWERS))
def test_tp_spec_equals_jax_leaf_for_leaf(tower):
    name, kw = TOWERS[tower]
    jp = _jax_param_shapes(name, kw)
    model = create_model(name, device="meta", **kw)
    if tower == "coca" or tower.startswith("hf_"):
        entries = model_name_map(model)
    else:
        layers = {"visual": len(getattr(getattr(
            model.visual, "transformer", None), "resblocks", ())),
            "text": len(model.transformer.resblocks)}
        entries = build_name_map(layers["visual"], layers["text"]) \
            + vision_entries(jp["visual"])
    got = tp.tp_param_placements(model)
    seen = set()
    for key, path, tf in entries:
        node = jp
        try:
            for p in path:
                node = node[p]
        except KeyError:
            continue
        leaf = np.asarray(node)
        spec = jax_tp.tp_spec([jax.tree_util.DictKey(p) for p in path], leaf)
        d = next((i for i, ax in enumerate(spec) if ax == jax_tp.MODEL_AXIS),
                 None)
        assert got[key] == _torch_dim(d, tf), (key, spec)
        seen.add(key)
    assert seen == set(got)
    # the trunk's Megatron layers are sharded, as JAX's are
    if tower == "eva":
        blk = "visual.trunk.blocks.0."
        assert [got[blk + n] for n in (
            "attn.q_proj.weight", "attn.k_proj.weight", "attn.v_proj.weight",
            "attn.proj.weight", "mlp.fc1_g.weight", "mlp.fc1_x.weight",
            "mlp.fc2.weight", "mlp.fc2.bias", "mlp.norm.weight")] == [
            0, 0, 0, 1, 0, 0, 1, None, None]
    # an HF tower's one Megatron leaf: T5's SelfAttention q, by its parent
    # name; BERT's query/key/value/dense and the head stay whole
    if tower.startswith("hf_"):
        text = {k: v for k, v in got.items() if k.startswith("text.")}
        q = [k for k in text if k.endswith("SelfAttention.q.weight")]
        assert {k: v for k, v in text.items() if v is not None} == \
            dict.fromkeys(q, 0)
        assert len(q) == (2 if tower == "hf_t5" else 0)
    # the decoder's cross-attention and the pooler, as JAX places them
    if tower == "coca":
        assert [got[n] for n in (
            "text_decoder.cross_attn.0.attn.in_proj_weight",
            "text_decoder.cross_attn.0.attn.out_proj.weight",
            "attn_pool.attn.in_proj_bias", "attn_pool.query",
            "text_decoder.text_projection")] == [0, 1, 0, None, None]


def test_separate_qkv_and_their_bias_are_column_parallel():
    """A pooler whose keys are wider than its queries: its separate
    q/k/v weights ``Shard(0)`` (JAX's rule for q_proj/k_proj/v_proj
    kernels), the packed ``in_proj_bias`` ``Shard(0)`` over its 3D."""
    model = create_model("coca_ViT-B-32", device="meta")
    got = tp.tp_param_placements(model)
    pool = "attn_pool.attn."
    assert model.attn_pool.attn.in_proj_weight is None
    assert [got[pool + n] for n in ("q_proj_weight", "k_proj_weight",
                                    "v_proj_weight", "in_proj_bias",
                                    "out_proj.weight", "out_proj.bias")] \
        == [0, 0, 0, 0, 1, None]


def test_gspmd_step_refusals_are_jax_s():
    from cosmos_tpu_torch.training import train as T

    model = types.SimpleNamespace(modules=lambda: [])
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    for kw in (dict(siglip=True, cosmos=False), dict(local_loss=True),
               dict(accum_freq=2)):
        with pytest.raises(ValueError) as want:
            jax_train.make_train_step_gspmd(None, None, None,
                                            jax_train.TrainStepConfig(**kw))
        with pytest.raises(ValueError) as got:
            T.make_train_step_gspmd(model, None, mesh, T.TrainStepConfig(**kw))
        assert str(got.value) == str(want.value)


def test_fuse_ln_under_tp_builds_the_gspmd_step(runs):
    # every rank built make_train_step_gspmd over the (2, 2) mesh with
    # fuse_ln and stepped through K5 and K6
    for rank in runs["ranks"]:
        for case in ("tp_fuse_ln", "tp_fuse_ln_fused_ln"):
            got = rank[case]
            assert got["calls"]["K5"] > 0 and got["calls"]["K6"] > 0
            assert np.isfinite(got["metrics"]["loss"])


# --- the encoders and the step -------------------------------------------

@pytest.mark.parametrize("tower", ["image", "text"])
@pytest.mark.parametrize("case", ["enc_2x2", "enc_4x1", "enc_eva_2x2"])
def test_tp_encoders_equal_jax(runs, case, tower):
    want = runs["want"][case][tower]
    for rank in runs["ranks"]:
        got = rank[case][tower].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_k1_runs_every_self_attention_under_tp(runs):
    for rank in runs["ranks"]:
        # one vision and one text block; EVA02's trunk attends on stock
        # ops, as JAX's does, and the 2 text blocks on K1
        assert (rank["enc_2x2"]["k1_image"], rank["enc_2x2"]["k1_text"]) \
            == (1, 1)
        assert (rank["enc_eva_2x2"]["k1_image"],
                rank["enc_eva_2x2"]["k1_text"]) == (0, 2)
        calls = rank["tp"]["calls"]
        assert calls == rank["dp"]["calls"] and calls["K1"] > 0 \
            and calls["K2"] > 0


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_tp_step_equals_jax(runs, part):
    # the whole state is gathered to rank 0
    _close(runs["ranks"][0]["tp"][part], runs["want"]["tp"][part],
           f"tp {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_fused_ln_under_tp_equals_the_tp_step(runs, part):
    r0 = runs["ranks"][0]
    _close(r0["tp_fused_ln"][part], r0["tp"][part], f"FUSED_LN {part}")


def test_tp_state_is_model_sharded(runs):
    # params, teacher and moments: the Megatron layers split over 2
    for rank in runs["ranks"]:
        assert rank["tp"]["bytes"] < 0.8 * rank["dp"]["bytes"]
        assert rank["tp"]["metrics"] == runs["ranks"][0]["tp"]["metrics"]


def test_dp_checkpoint_resumes_tensor_parallel(runs):
    saved = runs["saved"]
    res = runs["ranks"][0]["resume_tp"]
    assert (res["epoch"], res["step"], res["num_updates"]) == (1, 1, 1)
    for which in ("student", "teacher"):
        assert res[which].keys() == saved[which].keys()
        for n, t in saved[which].items():
            assert torch.equal(res[which][n], t), (which, n)
    assert res["optimizer"]["param_groups"] == saved["optimizer"][
        "param_groups"]
    for i, st in saved["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(res["optimizer"]["state"][i][k], v), (i, k)


def test_trainer_runs_tensor_parallel_and_resumes_under_fsdp(runs):
    ranks = [r["trainer"] for r in runs["ranks"]]
    for r in ranks:
        assert r["epochs"] == [[0], [1]]
        assert r["losses"] == ranks[0]["losses"]
        assert [len(x) for x in r["losses"]] == [2, 2]
        assert np.all(np.isfinite(sum(r["losses"], [])))
    # rank 0 evaluates the gathered state; the others wait
    assert all(np.isfinite(v) for v in ranks[0]["val_loss"])
    assert all(r["val_loss"] == [None, None] for r in ranks[1:])


# --- fuse_ln (K5, K6) and CoCa under tensor parallelism ------------------

@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
@pytest.mark.parametrize("case", ["tp_fuse_ln", "tp_fuse_ln_fused_ln"])
def test_fuse_ln_under_tp_equals_jax(runs, case, part):
    # FUSED_LN moves the other LayerNorms onto K3's plain version: JAX's
    # fuse_ln step without it is the reference of both
    _close(runs["ranks"][0][case][part], runs["want"]["tp_fuse_ln"][part],
           f"{case} {part}")


def test_k5_k6_run_on_each_rank_s_local_shard(runs):
    # every K5 and K6 call of the unsharded fuse_ln step, on every rank,
    # each given the rank's column shard (3D / 2) or hidden shard (4D / 2)
    # and never a whole weight
    width = KERNEL_TINY["vision_width"]
    assert width == KERNEL_TINY["text_width"]
    for rank in runs["ranks"]:
        whole = rank["dp_fuse_ln"]["calls"]
        assert set(whole["K5_widths"]) == {3 * width}
        for case in ("tp_fuse_ln", "tp_fuse_ln_fused_ln"):
            calls = rank[case]["calls"]
            assert all(calls[k] == whole[k] for k in ("K1", "K2", "K5", "K6"))
            assert set(calls["K5_widths"]) == {3 * width // 2}
            assert set(calls["K6_widths"]) == {4 * width // 2}


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_tp_coca_step_equals_jax(runs, part):
    _close(runs["ranks"][0]["tp_coca"][part], runs["want"]["tp_coca"][part],
           f"tp coca {part}")


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_tp_coca_of_unequal_widths_equals_its_unsharded_step(runs, part):
    r0 = runs["ranks"][0]["tp_coca_unequal"]
    _close(r0[part], runs["want"]["tp_coca_unequal"][part],
           f"tp unequal coca {part}")
    # its 128-wide vision tower (head dim 64) takes K1 and K2
    assert r0["calls"]["K1"] > 0 and r0["calls"]["K2"] > 0


@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
def test_tp_siglip_towers_step_equals_jax(runs, part):
    # MAPHead's q, kv and c_fc column-parallel, out and c_proj row-parallel
    r0 = runs["ranks"][0]["tp_siglip"]
    _close(r0[part], runs["want"]["tp_siglip"][part], f"tp siglip {part}")
    assert r0["calls"]["K1"] > 0 and r0["calls"]["K2"] > 0


@pytest.mark.parametrize("tower", ["image", "text"])
def test_tp_encoders_take_coca_s_bare_features(runs, tower):
    want = runs["want"]["enc_coca_2x2"][tower]
    for rank in runs["ranks"]:
        got = rank["enc_coca_2x2"][tower].numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_coca_trainer_runs_fsdp_then_resumes_tensor_parallel(runs):
    ranks = [r["coca_trainer"] for r in runs["ranks"]]
    for r in ranks:
        assert r["epochs"] == [[0], [1]]
        assert r["losses"] == ranks[0]["losses"]
        assert [len(x) for x in r["losses"]] == [2, 2]
        for line in sum(r["logged"], []):
            # the CoCa step's two losses
            assert np.isfinite(line["loss"])
            assert line["loss"] == pytest.approx(
                line["contrastive_loss"] + line["caption_loss"], rel=1e-6)
    assert all(np.isfinite(v) for v in ranks[0]["val_loss"])
    assert all(r["val_loss"] == [None, None] for r in ranks[1:])


# --- HF text towers --------------------------------------------------------

@pytest.mark.parametrize("part", ["metrics", "student", "teacher"])
@pytest.mark.parametrize("mode", sorted(HF_MODES))
@pytest.mark.parametrize("arch", sorted(HF_TP))
def test_hf_tower_sharded_steps_equal_jax(runs, arch, mode, part):
    _close(runs["ranks"][0][f"hf_{mode}_{arch}"][part],
           runs["want"][f"hf_{arch}"][part], f"hf {mode} {arch} {part}")


@pytest.mark.parametrize("arch", sorted(HF_TP))
def test_hf_tower_steps_run_k1_k2_and_shard_t5_s_q(runs, arch):
    q = [f"text.transformer.encoder.block.{i}.layer.0.SelfAttention.q.weight"
         for i in range(2)] if arch == "t5" else []
    for rank in runs["ranks"]:
        for mode in HF_MODES:
            got = rank[f"hf_{mode}_{arch}"]
            assert got["calls"]["K1"] > 0 and got["calls"]["K2"] > 0
            assert got["metrics"] == rank[f"hf_fsdp_{arch}"]["metrics"] \
                or mode != "fsdp"
            text = [n for n in got["model_sharded"] if n.startswith("text.")]
            assert text == ([] if mode == "fsdp" else q), mode


@pytest.mark.parametrize("arch", sorted(HF_TP))
def test_hf_tp_encoders_equal_jax(runs, arch):
    want = runs["want"][f"enc_hf_{arch}"]["text"]
    for rank in runs["ranks"]:
        got = rank[f"enc_hf_{arch}"]
        assert got["text"].shape == want.shape
        np.testing.assert_allclose(got["text"].numpy(), want, **TOL)
        # K1 takes the vision block; the HF tower attends on stock ops
        assert (got["k1_image"], got["k1_text"]) == (1, 0)


def test_hf_trainer_locks_text_under_fsdp_and_resumes_under_fsdp_tp(runs):
    ranks = [r["hf_trainer"] for r in runs["ranks"]]
    for r in ranks:
        assert r["epochs"] == [[0], [1]]
        assert r["losses"] == ranks[0]["losses"]
        assert [len(x) for x in r["losses"]] == [2, 2]
        assert np.all(np.isfinite(sum(r["losses"], [])))
    assert all(np.isfinite(v) for v in ranks[0]["val_loss"])
    assert all(r["val_loss"] == [None, None] for r in ranks[1:])
