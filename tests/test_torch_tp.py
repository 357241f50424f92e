"""The port's tensor parallelism (``cosmos_tpu_torch/parallel/tp.py``, DTensor
placement over the 'model' axis, K1/K2's batch-only sharding rule) against
cosmos_tpu's ``parallel/tp.py`` and GSPMD step, on gloo ranks of the CPU
(tests/torch_dp_ranks.py).

With no process: the placements equal JAX's ``tp_spec`` leaf for leaf for
the native towers and the timm ViT, EVA02, ConvNeXt and FastViT trunks, and
``make_train_step_gspmd`` refuses what JAX's refuses, with its messages.
One spawn of 4 ranks runs the TP encoders on (2, 2) and (4, 1) meshes for
a batch no data axis divides (and EVA02's trunk on (2, 2)), the TP train
step on (2, 2) through K1 and K2 (head dim 64, so the kernels' CPU
versions run; the test counts their calls), the same step under
``FUSED_LN``, and a data-parallel step whose checkpoint a TP state resumes.
The features, the loss and the updated student and teacher lie within
``rtol=1e-5, atol=1e-5`` of JAX's (the largest error found: 4.2e-07).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_dp_ranks as R
from cosmos_tpu.models import convnext as jconvnext
from cosmos_tpu.models import eva as jeva
from cosmos_tpu.models import fastvit as jfastvit
from cosmos_tpu.models import timm_model as jtimm
from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu.parallel import tp as jax_tp
from cosmos_tpu.parallel.mesh import DATA_AXIS
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch.models import convnext as pconvnext
from cosmos_tpu_torch.models import eva as peva
from cosmos_tpu_torch.models import fastvit as pfastvit
from cosmos_tpu_torch.models import timm_model as ptimm
from cosmos_tpu_torch.models.convert import (build_name_map,
                                             state_dict_from_jax_params,
                                             vision_entries)
from cosmos_tpu_torch.models.factory import create_model
from cosmos_tpu_torch.parallel import tp

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
}


def _sd(tree):
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def _cfg(lr, **kw):
    return jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                     lr_schedule=lr, log_grad_norm=True,
                                     cosmos=True, **kw)


def _jax_tp_step(jm, jp, batch, mesh):
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    state = jax_train.create_train_state_gspmd(
        jax.tree_util.tree_map(np.array, jp), opt, mesh)
    step = jax_train.make_train_step_gspmd(jm, opt, mesh, _cfg(lr))
    sharded = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, NamedSharding(mesh, P(None, DATA_AXIS))),
        batch)
    state, metrics = step(state, sharded)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": _sd(state.params), "teacher": _sd(state.teacher_params)}


def _jax_encoders(jm, jp, shape, images, texts):
    mesh = jax_tp.create_tp_mesh(*shape, jax.devices()[:shape[0] * shape[1]])
    sharded, enc_image, enc_text = jax_tp.make_tp_encoders(jm, jp, mesh)
    return {"image": np.asarray(enc_image(sharded, images)),
            "text": np.asarray(enc_text(sharded, texts))}


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
        models[case] = jax_create_model(name, seed=1, **kw)
        payload[case] = ("tp_encoders", dict(
            init=_sd(models[case][1]), images=images,
            texts=texts.astype(np.int64), shape=shape, name=name,
            model_kw=kw, eva=eva))
    jm, jp = jax_create_model("ViT-B-16", seed=1, **native, **R.COSMOS)
    batch = R.step_batch(4, 1)
    data = str(tmp_path_factory.mktemp("tp_trainer"))
    R.write_trainer_data(data)
    # an epoch tensor parallel, then resumed under FSDP x TP
    # (2 data ranks of 2 rows: 8 samples make the 2 steps of an epoch)
    tp_argv = ("--mesh-shape", "2,2", "--train-num-samples", "8")
    payload["trainer"] = ("trainer_runs", dict(argvs=[
        R.trainer_argv(data, "tp", *tp_argv, "--epochs", "1"),
        R.trainer_argv(data, "tp", *tp_argv, "--fsdp", "--epochs", "2",
                       "--resume", "latest")]))
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt"))
    step = dict(init=_sd(jp), batch=batch, model_kw=KERNEL_TINY)
    payload.update({
        "dp": ("sharded_step", dict(step, kind="dp", save=ckpt)),
        "tp": ("sharded_step", dict(step, kind="tp", shape=(2, 2))),
        "tp_fused_ln": ("sharded_step", dict(step, kind="tp", shape=(2, 2),
                                             fused_ln=True)),
        "resume_tp": ("resumed", dict(kind="tp", shape=(2, 2),
                                      path=f"{ckpt}/epoch_1.pt",
                                      model_kw=KERNEL_TINY)),
    })
    ranks = R.start(R.beyond_rank, 4, payload)
    want = {case: _jax_encoders(*models[case], encoders[case][2],
                                jnp.asarray(images), jnp.asarray(texts))
            for case in encoders}
    want["tp"] = _jax_tp_step(jm, jp, batch, jax_tp.create_tp_mesh(
        2, 2, jax.devices()[:4]))
    ranks = ranks()
    saved = torch.load(f"{ckpt}/epoch_1.pt", map_location="cpu",
                       weights_only=True)
    return {"want": want, "ranks": ranks, "saved": saved}


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
    COSMOS model's poolers take part only in its full forward: those
    initialise)."""
    if kw.get("cosmos"):
        return jax_create_model(name, use_flash=False, seed=1, **kw)[1]
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
    layers = {"visual": len(getattr(getattr(model.visual, "transformer",
                                            None), "resblocks", ())),
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


def test_fuse_ln_under_tp_is_refused_naming_its_item():
    from cosmos_tpu_torch.training import train as T

    model = create_model("ViT-B-16", device="meta", fuse_ln=True,
                         **R.TINY, **R.COSMOS)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
        T.make_train_step_gspmd(model, None, mesh, T.TrainStepConfig())


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
