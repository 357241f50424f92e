"""The port's local HF export (cosmos_tpu_torch/models/push_to_hf_hub.py,
the msgpack writer of models/msgpack.py) against cosmos_tpu's, and one
``--siglip`` step on an HF tower, on the CPU:

  - ``save_for_hf`` of a tiny COSMOS ViT-B-16: JAX's ``load_checkpoint``
    reads the ``.bin`` and flax's ``from_bytes`` the ``.msgpack`` to the
    source parameters, bit for bit; ``open_clip_config.json`` is the text
    JAX's ``save_config_for_hf`` writes; ``generate_readme`` is JAX's;
  - ``save_for_hf`` of an HF-tower model raises, as JAX's does, and so
    does one of a timm-family tower;
  - ``save_for_hf`` of a tiny ModifiedResNet CLIP writes JAX's ``.bin``
    (``params_to_torch_state_dict``'s keys, values and dtypes), JAX's
    ``.msgpack`` bytes and JAX's config;
  - one ``--siglip`` step on a BERT tower (its own ``cls_pooler``) against
    JAX's ``make_train_step``: metrics, student and teacher within 1e-5.
"""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

import torch_dp_ranks as R
import torch_hf_cases as H
from cosmos_tpu.models import checkpoint as jckpt
from cosmos_tpu.models import push_to_hf_hub as jhub
from cosmos_tpu.models.factory import get_model_preprocess_cfg
from cosmos_tpu.parallel.mesh import create_mesh, shard_batch
from cosmos_tpu.training import scheduler as jax_sched
from cosmos_tpu.training import train as jax_train
from cosmos_tpu_torch import (create_optimizer, create_train_state,
                              generate_readme, make_train_step, save_for_hf)
from cosmos_tpu_torch.models import checkpoint as pckpt
from cosmos_tpu_torch.models.msgpack import read_msgpack
from cosmos_tpu_torch.models.push_to_hf_hub import (HF_CONFIG_NAME,
                                                    HF_FLAX_WEIGHTS_NAME,
                                                    HF_WEIGHTS_NAME,
                                                    save_config_for_hf)
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import TrainStepConfig

NATIVE = dict(R.TINY, **R.COSMOS)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    jm, jp = H.jax_model(NATIVE, seed=4)
    model = H.port_model(NATIVE, H.to_port(jp))
    out = tmp_path_factory.mktemp("hf_export")
    save_for_hf(model, str(out))
    return jm, jp, model, out


def _same_tree(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, a), (_, b) in zip(flat_got, flat_want):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_jax_reads_the_bin_and_the_msgpack(exported):
    jm, jp, _, out = exported
    template = jax.tree_util.tree_map(np.zeros_like, jp)
    _same_tree(jckpt.load_checkpoint(jm, template, str(out / HF_WEIGHTS_NAME),
                                     strict=True), jp)
    with open(out / HF_FLAX_WEIGHTS_NAME, "rb") as f:
        _same_tree(serialization.from_bytes(template, f.read()), jp)
    # the flax bytes are the bytes flax writes for the same tree
    with open(out / HF_FLAX_WEIGHTS_NAME, "rb") as f:
        assert f.read() == serialization.to_bytes(
            jax.tree_util.tree_map(np.asarray, jp))


def test_the_port_reads_its_export_back(exported):
    _, jp, model, out = exported
    want = model.state_dict()
    for name in (HF_WEIGHTS_NAME, HF_FLAX_WEIGHTS_NAME):
        back = pckpt.load_checkpoint(H.port_model(NATIVE), str(out / name),
                                     strict=True).state_dict()
        assert set(back) == set(want)
        for k, v in want.items():
            assert torch.equal(back[k], v), (name, k)
    _same_tree(read_msgpack(str(out / HF_FLAX_WEIGHTS_NAME)),
               jax.tree_util.tree_map(np.asarray, jp))


def test_config_json_is_jax_s(exported, tmp_path):
    jm, _, model, out = exported
    jhub.save_config_for_hf(jm, str(tmp_path / "jax.json"),
                            preprocess_cfg=get_model_preprocess_cfg(jm))
    assert (out / HF_CONFIG_NAME).read_text() == \
        (tmp_path / "jax.json").read_text()


@pytest.mark.parametrize("preprocess", [None, {"size": 16, "mean": [0.5]}])
def test_config_of_an_hf_tower_is_jax_s(tmp_path, preprocess):
    """The HF fields, ``hf_model_config`` left out, as JAX leaves it out."""
    kw = H.model_kw("roberta", text_hf_proj_type="linear")
    jm = H.jax_module(kw)
    save_config_for_hf(H.port_model(kw), str(tmp_path / "p.json"),
                       preprocess)
    jhub.save_config_for_hf(jm, str(tmp_path / "j.json"), preprocess)
    got = (tmp_path / "p.json").read_text()
    assert got == (tmp_path / "j.json").read_text()
    assert '"hf_proj_type": "linear"' in got
    assert "hf_model_config" not in got


@pytest.mark.parametrize("card", [
    {}, {"description": "a tiny model"},
    {"description": "d", "sections": {"Training": "CC3M", "Notes": 3}},
])
def test_readme_is_jax_s(card):
    assert generate_readme(card, "tiny") == jhub.generate_readme(card, "tiny")


def test_hf_tower_export_raises_in_both(tmp_path):
    kw = H.model_kw("bert")
    jm, jp = H.jax_model(kw)
    with pytest.raises(KeyError):
        jhub.save_for_hf(jm, jp, str(tmp_path / "jax"))
    with pytest.raises(NotImplementedError, match="HF text tower"):
        save_for_hf(H.port_model(kw), str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()


def test_siglip_step_equals_jax():
    kw = H.model_kw("bert", **R.SIGLIP)
    jm, jp = H.jax_model(kw, seed=6)
    batch = R.step_batch(4, 1)
    batch = {"global_images": batch["global_images"][:1],
             "texts": np.stack([H.tokens("bert", n=4, seed=7)])}
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    cosmos=False, siglip=True)
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
                           log_grad_norm=True, cosmos=False, siglip=True)
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


# a ModifiedResNet CLIP by overrides: four stages of one block, width 8
RESNET = dict(R.TINY, vision_layers=[1, 1, 1, 1], vision_width=8,
              vision_image_size=64)


@pytest.fixture(scope="module")
def resnet_export(tmp_path_factory):
    jm, jp = H.jax_model(RESNET, seed=5)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    out = tmp_path_factory.mktemp("resnet_export")
    save_for_hf(H.port_model(RESNET, H.to_port(jp)), str(out / "port"))
    jhub.save_for_hf(jm, jp, str(out / "jax"))
    return out


def test_resnet_bin_is_jax_s(resnet_export):
    got = torch.load(resnet_export / "port" / HF_WEIGHTS_NAME,
                     weights_only=True)
    want = torch.load(resnet_export / "jax" / HF_WEIGHTS_NAME,
                      weights_only=True)
    assert set(got) == set(want)
    assert any(k.endswith("running_var") for k in want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("name", [HF_FLAX_WEIGHTS_NAME, HF_CONFIG_NAME])
def test_resnet_msgpack_and_config_are_jax_s_bytes(resnet_export, name):
    got = (resnet_export / "port" / name).read_bytes()
    assert got == (resnet_export / "jax" / name).read_bytes()


def test_timm_tower_export_raises_in_both(tmp_path):
    """JAX's ``params_to_torch_state_dict`` reads the ViT's
    ``visual/transformer``, which a timm-family tree lacks."""
    from cosmos_tpu.models import convnext as jconvnext
    from cosmos_tpu_torch.models import convnext as pconvnext

    for m in (jconvnext, pconvnext):
        m.register_convnext("convnext_export_porttest", depths=(1, 1, 1, 1),
                            dims=(8, 16, 32, 64))
    kw = dict(R.TINY, vision_timm_model_name="convnext_export_porttest",
              vision_image_size=64)
    jm, jp = H.jax_model(kw)
    with pytest.raises(KeyError, match="transformer"):
        jhub.save_for_hf(jm, jp, str(tmp_path / "jax"))
    with pytest.raises(NotImplementedError, match="timm-family"):
        save_for_hf(H.port_model(kw), str(tmp_path / "port"))
    assert not (tmp_path / "port").exists()
