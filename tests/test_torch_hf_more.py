"""The HF text towers after the first five (DistilBERT, ELECTRA with and
without ``embeddings_project``, ALBERT with one group and with two groups
of two layers, RoBERTa-PreLayerNorm, DistilBERT with sinusoidal
positions, and causal BERT, RoBERTa and ELECTRA under ``is_decoder``)
against cosmos_tpu's, on the CPU, in float32 within
``torch_hf_cases.TOL``:

  - the config defaults against ``AutoConfig.for_model`` on every field
    the encoders read (ALBERT's are albert-xxlarge's; DistilBERT takes
    BERT's names through its ``attribute_map``), and the default pooler;
  - the parameters are JAX's tree leaf for leaf through the weight bridge;
  - ``encode_text`` under ``mean_pooler`` and ``cls_pooler``, and the
    gradient of a fixed function of the mean-pooled features with respect
    to every text parameter, against JAX's, on the same numpy parameters;
    a causal tower's first state ignores the later tokens;
  - RoBERTa-PreLayerNorm's positions are ``arange``, as JAX's tower gives
    them (the pad-offset positions would change the features);
  - one plain CLIP step (ALBERT with two groups: shared layers) and one
    ``--siglip`` step (RoBERTa-PreLayerNorm under ``cls_pooler``) against
    JAX's jitted step (the other types' steps differ from these only in
    the tower, whose gradients are held to JAX's above);
  - the decay and ``--lock-text`` masks against JAX's, leaf for leaf
    (DistilBERT and ALBERT have no ``encoder.layer``: both raise);
  - the TP and FSDP placements against JAX's ``tp_spec``,
    ``fsdp_spec`` and ``fsdp_tp_spec`` leaf for leaf (none of these
    towers has a Megatron leaf), FSDP's units (DistilBERT's layers,
    ALBERT's layer groups), and the FSDP, TP and FSDP x TP steps of ALBERT
    and DistilBERT on 4 gloo ranks against JAX's step (ALBERT) and the
    port's unsharded step (DistilBERT).

Every JAX function of the file is compiled once, in one program, while
the gloo ranks run.
"""

import jax
import jax.numpy as jnp
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
from cosmos_tpu_torch.models.hf_arch import resolve_hf_config
from cosmos_tpu_torch.models.hf_model import PAD_OFFSET_POSITIONS
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import (TrainStepConfig, frozen_mask,
                                             wd_mask)

CASES = tuple(H.MORE)
# the cases of the full steps, and their modes
STEPS = {"albert-groups": "clip", "roberta-prelayernorm": "siglip"}
# the sharded steps on the gloo ranks: (kind, mesh shape)
SHARDED = {"fsdp": ("fsdp", ()), "tp": ("tp", (2, 2)),
           "fsdp_tp": ("fsdp_tp", (2, 2))}
SHARDED_CASES = ("albert-groups", "distilbert")
_BERT_FIELDS = tuple(f for f in H.BERT_FIELDS if f != "is_encoder_decoder")
FIELDS = {
    "distilbert": ("vocab_size", "max_position_embeddings",
                   "sinusoidal_pos_embds", "n_layers", "n_heads", "dim",
                   "hidden_dim", "activation", "initializer_range",
                   "pad_token_id"),
    "electra": _BERT_FIELDS + ("embedding_size",),
    "albert": ("vocab_size", "embedding_size", "hidden_size",
               "num_hidden_layers", "num_hidden_groups",
               "num_attention_heads", "intermediate_size", "inner_group_num",
               "hidden_act", "max_position_embeddings", "type_vocab_size",
               "initializer_range", "layer_norm_eps", "pad_token_id"),
    "roberta-prelayernorm": _BERT_FIELDS,
}


def _kw(case, **extra):
    """The model of ``case``; the SigLIP step's under ``cls_pooler``."""
    siglip = (dict(R.SIGLIP, text_hf_pooler_type="cls_pooler")
              if STEPS.get(case) == "siglip" else {})
    return H.model_kw(case, **dict(siglip, **extra))


@pytest.mark.parametrize("model_type", sorted(FIELDS))
def test_config_defaults_equal_transformers(model_type):
    from transformers import AutoConfig

    case = next(c for c, d in H.MORE.items()
                if d["model_type"] == model_type)
    variant = ({"hidden_size": 48, "num_attention_heads": 3,
                "num_hidden_layers": 1, "activation": "relu"}
               if model_type == "distilbert" else
               {"layer_norm_eps": 1e-7, "hidden_act": "relu"})
    for d in ({}, H.MORE[case], variant):
        d = {k: v for k, v in d.items() if k != "model_type"}
        want = AutoConfig.for_model(model_type, **d).to_dict()
        got = vars(resolve_hf_config({"model_type": model_type, **d}))
        fields = FIELDS[model_type]
        assert {k: got[k] for k in fields} == {k: want[k] for k in fields}


@pytest.mark.parametrize("case", CASES)
def test_default_pooler_is_jax_s(case):
    from cosmos_tpu.models.hf_configs import arch_dict

    model = create_model("ViT-B-16", device="meta", **H.model_kw(case))
    want = arch_dict.get(H.MORE[case]["model_type"], {}).get(
        "pooler", "mean_pooler")
    assert model.text.pooler_type == want


# --- JAX's side, compiled once -------------------------------------------

def _jax_step(jm, jp, batch, mode):
    lr = jax_sched.const_lr(R.LR, 0, 10)
    opt = jax_train.create_optimizer(lr, beta1=R.BETA1, beta2=0.98,
                                     eps=R.EPS, weight_decay=0.5)
    cfg = jax_train.TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                                    lr_schedule=lr, log_grad_norm=True,
                                    **R.STEP_MODES[mode][1])
    mesh = create_mesh(1)
    return (jax_train.make_train_step(jm, opt, mesh, cfg),
            jax_train.create_train_state(jp, opt, mesh),
            shard_batch(batch, mesh))


# the fixed weights of the gradient's function of the features
WEIGHTS = np.random.default_rng(7).standard_normal(
    (4, H.VISION["embed_dim"])).astype(np.float32)


@pytest.fixture(scope="module")
def runs():
    """The gloo ranks' sharded steps (started first), and JAX's features,
    gradients and steps of every case, from one compiled program."""
    models = {case: H.jax_model(_kw(case)) for case in CASES}
    payload = {}
    for case in SHARDED_CASES:
        for mode, (kind, shape) in SHARDED.items():
            payload[f"{case}-{mode}"] = ("sharded_step", dict(
                kind=kind, shape=shape, init=H.to_port(models[case][1]),
                batch=H.step_batch(case), mode="clip",
                model_kw=_kw(case)))
    join = R.start(R.beyond_rank, 4, payload)
    poolers = {(case, pooler): H.jax_module(_kw(
        case, text_hf_pooler_type=f"{pooler}_pooler"))
        for case in CASES for pooler in ("mean", "cls")}
    steps = {case: _jax_step(*models[case], H.step_batch(case), mode)
             for case, mode in STEPS.items()}

    def program(params, texts, states, batches):
        out = {}
        for case in CASES:
            p, t = params[case], texts[case]

            def feats(q, pooler):
                module = poolers[case, pooler]
                return module.apply({"params": q}, t, False,
                                    method=module.encode_text
                                    )["text_features"]

            def loss(q):
                f = feats(q, "mean")
                return jnp.sum(f * WEIGHTS), f

            (value, mean), grad = jax.value_and_grad(loss, has_aux=True)(p)
            out[case] = dict(mean=mean, cls=feats(p, "cls"), loss=value,
                             grad=grad)
        for case, (step, _, _) in steps.items():
            state, metrics = step(states[case], batches[case])
            out[f"step-{case}"] = dict(metrics=metrics, student=state.params,
                                       teacher=state.teacher_params)
        return out

    got = H.run_jax(jax.jit(program),
                    {c: m[1] for c, m in models.items()},
                    {c: H.tokens(c) for c in CASES},
                    {c: s[1] for c, s in steps.items()},
                    {c: s[2] for c, s in steps.items()})
    got = jax.tree_util.tree_map(np.asarray, got)
    return {"models": models, "jax": got, "ranks": join()}


def _port(runs, case, **extra):
    kw = _kw(case, **extra)
    return H.port_model(kw, H.to_port(runs["models"][case][1]))


@pytest.mark.parametrize("case", CASES)
def test_params_are_jax_s_leaf_for_leaf(runs, case):
    jp = runs["models"][case][1]
    model = _port(runs, case)
    want = {k: tuple(v.shape) for k, v in H.to_port(jp).items()
            if k.startswith("text.")}
    got = {k: tuple(p.shape) for k, p in model.named_parameters()
           if k.startswith("text.")}
    assert want and got == want
    assert len(want) == len(jax.tree_util.tree_leaves(jp["text"]))
    assert set(model.state_dict()) == set(H.to_port(jp))


@pytest.mark.parametrize("pooler", ["mean", "cls"])
@pytest.mark.parametrize("case", CASES)
def test_encode_text_equals_jax(runs, case, pooler):
    model = _port(runs, case, text_hf_pooler_type=f"{pooler}_pooler")
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(H.tokens(case)))
    H.close(got["text_features"], runs["jax"][case][pooler],
            f"{case} {pooler}")


@pytest.mark.parametrize("case", CASES)
def test_text_gradients_equal_jax(runs, case):
    """The backward of every new encoder: the gradient of ``sum(features *
    W)`` with respect to each text parameter."""
    want = runs["jax"][case]
    model = _port(runs, case, text_hf_pooler_type="mean_pooler")
    feats = model.encode_text(torch.from_numpy(H.tokens(case))
                              )["text_features"]
    loss = (feats * torch.from_numpy(WEIGHTS)).sum()
    loss.backward()
    H.close(loss.item(), want["loss"], f"{case} loss")
    grads = {k: v for k, v in H.to_port(want["grad"]).items()
             if k.startswith("text.")}
    for name, p in model.named_parameters():
        if name.startswith("text."):
            g = torch.zeros_like(p) if p.grad is None else p.grad
            H.close(g.numpy(), grads[name].numpy(), f"{case} {name}")


@pytest.mark.parametrize("case", ["bert-causal", "roberta-causal",
                                  "electra-causal"])
def test_causal_first_state_ignores_later_tokens(case):
    """Under ``is_decoder`` the first position attends to itself alone, so
    the CLS pooler's features do not move when the last token does (JAX's
    too: ``test_encode_text_equals_jax``), and the mean pooler's do."""
    text = torch.from_numpy(H.tokens(case, n=1))
    other = text.clone()
    other[0, -1] = (other[0, -1] + 1) % H.VOCAB + 3
    out = {}
    for pooler in ("cls", "mean"):
        model = create_model("ViT-B-16", device="cpu", **H.model_kw(
            case, text_hf_pooler_type=f"{pooler}_pooler"))
        with torch.no_grad():
            a, b = (model.encode_text(t)["text_features"]
                    for t in (text, other))
        out[pooler] = (a - b).abs().max().item()
    assert out["cls"] == 0.0 and out["mean"] > 1e-4


def test_roberta_prelayernorm_positions_are_arange():
    """JAX's tower offsets positions past the pad id only for RoBERTa,
    XLM-RoBERTa and CamemBERT (``cosmos_tpu/models/hf_model.py:110-118``):
    RoBERTa-PreLayerNorm, whose pad id is 1, reads rows 0..L-1 of its
    position table.  A fault of the reference, kept: the features are
    JAX's (``test_encode_text_equals_jax``) and differ from the pad-offset
    positions'."""
    assert "roberta-prelayernorm" not in PAD_OFFSET_POSITIONS
    model = create_model("ViT-B-16", device="cpu",
                         **H.model_kw("roberta-prelayernorm"))
    text = torch.from_numpy(H.tokens("roberta-prelayernorm")).long()
    mask = (text != 1).to(torch.int32)
    encoder = model.text.transformer
    with torch.no_grad():
        got = model.text(text)[1]
        arange = encoder(text, mask)[0]
        offset = encoder(text, mask, torch.zeros_like(text),
                         mask.cumsum(1) * mask + 1)[0]
    torch.testing.assert_close(got, arange, rtol=0, atol=0)
    assert (got - offset).abs().max() > 1e-3


def _port_step(case, init, batch, mode="clip"):
    model = H.port_model(_kw(case), init)
    lr = scheduler.const_lr(R.LR, 0, 10)
    opt = create_optimizer(model, lr, beta1=R.BETA1, beta2=0.98, eps=R.EPS,
                           weight_decay=0.5)
    cfg = TrainStepConfig(momentum_teacher=0.9, fix_momentum=True,
                          lr_schedule=lr, log_grad_norm=True,
                          **R.STEP_MODES[mode][1])
    state = create_train_state(model, opt)
    metrics = make_train_step(model, opt, cfg)(state, H.as_torch(batch))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "student": state.student.state_dict(),
            "teacher": state.teacher.state_dict()}


def _jax_step_result(runs, case):
    """JAX's step of ``case`` under the port's names."""
    out = runs["jax"][f"step-{case}"]
    return dict(out, student=H.to_port(out["student"]),
                teacher=H.to_port(out["teacher"]))


def _close_step(got, want, what):
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        H.close(float(got["metrics"][k]), float(w), f"{what} {k}")
    for which in ("student", "teacher"):
        assert set(got[which]) == set(want[which])
        for n, w in want[which].items():
            H.close(got[which][n].numpy(), w.numpy(), f"{what} {which} {n}")


@pytest.mark.parametrize("case", sorted(STEPS))
def test_step_equals_jax(runs, case):
    got = _port_step(case, H.to_port(runs["models"][case][1]),
                     H.step_batch(case), STEPS[case])
    _close_step(got, _jax_step_result(runs, case), f"{case} {STEPS[case]}")


@pytest.mark.parametrize("mode", sorted(SHARDED))
@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_steps_equal_the_unsharded_step(runs, case, mode):
    """ALBERT's against JAX's step; DistilBERT's against the port's plain
    step, whose tower's gradients are JAX's
    (``test_text_gradients_equal_jax``)."""
    want = (_jax_step_result(runs, case) if case in STEPS else _port_step(
        case, H.to_port(runs["models"][case][1]), H.step_batch(case)))
    ranks = [r[f"{case}-{mode}"] for r in runs["ranks"]]
    _close_step(ranks[0], want, f"{case} {mode}")
    # every rank ends on the same metrics
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)


def _per_leaf(mask_tree, params) -> dict:
    full = jax.tree_util.tree_map(lambda m, p: np.full(p.shape, bool(m)),
                                  mask_tree, params)
    return {k: bool(v.all()) for k, v in H.to_port(full).items()}


@pytest.mark.parametrize("case", CASES)
def test_decay_and_lock_masks_equal_jax(runs, case):
    jp = runs["models"][case][1]
    model = create_model("ViT-B-16", device="meta", **_kw(case))
    assert wd_mask(model) == _per_leaf(jax_train.wd_mask(jp), jp)
    for kw in (dict(lock_text=True), dict(
            lock_text=True, text_unlocked_layers=1,
            text_freeze_layer_norm=True)):
        if H.MORE[case]["model_type"] in ("distilbert", "albert"):
            for fn, tree in ((jax_train.frozen_mask, jp),
                             (frozen_mask, model)):
                with pytest.raises(NotImplementedError,
                                   match="encoder.layer"):
                    fn(tree, **kw)
            continue
        assert frozen_mask(model, **kw) == _per_leaf(
            jax_train.frozen_mask(jp, **kw), jp)


@pytest.mark.parametrize("tp,n_data", [(1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("case", CASES)
def test_tp_and_fsdp_placements_equal_jax(runs, case, tp, n_data):
    """The text tower's leaves, on JAX's own tree: ``tp_spec`` (none is
    Megatron-placed), and ``fsdp_spec`` or ``fsdp_tp_spec`` at
    ``min_size`` 0."""
    from cosmos_tpu.parallel import fsdp as jax_fsdp
    from cosmos_tpu.parallel import tp as jax_tp
    from cosmos_tpu.parallel.mesh import DATA_AXIS
    from cosmos_tpu_torch.models.convert import hf_model_entries
    from cosmos_tpu_torch.parallel import fsdp
    from cosmos_tpu_torch.parallel.tp import tp_param_placements

    jp = runs["models"][case][1]
    model = create_model("ViT-B-16", device="meta", **_kw(case))
    fsdp_dims = fsdp.fsdp_placements(model, n_data, tp, 0)
    tp_dims = tp_param_placements(model)
    entries = hf_model_entries(model)
    for key, path, tf in entries:
        leaf = jp
        for p in path:
            leaf = leaf[p]
        keys = [jax.tree_util.DictKey(p) for p in path]
        assert tp_dims[key] is None and jax_tp.tp_spec(keys, leaf) == \
            jax.sharding.PartitionSpec(), key
        spec = (jax_fsdp.fsdp_tp_spec(keys, leaf, n_data, tp, 0) if tp > 1
                else jax_fsdp.fsdp_spec(leaf, n_data, 0))
        d = next((i for i, ax in enumerate(spec) if ax == DATA_AXIS), None)
        want = None if d is None else (1 - d if tf == "t" else d)
        assert fsdp_dims[key] == want, (key, spec)
    assert len(entries) == len([k for k in tp_dims if k.startswith("text.")])


@pytest.mark.parametrize("case", ["distilbert", "albert", "albert-groups"])
def test_fsdp_units_are_the_layers_and_layer_groups(case):
    """DistilBERT's ``transformer.layer`` members and ALBERT's layer groups
    (one, or two, each run by several layers) are FSDP units."""
    from cosmos_tpu_torch.parallel import fsdp

    model = create_model("ViT-B-16", device="meta", **H.model_kw(case))
    encoder = model.text.transformer
    units = (list(encoder.transformer.layer) if case == "distilbert"
             else list(encoder.encoder.albert_layer_groups))
    assert list(fsdp._blocks(model)) == \
        list(model.visual.transformer.resblocks) + units
