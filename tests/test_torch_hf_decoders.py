"""The decoder-LM text towers (GPT-2 and ``gpt-sw3``, OPT pre-LN and in
opt-350m's layout, Llama, Mistral with a window of 4 and with none, Gemma)
against cosmos_tpu's, on the CPU, in float32 within
``torch_hf_cases.TOL``:

  - the config defaults against ``AutoConfig.for_model`` on every field
    the encoders read (``gpt-sw3`` is a ``GPT2Config`` of type ``gpt2``),
    and the default pooler (``mean_pooler``: none is in JAX's table);
  - the parameters are JAX's tree leaf for leaf through the weight bridge
    (GPT-2's Conv1D weights are Flax's kernels transposed);
  - ``encode_text`` under ``mean_pooler`` and ``cls_pooler``, and the
    gradient of a fixed function of the mean-pooled features with respect
    to every text parameter, against JAX's, on the parameters of JAX's own
    init; a real id 0 inside a GPT-2 caption is masked as padding in both
    (the config has no pad id, so the tower takes ``text_cfg.pad_id``);
  - the faults of the reference the port keeps: the rotary base is 10000
    whatever ``rope_theta`` says and Llama reads no ``head_dim``; Mistral's
    window lets a query see ``w + 1`` keys, and none but itself when
    ``sliding_window`` is null; GPT-2 reads no ``scale_attn_weights``;
    Gemma ignores ``hidden_act``;
  - one plain CLIP step (GPT-2) and one ``--siglip`` step (Gemma) against
    JAX's jitted step;
  - the decay and ``--lock-text`` masks against JAX's (no tower has
    ``encoder.layer``: both raise);
  - the TP and FSDP placements against JAX's ``tp_spec``, ``fsdp_spec``
    and ``fsdp_tp_spec`` leaf for leaf on JAX's layout, FSDP's units, and
    the FSDP, TP and FSDP x TP steps of GPT-2 and Llama on 4 gloo ranks
    against the port's unsharded step.

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
from cosmos_tpu_torch.training import scheduler
from cosmos_tpu_torch.training.train import (TrainStepConfig, frozen_mask,
                                             wd_mask)

CASES = tuple(H.DECODERS)
# the cases of the full steps, and their modes
STEPS = {"gpt2": "clip", "gemma": "siglip"}
# the sharded steps on the gloo ranks: (kind, mesh shape)
SHARDED = {"fsdp": ("fsdp", ()), "tp": ("tp", (2, 2)),
           "fsdp_tp": ("fsdp_tp", (2, 2))}
SHARDED_CASES = ("gpt2", "llama")
_LLAMA_FIELDS = ("vocab_size", "hidden_size", "intermediate_size",
                 "num_hidden_layers", "num_attention_heads",
                 "num_key_value_heads", "hidden_act",
                 "max_position_embeddings", "initializer_range",
                 "rms_norm_eps", "pad_token_id", "is_encoder_decoder")
FIELDS = {
    "gpt2": ("vocab_size", "n_positions", "n_embd", "n_layer", "n_head",
             "n_inner", "activation_function", "layer_norm_epsilon",
             "initializer_range", "pad_token_id", "is_encoder_decoder"),
    "opt": ("vocab_size", "hidden_size", "num_hidden_layers", "ffn_dim",
            "max_position_embeddings", "do_layer_norm_before",
            "_remove_final_layer_norm", "word_embed_proj_dim",
            "num_attention_heads", "activation_function", "init_std",
            "pad_token_id", "is_encoder_decoder"),
    "llama": _LLAMA_FIELDS + ("attention_bias",),
    "mistral": _LLAMA_FIELDS + ("sliding_window",),
    "gemma": _LLAMA_FIELDS + ("head_dim", "hidden_activation",
                              "attention_bias"),
}


def _kw(case, **extra):
    siglip = R.SIGLIP if STEPS.get(case) == "siglip" else {}
    return H.model_kw(case, **dict(siglip, **extra))


@pytest.mark.parametrize("model_type", sorted(FIELDS) + ["gpt-sw3"])
def test_config_defaults_equal_transformers(model_type):
    from transformers import AutoConfig

    base = "gpt2" if model_type == "gpt-sw3" else model_type
    case = next(c for c, d in H.DECODERS.items()
                if d["model_type"] == model_type)
    variant = ({"hidden_size": 48, "num_attention_heads": 3,
                "num_hidden_layers": 1, "max_position_embeddings": 64,
                "activation_function": "relu"} if base == "gpt2" else
               {"num_key_value_heads": None, "intermediate_size": 48,
                "hidden_activation": "gelu", "sliding_window": None,
                "word_embed_proj_dim": None, "rms_norm_eps": 1e-7})
    for d in ({}, H.DECODERS[case], variant):
        d = {k: v for k, v in d.items() if k != "model_type"}
        want = AutoConfig.for_model(model_type, **d).to_dict()
        got = vars(resolve_hf_config({"model_type": model_type, **d}))
        fields = FIELDS[base]
        assert {k: got[k] for k in fields} == {k: want[k] for k in fields}
        assert got["model_type"] == want["model_type"] == base


@pytest.mark.parametrize("case", CASES)
def test_default_pooler_is_jax_s(case):
    from cosmos_tpu.models.hf_configs import arch_dict

    model = create_model("ViT-B-16", device="meta", **H.model_kw(case))
    want = arch_dict.get(resolve_hf_config(H.DECODERS[case]).model_type,
                         {}).get("pooler", "mean_pooler")
    assert model.text.pooler_type == want == "mean_pooler"


@pytest.mark.parametrize("model_type", ["gpt2", "gpt-sw3"])
def test_gpt2_s_default_config_builds_flax_s_leaves(model_type):
    """``{"model_type": "gpt2"}`` alone, once the refusal case of an
    unported type: GPT-2 small, leaf for leaf the shapes of transformers'
    ``FlaxGPT2Model``."""
    from transformers import AutoConfig, FlaxGPT2Model

    from cosmos_tpu_torch.models.convert import hf_encoder_entries

    model = create_model("ViT-B-16", device="meta", **H.model_kw(
        "gpt2", text_hf_model_config={"model_type": model_type}))
    flax = FlaxGPT2Model(AutoConfig.for_model(model_type), _do_init=False)
    shapes = jax.eval_shape(lambda: flax.init_weights(
        jax.random.PRNGKey(0), (1, 1)))
    want = {tuple(k.key for k in path): leaf.shape for path, leaf in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    encoder = model.text.transformer
    params = dict(encoder.named_parameters())
    got = {path: tuple(params[name].shape)[::-1] if tf == "t"
           else tuple(params[name].shape)
           for name, path, tf in hf_encoder_entries(encoder)}
    assert got == want
    assert sum(p.numel() for p in params.values()) == 124439808


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


def _zero_inside() -> np.ndarray:
    """GPT-2's captions with a real id 0 (GPT-2's ``!``) inside each."""
    t = H.tokens("gpt2")
    t[:, 2] = 0
    return t


@pytest.fixture(scope="module")
def runs():
    """The gloo ranks' sharded steps (started first), and JAX's features,
    gradients and steps of every case, from one compiled program, on the
    parameters of JAX's init."""
    models = {case: H.jax_create_fast("ViT-B-16", seed=i + 1,
                                      use_flash=False, **_kw(case))
              for i, case in enumerate(CASES)}
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

    def program(params, texts, states, batches, zero):
        out = {}
        for case in CASES:
            p, t = params[case], texts[case]

            def feats(q, pooler, t=t):
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
            if case == "gpt2":
                out[case]["zero_inside"] = feats(p, "mean", zero)
        for case, (step, _, _) in steps.items():
            state, metrics = step(states[case], batches[case])
            out[f"step-{case}"] = dict(metrics=metrics, student=state.params,
                                       teacher=state.teacher_params)
        return out

    got = H.run_jax(jax.jit(program),
                    {c: m[1] for c, m in models.items()},
                    {c: H.tokens(c) for c in CASES},
                    {c: s[1] for c, s in steps.items()},
                    {c: s[2] for c, s in steps.items()}, _zero_inside())
    got = jax.tree_util.tree_map(np.asarray, got)
    return {"models": models, "jax": got, "ranks": join()}


def _port(runs, case, **extra):
    return H.port_model(_kw(case, **extra),
                        H.to_port(runs["models"][case][1]))


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


def test_gpt2_conv1d_weights_are_flax_kernels_transposed(runs):
    jp = runs["models"]["gpt2"][1]["text"]["hf"]
    model = _port(runs, "gpt2")
    c_fc = model.text.transformer.h[0].mlp.c_fc.weight
    kernel = np.asarray(jp["h"]["0"]["mlp"]["c_fc"]["kernel"])
    assert kernel.shape == (64, 32) and tuple(c_fc.shape) == (32, 64)
    np.testing.assert_array_equal(c_fc.detach().numpy(), kernel.T)


@pytest.mark.parametrize("pooler", ["mean", "cls"])
@pytest.mark.parametrize("case", CASES)
def test_encode_text_equals_jax(runs, case, pooler):
    model = _port(runs, case, text_hf_pooler_type=f"{pooler}_pooler")
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(H.tokens(case)))
    H.close(got["text_features"], runs["jax"][case][pooler],
            f"{case} {pooler}")


def test_gpt2_masks_a_real_id_0_as_padding(runs):
    """GPT-2's config has no pad id: the tower masks ``text_cfg.pad_id``,
    0, which is GPT-2's ``!``.  A fault of the reference, kept."""
    model = _port(runs, "gpt2")
    assert model.text.pad_id == 0
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(_zero_inside()))
    H.close(got["text_features"], runs["jax"]["gpt2"]["zero_inside"],
            "gpt2 with 0 inside")


@pytest.mark.parametrize("case", CASES)
def test_text_gradients_equal_jax(runs, case):
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


def _features(case, text, pooler="mean", **config):
    kw = H.model_kw(case, text_hf_pooler_type=f"{pooler}_pooler")
    kw["text_hf_model_config"] = dict(kw["text_hf_model_config"], **config)
    model = create_model("ViT-B-16", device="cpu", seed=3, **kw)
    with torch.no_grad():
        return model.encode_text(text)["text_features"]


def _states(case, text, **config):
    """The last hidden states of ``case``'s encoder (seed 3)."""
    kw = H.model_kw(case)
    kw["text_hf_model_config"] = dict(kw["text_hf_model_config"], **config)
    tower = create_model("ViT-B-16", device="cpu", seed=3, **kw).text
    with torch.no_grad():
        return tower.transformer(text, (text != tower.pad_id).int())[0]


@pytest.mark.parametrize("case", CASES)
def test_first_state_ignores_later_tokens(case):
    """Causal: ``cls_pooler``'s features (the first state) do not move when
    the last token does; the mean pooler's do."""
    text = torch.from_numpy(H.tokens(case, n=1)).long()
    other = text.clone()
    other[0, -1] = (other[0, -1] + 1) % H.VOCAB + 3
    for pooler, moved in (("cls", False), ("mean", True)):
        a, b = (_features(case, t, pooler) for t in (text, other))
        assert ((a - b).abs().max().item() > 1e-4) == moved, pooler


@pytest.mark.parametrize("config", [
    {"rope_theta": 1e6}, {"head_dim": 16},
    {"rope_scaling": {"rope_type": "linear", "factor": 4.0}}])
@pytest.mark.parametrize("case", ["llama", "mistral"])
def test_rotary_ignores_rope_theta_and_head_dim(case, config):
    """Flax Llama and Mistral build their rotary table from base 10000
    over ``hidden_size // heads`` whatever the config says (trap of the
    reference, kept)."""
    text = torch.from_numpy(H.tokens(case)).long()
    torch.testing.assert_close(_features(case, text, **config),
                               _features(case, text), rtol=0, atol=0)


def test_mistral_window_is_w_plus_one_keys():
    """A window of 4: query 11 of the second layer sees the first layer's
    states 7..11, which see tokens 3..11; so token 3 moves state 11 and
    token 2 does not (torch's Mistral, ``w`` keys, would not reach 3)."""
    text = torch.from_numpy(H.tokens("mistral", n=1)).long()
    base = _states("mistral", text)[0, 11]
    moved = {}
    for j in (2, 3):
        other = text.clone()
        other[0, j] = (other[0, j] + 1) % H.VOCAB + 3
        moved[j] = (_states("mistral", other)[0, 11] - base).abs().max()
    assert moved[2].item() == 0.0 and moved[3].item() > 1e-6


def test_mistral_without_window_attends_to_itself_alone():
    """``sliding_window: null`` makes Flax Mistral's mask the diagonal:
    no state moves when another token does (fault of the reference,
    kept); with the default window of 4096 the last one moves."""
    text = torch.from_numpy(H.tokens("mistral", n=1)).long()
    other = text.clone()
    other[0, 0] = (other[0, 0] + 1) % H.VOCAB + 3
    diag = (_states("mistral-no-window", other)
            - _states("mistral-no-window", text))[0]
    assert diag[1:].abs().max().item() == 0.0 and diag[0].abs().max() > 0
    full = (_states("mistral-no-window", other, sliding_window=4096)
            - _states("mistral-no-window", text, sliding_window=4096))[0]
    assert full[11].abs().max().item() > 1e-6


def test_a_rotary_table_made_in_inference_mode_serves_a_step():
    """Serving first (``torch.inference_mode``), then a gradient through
    the same tower: the cached rotary table is an ordinary tensor."""
    model = create_model("ViT-B-16", device="cpu", **H.model_kw("llama"))
    text = torch.from_numpy(H.tokens("llama")).long()
    with torch.inference_mode():
        served = model.encode_text(text)["text_features"]
    feats = model.encode_text(text)["text_features"]
    feats.sum().backward()
    torch.testing.assert_close(feats.detach(), served, rtol=0, atol=0)
    assert model.text.transformer.embed_tokens.weight.grad is not None


def test_gpt2_reads_no_scale_attn_weights():
    text = torch.from_numpy(H.tokens("gpt2")).long()
    torch.testing.assert_close(
        _features("gpt2", text, scale_attn_weights=False,
                  scale_attn_by_inverse_layer_idx=True),
        _features("gpt2", text), rtol=0, atol=0)


def test_gemma_ignores_hidden_act():
    """Gemma's MLP takes ``hidden_activation``, else the tanh GELU,
    whatever ``hidden_act`` says."""
    text = torch.from_numpy(H.tokens("gemma")).long()
    plain = _features("gemma", text)
    torch.testing.assert_close(_features("gemma", text, hidden_act="relu"),
                               plain, rtol=0, atol=0)
    exact = _features("gemma", text, hidden_activation="gelu")
    assert (exact - plain).abs().max().item() > 1e-7


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
    out = runs["jax"][f"step-{case}"]
    want = dict(out, student=H.to_port(out["student"]),
                teacher=H.to_port(out["teacher"]))
    _close_step(got, want, f"{case} {STEPS[case]}")


@pytest.mark.parametrize("mode", sorted(SHARDED))
@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_steps_equal_the_unsharded_step(runs, case, mode):
    """Against the port's plain CLIP step, whose tower's gradients are
    JAX's (``test_text_gradients_equal_jax``)."""
    want = _port_step(case, H.to_port(runs["models"][case][1]),
                      H.step_batch(case))
    ranks = [r[f"{case}-{mode}"] for r in runs["ranks"]]
    _close_step(ranks[0], want, f"{case} {mode}")
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
        for fn, tree in ((jax_train.frozen_mask, jp), (frozen_mask, model)):
            with pytest.raises(NotImplementedError, match="encoder.layer"):
                fn(tree, **kw)


@pytest.mark.parametrize("tp,n_data", [(1, 2), (2, 2), (4, 2)])
@pytest.mark.parametrize("case", CASES)
def test_tp_and_fsdp_placements_equal_jax(runs, case, tp, n_data):
    """The text tower's leaves, on JAX's own tree: the tensor dim
    ``tp_spec`` puts on the model axis (GPT-2's ``c_fc`` and ``c_proj``,
    the ``q/k/v_proj`` of OPT and the Llama family; OPT's ``out_proj``)
    and the one ``fsdp_spec`` or ``fsdp_tp_spec`` puts on the data axis at
    ``min_size`` 0, through the bridge's transposes."""
    from cosmos_tpu.parallel import fsdp as jax_fsdp
    from cosmos_tpu.parallel import tp as jax_tp
    from cosmos_tpu.parallel.mesh import DATA_AXIS
    from cosmos_tpu.parallel.tp import MODEL_AXIS
    from cosmos_tpu_torch.models.convert import hf_model_entries
    from cosmos_tpu_torch.parallel import fsdp
    from cosmos_tpu_torch.parallel.tp import tp_param_placements

    def port_dim(spec, axis, tf):
        d = next((i for i, ax in enumerate(spec) if ax == axis), None)
        return None if d is None else (1 - d if tf == "t" else d)

    jp = runs["models"][case][1]
    model = create_model("ViT-B-16", device="meta", **_kw(case))
    fsdp_dims = fsdp.fsdp_placements(model, n_data, tp, 0)
    tp_dims = tp_param_placements(model)
    entries = hf_model_entries(model)
    sharded = 0
    for key, path, tf in entries:
        leaf = jp
        for p in path:
            leaf = leaf[p]
        keys = [jax.tree_util.DictKey(p) for p in path]
        want = port_dim(jax_tp.tp_spec(keys, leaf), MODEL_AXIS, tf)
        assert tp_dims[key] == want, key
        sharded += want is not None
        spec = (jax_fsdp.fsdp_tp_spec(keys, leaf, n_data, tp, 0) if tp > 1
                else jax_fsdp.fsdp_spec(leaf, n_data, 0))
        assert fsdp_dims[key] == port_dim(spec, DATA_AXIS, tf), (key, spec)
    assert sharded > 0
    assert len(entries) == len([k for k in tp_dims if k.startswith("text.")])


@pytest.mark.parametrize("case", ["gpt2", "opt", "llama"])
def test_fsdp_units_are_the_decoder_layers(case):
    from cosmos_tpu_torch.parallel import fsdp

    model = create_model("ViT-B-16", device="meta", **H.model_kw(case))
    encoder = model.text.transformer
    units = list(encoder.h if case == "gpt2" else encoder.decoder.layers
                 if case == "opt" else encoder.layers)
    assert list(fsdp._blocks(model)) == \
        list(model.visual.transformer.resblocks) + units
