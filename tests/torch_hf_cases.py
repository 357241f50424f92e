"""Shared cases of the HF text-tower tests (``test_torch_hf_*.py``): tiny
configs of the five architectures at width 32 and 2 layers (``HF``) and of
the later ones (``MORE``: DistilBERT with learned and sinusoidal
positions, ELECTRA with and without its
embedding projection, ALBERT with one group and with two groups of two
layers, RoBERTa-PreLayerNorm, and causal BERT, RoBERTa and ELECTRA), of
the decoder LMs (``DECODERS``: GPT-2 and ``gpt-sw3``, OPT pre-LN and in
opt-350m's layout, Llama, Mistral with a window of 4 and with none,
Gemma), their token batches (pads at the right ends, each with its
architecture's pad id), JAX's model with parameters drawn with numpy at
the shapes ``jax.eval_shape`` gives (no JAX init is compiled), and local
``hf_model_name`` directories written by transformers' own classes."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cosmos_tpu.models.factory import create_model as jax_create_model
from cosmos_tpu_torch import create_model
from cosmos_tpu_torch.models.convert import state_dict_from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB = 128
CONTEXT = 12
VISION = dict(embed_dim=32, vision_image_size=16, vision_patch_size=8,
              vision_width=32, vision_layers=1, vision_head_width=16,
              text_context_length=CONTEXT)
_BERT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
             intermediate_size=64, vocab_size=VOCAB,
             max_position_embeddings=32)
_T5 = dict(d_model=32, num_layers=2, num_heads=2, d_kv=16, d_ff=64,
           vocab_size=VOCAB)
HF = {
    "bert": dict(_BERT, model_type="bert"),
    "roberta": dict(_BERT, model_type="roberta", layer_norm_eps=1e-5),
    "xlm-roberta": dict(_BERT, model_type="xlm-roberta"),
    "t5": dict(_T5, model_type="t5"),
    "mt5": dict(_T5, model_type="mt5", tie_word_embeddings=False),
}
# the fields each encoder reads, by architecture
BERT_FIELDS = ("vocab_size", "hidden_size", "num_hidden_layers",
               "num_attention_heads", "intermediate_size", "hidden_act",
               "max_position_embeddings", "type_vocab_size",
               "initializer_range", "layer_norm_eps", "pad_token_id",
               "is_decoder", "add_cross_attention", "is_encoder_decoder")
T5_FIELDS = ("vocab_size", "d_model", "d_kv", "d_ff", "num_layers",
             "num_heads", "relative_attention_num_buckets",
             "relative_attention_max_distance", "layer_norm_epsilon",
             "initializer_factor", "feed_forward_proj", "dense_act_fn",
             "is_gated_act", "tie_word_embeddings", "pad_token_id",
             "is_decoder", "is_encoder_decoder")
# case -> config of the types after the five, keyed by case name
MORE = {
    "distilbert": dict(model_type="distilbert", dim=32, n_layers=2,
                       n_heads=2, hidden_dim=64, vocab_size=VOCAB,
                       max_position_embeddings=32),
    # the position table a constant, no leaf
    "distilbert-sinusoidal": dict(model_type="distilbert", dim=32,
                                  n_layers=2, n_heads=2, hidden_dim=64,
                                  vocab_size=VOCAB,
                                  max_position_embeddings=32,
                                  sinusoidal_pos_embds=True,
                                  activation="gelu_new"),
    "electra": dict(_BERT, model_type="electra", embedding_size=32),
    "electra-project": dict(_BERT, model_type="electra", embedding_size=16),
    "albert": dict(_BERT, model_type="albert", embedding_size=16),
    # layer i runs group int(i / 1.5): 0, 0, 1
    "albert-groups": dict(_BERT, model_type="albert", embedding_size=16,
                          num_hidden_layers=3, num_hidden_groups=2,
                          inner_group_num=2),
    "roberta-prelayernorm": dict(_BERT, model_type="roberta-prelayernorm"),
    "bert-causal": dict(_BERT, model_type="bert", is_decoder=True),
    "roberta-causal": dict(_BERT, model_type="roberta", is_decoder=True,
                           add_cross_attention=True),
    "electra-causal": dict(_BERT, model_type="electra", embedding_size=16,
                           is_decoder=True),
}
# the decoder LMs: max_position_embeddings holds twice a rotary head's
# features (Flax's table cuts its last axis to max_position_embeddings)
_LLAMA = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
              num_key_value_heads=2, intermediate_size=64, vocab_size=VOCAB,
              max_position_embeddings=32)
_GPT2 = dict(n_embd=32, n_layer=2, n_head=2, n_inner=64, vocab_size=VOCAB,
             n_positions=32)
_OPT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            ffn_dim=64, vocab_size=VOCAB, max_position_embeddings=32)
DECODERS = {
    "gpt2": dict(_GPT2, model_type="gpt2"),
    "gpt-sw3": dict(_GPT2, model_type="gpt-sw3", activation_function="gelu"),
    "opt": dict(_OPT, model_type="opt"),
    # project_in/project_out and post-LN blocks, no final LayerNorm
    "opt-350m": dict(_OPT, model_type="opt", word_embed_proj_dim=16,
                     do_layer_norm_before=False),
    "llama": dict(_LLAMA, model_type="llama", rms_norm_eps=1e-5,
                  attention_bias=True),
    "mistral": dict(_LLAMA, model_type="mistral", sliding_window=4),
    "mistral-no-window": dict(_LLAMA, model_type="mistral",
                              sliding_window=None),
    "gemma": dict(_LLAMA, model_type="gemma", num_key_value_heads=1,
                  head_dim=16),
}
CASES = {**HF, **MORE, **DECODERS}
# the pad id of each case's tower: the config's, else text_cfg.pad_id (0)
PAD = {case: 1 if cfg["model_type"] in (
    "roberta", "xlm-roberta", "roberta-prelayernorm", "opt") else 0
    for case, cfg in CASES.items()}


def model_kw(arch: str, **extra) -> dict:
    return {**VISION, "text_hf_model_config": CASES[arch],
            "text_hf_model_pretrained": False, **extra}


def tokens(arch: str, n: int = 4, seed: int = 0) -> np.ndarray:
    """``[n, CONTEXT]`` ids in ``[3, VOCAB)`` with 0, 3, 5, ... trailing
    pads of the architecture's pad id."""
    rng = np.random.default_rng(seed)
    t = rng.integers(3, VOCAB, (n, CONTEXT)).astype(np.int32)
    for i in range(n):
        if i:
            t[i, CONTEXT - 1 - 2 * i:] = PAD[arch]
    return t


def step_batch(arch: str) -> dict:
    """torch_dp_ranks.step_batch's views (global batch 4) with each
    caption view's right ends padded with ``arch``'s pad id."""
    import torch_dp_ranks as R

    batch = R.step_batch(4, 1)
    texts = batch["texts"]
    for v in range(texts.shape[0]):
        texts[v] = tokens(arch, n=texts.shape[1], seed=v)
    return batch


def jax_module(kw):
    """JAX's ViT-B-16 with the overrides ``kw``, no parameters."""
    return jax_create_model("ViT-B-16", use_flash=False, init_params=False,
                            **kw)[0]


def jax_model(kw, seed=1, scale=0.1):
    """JAX's ViT-B-16 with the overrides ``kw`` and numpy parameters."""
    jm = jax_module(kw)
    v, t = jm.cfg.vision_cfg, jm.cfg.text_cfg
    # the COSMOS heads are created by the cross-modal forward
    extra = ({"batch_size": 1} if v.output_all and v.attentional_pool
             else {})
    shapes = jax.eval_shape(
        lambda key, x, y: jm.init(key, x, y, **extra)["params"],
        jax.random.PRNGKey(0),
        jnp.zeros((1, v.image_size, v.image_size, 3), jnp.float32),
        jnp.zeros((1, t.context_length), jnp.int32))
    rng = np.random.default_rng(seed)
    return jm, jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * scale).astype(np.float32),
        shapes)


# XLA's CPU compiler without its optimisation passes: the same functions,
# compiled in about half the time
FAST_XLA = {"xla_backend_optimization_level": 0}


def run_jax(jitted, *args):
    """The ``jax.jit`` function ``jitted`` on ``args``, compiled with
    FAST_XLA."""
    return jitted.lower(*args).compile(FAST_XLA)(*args)


def jax_create_fast(name, seed=0, **kw):
    """``jax_create_model(name, seed=seed, **kw)``: the model, and its
    parameters from the same init (``init_model_params``) compiled with
    FAST_XLA and traced through XLA attention (the parameters do not
    depend on the attention's route): the init's values within float32
    rounding, in a third to a half of the time."""
    jm, _ = jax_create_model(name, init_params=False, **kw)
    twin = jm
    if kw.get("use_flash") is not False:
        twin, _ = jax_create_model(name, init_params=False,
                                   **dict(kw, use_flash=False))
    c = twin.cfg
    v, t = c.vision_cfg, c.text_cfg
    args = (jax.random.PRNGKey(seed),
            jnp.zeros((1, v.image_size, v.image_size, 3), jnp.float32),
            jnp.zeros((1, t.context_length), jnp.int32))
    pooled = c.multimodal_cfg is None and v.output_all and v.attentional_pool
    init = jax.jit(functools.partial(twin.init, **(
        {"batch_size": 1} if pooled else {})))
    return jm, run_jax(init, *args)["params"]


def to_port(tree) -> dict:
    return state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                             tree))


def port_model(kw, state_dict=None, **extra):
    model = create_model("ViT-B-16", device="cpu", **kw, **extra).eval()
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    return model


def close(got, want, what=""):
    w = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), w, rtol=TOL["rtol"],
        atol=TOL["atol"] * max(1.0, float(np.abs(w).max(initial=0.0))),
        err_msg=what)


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def hf_config(arch: str, **overrides):
    """transformers' config of ``arch``'s tiny tower."""
    import transformers

    fields = {k: v for k, v in CASES[arch].items() if k != "model_type"}
    return transformers.AutoConfig.for_model(CASES[arch]["model_type"],
                                             **dict(fields, **overrides))


def write_hf_dir(path: str, arch: str, cls_name: str, seed: int = 0,
                 max_shard_size=None, chunk: int = None, **overrides) -> None:
    """A local ``hf_model_name`` directory of ``arch``'s tiny config:
    ``config.json`` and seeded weights as transformers' Flax class
    ``cls_name`` writes them with ``save_pretrained``
    (``flax_model.msgpack``, or its sharded index at ``max_shard_size``;
    ``chunk``: flax's chunk size in bytes, so that arrays above it are
    written in chunks).  ``cls_name`` ``"torch"`` writes the
    ``model.safetensors`` torch's ``save_pretrained`` writes for the base
    model (transformers' torch names, which are the port's encoder's, and
    ``{"format": "pt"}``), from the port's seeded encoder.  ``overrides``:
    config fields over the tiny config's (Flax classes only)."""
    import transformers
    from flax import serialization

    config = hf_config(arch, **overrides)
    if cls_name == "torch":
        from safetensors.torch import save_file

        config.architectures = [type(config).__name__[:-len("Config")]
                                + "Model"]
        config.save_pretrained(path)
        kw = model_kw(arch)
        encoder = create_model("ViT-B-16", device="cpu", seed=seed,
                               **kw).text.transformer
        save_file({k: v.contiguous() for k, v in
                   encoder.state_dict().items()},
                  f"{path}/model.safetensors", metadata={"format": "pt"})
        return
    model = getattr(transformers, cls_name)(config, _do_init=False)
    shapes = jax.eval_shape(
        lambda: model.init_weights(jax.random.PRNGKey(0), (1, 1)))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
        shapes)
    saved = serialization.MAX_CHUNK_SIZE
    serialization.MAX_CHUNK_SIZE = chunk or saved
    try:
        kw = {"max_shard_size": max_shard_size} if max_shard_size else {}
        model.save_pretrained(path, params=params, **kw)
    finally:
        serialization.MAX_CHUNK_SIZE = saved
