"""The port's contrastive losses (cosmos_tpu_torch.losses) against
cosmos_tpu.losses.contrastive: values, and gradients with respect to every
feature input and both logit scales, with float32 and bfloat16 features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cosmos_tpu.losses.contrastive import ClipLoss as JaxClipLoss
from cosmos_tpu.losses.contrastive import COSMOSLoss as JaxCOSMOSLoss
from cosmos_tpu_torch.losses import ClipLoss, COSMOSLoss

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# float32: summation order only.  bfloat16 features: the logits and the loss
# are float32 on both sides (the products of bf16 values are exact in
# float32), but the gradients with respect to the features are rounded back
# to bf16 on both sides, where a last-bit float32 difference can move one
# bf16 ulp (2^-8 relative)
VALUE_TOL = dict(atol=2e-6, rtol=1e-6)
GRAD_TOL = {"float32": dict(atol=2e-6, rtol=1e-5),
            "bfloat16": dict(atol=1e-6, rtol=8e-3)}


def _features(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _compare(jax_fn, torch_fn, arrays, dtype):
    """Value and gradient of every input, JAX against the port; the last
    array(s) named *scale stay float32."""
    jdt, tdt = DTYPES[dtype]
    names = list(arrays)
    j_in = [jnp.asarray(arrays[n], jnp.float32 if "scale" in n else jdt)
            for n in names]
    want, want_g = jax.value_and_grad(
        lambda *a: jax_fn(**dict(zip(names, a))),
        argnums=tuple(range(len(names))))(*j_in)
    t_in = [torch.from_numpy(arrays[n]).to(
        torch.float32 if "scale" in n else tdt).requires_grad_(True)
        for n in names]
    got = torch_fn(**dict(zip(names, t_in)))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), **VALUE_TOL)
    for n, t, g in zip(names, t_in, want_g):
        if n.startswith("t_"):
            # teacher features are detached targets: JAX's stop_gradient
            # gives zeros, the port no gradient at all
            assert t.grad is None and not np.any(_np(g)), n
            continue
        assert t.grad.dtype == t.dtype, n
        np.testing.assert_allclose(_np(t.grad), _np(g), **GRAD_TOL[dtype],
                                   err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vi,vt", [(None, None), (1, 1), (2, 8), (8, 2)])
def test_clip_loss(vi, vt, dtype):
    b, d = 6, 16
    img = _features((b, d) if vi is None else (vi, b, d), vi or 0)
    txt = _features((b, d) if vt is None else (vt, b, d), 10 + (vt or 0))
    arrays = {"image_features": img, "text_features": txt,
              "logit_scale": np.array(np.exp(2.3), np.float32)}
    _compare(lambda **a: JaxClipLoss()(**a),
             lambda **a: ClipLoss()(**a), arrays, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local_loss", [False, True])
def test_cosmos_loss(local_loss, dtype):
    b, d, vi, vt = 5, 16, 4, 3
    arrays = {
        "s_image_features": _features((vi, b, d), 1),
        "s_text_features": _features((vt, b, d), 2),
        "t_image_features": _features((2, b, d), 3),
        "t_text_features": _features((2, b, d), 4),
        "s_img_crossmodal_features": _features((vi, b, d), 5),
        "s_txt_crossmodal_features": _features((vt, b, d), 6),
        "logit_scale": np.array(np.exp(2.65), np.float32),
        "distill_logit_scale": np.array(np.exp(1.9), np.float32),
    }
    _compare(lambda **a: JaxCOSMOSLoss(local_loss=local_loss)(**a),
             lambda **a: COSMOSLoss(local_loss=local_loss)(**a),
             arrays, dtype)


def test_cosmos_loss_terms_and_teacher_detach():
    b, d = 4, 8
    f = {k: torch.from_numpy(_features(s, i)).requires_grad_(True)
         for i, (k, s) in enumerate([
             ("s_image_features", (3, b, d)), ("s_text_features", (3, b, d)),
             ("t_image_features", (2, b, d)), ("t_text_features", (2, b, d)),
             ("s_img_crossmodal_features", (3, b, d)),
             ("s_txt_crossmodal_features", (3, b, d))])}
    scale = torch.tensor(10.0)
    parts = COSMOSLoss()(logit_scale=scale, distill_logit_scale=scale,
                         output_dict=True, **f)
    assert set(parts) == {"distill_loss", "clip_loss"}
    total = COSMOSLoss()(logit_scale=scale, distill_logit_scale=scale, **f)
    torch.testing.assert_close(total, parts["distill_loss"]
                               + parts["clip_loss"])
    total.backward()
    # the teacher's features are targets only
    assert f["t_image_features"].grad is None
    assert f["t_text_features"].grad is None
    # the CLIP term reads the 2 global crops only
    assert torch.count_nonzero(f["s_image_features"].grad[2:]) == 0
    with pytest.raises(ValueError, match="2 global"):
        COSMOSLoss()(logit_scale=scale, **{
            **f, "t_image_features": f["s_image_features"]})


def test_losses_refuse_a_process_group(monkeypatch):
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    x = torch.from_numpy(_features((4, 8), 0))
    with pytest.raises(NotImplementedError, match="single-process"):
        ClipLoss()(x, x, torch.tensor(1.0))
