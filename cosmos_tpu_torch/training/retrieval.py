"""Zero-shot image-text retrieval evaluation (counterpart of
``cosmos_tpu/training/retrieval.py``).

Features come back from the encoders as tensors on the model's device and
are ranked on the host with numpy: R@1/5/10, mean and median rank in both
directions.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


def _rank_matrix(sim: np.ndarray) -> np.ndarray:
    """rank[i, j] = 0-based rank of column j in row i (descending)."""
    order = np.argsort(-sim, axis=1)
    ranks = np.empty_like(order)
    rows = np.arange(sim.shape[0])[:, None]
    ranks[rows, order] = np.arange(sim.shape[1])[None, :]
    return ranks


def compute_retrieval_metrics(
    sim: np.ndarray,                      # [n_img, n_txt]
    img2txt: Dict[int, List[int]],        # row idx -> list of txt col idxs
    txt2img: Dict[int, int],              # col idx -> img row idx
    prefix: str = "",
) -> Dict[str, float]:
    i2t_ranks_full = _rank_matrix(sim)
    i2t = np.full(sim.shape[0], np.inf)
    for i in range(sim.shape[0]):
        cols = img2txt.get(i, [])
        if cols:
            i2t[i] = i2t_ranks_full[i, cols].min()

    t2i_ranks_full = _rank_matrix(sim.T)
    t2i = np.asarray(
        [t2i_ranks_full[c, txt2img[c]] for c in range(sim.shape[1])],
        dtype=np.float64,
    )

    def report(name, ranks):
        return {
            f"{prefix}{name}_R@1": float(np.mean(ranks < 1)),
            f"{prefix}{name}_R@5": float(np.mean(ranks < 5)),
            f"{prefix}{name}_R@10": float(np.mean(ranks < 10)),
            f"{prefix}{name}_mean_rank": float(ranks.mean() + 1),
            f"{prefix}{name}_median_rank": float(np.floor(np.median(ranks)) + 1),
        }

    return {**report("text_to_image", t2i), **report("image_to_text", i2t)}


def _pad_rows(chunk: Any, n: int) -> Any:
    """Repeat the last row of a numpy array or tensor up to ``n`` rows."""
    real = chunk.shape[0]
    if real >= n:
        return chunk
    if isinstance(chunk, torch.Tensor):
        return torch.cat([chunk, chunk[-1:].expand(n - real, *chunk.shape[1:])])
    return np.concatenate([chunk, np.repeat(chunk[-1:], n - real, axis=0)])


def _to_numpy(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def encode_in_batches(fn: Callable, arrays: Any, batch_size: int,
                      chunk_transform: Optional[Callable] = None
                      ) -> np.ndarray:
    """Run an encoder over fixed-size batches (the last batch padded to the
    batch size).  ``chunk_transform`` maps each chunk before encoding (e.g.
    ``zero_shot.truncate_to_eot``)."""
    n = arrays.shape[0]
    outs = []
    for start in range(0, n, batch_size):
        chunk = arrays[start:start + batch_size]
        real = chunk.shape[0]
        chunk = _pad_rows(chunk, batch_size)
        if chunk_transform is not None:
            chunk = chunk_transform(chunk)
        outs.append(_to_numpy(fn(chunk))[:real])
    return np.concatenate(outs, axis=0)


def evaluate_retrieval(
    encode_image_fn: Callable,      # [B,H,W,3] -> normalized feats [B,D]
    encode_text_fn: Callable,       # [B,L] -> normalized feats [B,D]
    data: Any,                      # .captions .caption_ids .img2txt .txt2img
    image_loader,                   # yields ([B,H,W,3] images, img_ids)
    batch_size: int = 256,
    prefix: str = "",
    eot_truncate: bool = False,
) -> Dict[str, float]:
    """Full retrieval eval for one dataset.

    ``data`` needs ``captions`` ([n_txt, L] token ids), ``caption_ids``,
    ``img2txt`` ({image id: [caption ids]}) and ``txt2img`` ({caption id:
    [image ids]}).  ``eot_truncate`` slices each caption chunk at
    max(eot)+1, exact for the native causal tower (``truncate_to_eot``)."""
    chunk_tf = None
    if eot_truncate:
        from .zero_shot import truncate_to_eot

        chunk_tf = truncate_to_eot
    txt_feats = encode_in_batches(encode_text_fn, data.captions, batch_size,
                                  chunk_transform=chunk_tf)

    img_feats_list, img_ids_list = [], []
    for images, ids in image_loader:
        real = images.shape[0]
        feats = _to_numpy(encode_image_fn(_pad_rows(images, batch_size)))
        img_feats_list.append(feats[:real])
        img_ids_list.append(np.asarray(ids))
    img_feats = np.concatenate(img_feats_list)
    img_ids = np.concatenate(img_ids_list)

    sim = img_feats @ txt_feats.T

    # raw ids -> row / column indices
    img_row = {int(i): r for r, i in enumerate(img_ids)}
    cap_col = {int(c): col for col, c in enumerate(data.caption_ids)}
    img2txt = {
        img_row[i]: [cap_col[c] for c in caps if c in cap_col]
        for i, caps in data.img2txt.items()
        if i in img_row
    }
    txt2img = {
        cap_col[c]: img_row[imgs[0]]
        for c, imgs in data.txt2img.items()
        if c in cap_col and imgs[0] in img_row
    }
    return compute_retrieval_metrics(sim, img2txt, txt2img, prefix=prefix)


def get_clip_metrics(image_features: np.ndarray, text_features: np.ndarray,
                     logit_scale: float) -> Dict[str, float]:
    """In-batch diagonal ranking metrics."""
    logits_i = logit_scale * image_features @ text_features.T
    metrics = {}
    for name, logits in (("image_to_text", logits_i),
                         ("text_to_image", logits_i.T)):
        ranks = _rank_matrix(logits)
        preds = np.diagonal(ranks).astype(np.float64)
        metrics[f"{name}_mean_rank"] = preds.mean() + 1
        metrics[f"{name}_median_rank"] = np.floor(np.median(preds)) + 1
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float(np.mean(preds < k))
    return metrics
