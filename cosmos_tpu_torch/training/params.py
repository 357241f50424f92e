"""The trainer's flags (counterpart of ``cosmos_tpu/training/params.py``).

The same flag surface as the JAX trainer: the same names, ``dest``s and
defaults, and the same checks between flags, so one launch script drives
either trainer.  Flags whose feature the port does not have yet parse here
and are refused at start-up by ``training/main.py`` (``UNPORTED``).

Per-model default hyperparameters: ViT lr 5e-4, betas (0.9, 0.98), eps
1e-6.
"""

from __future__ import annotations

import argparse
import json


def get_default_params(model_name: str):
    model_name = model_name.replace("/", "-")
    if "vit" in model_name.lower():
        return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.98, "eps": 1.0e-6}
    return {"lr": 5.0e-4, "beta1": 0.9, "beta2": 0.999, "eps": 1.0e-8}


class ParseKwargs(argparse.Action):
    """--aug-cfg key=val parser."""

    def __call__(self, parser, namespace, values, option_string=None):
        kw = {}
        for value in values:
            key, val = value.split("=")
            try:
                kw[key] = json.loads(val)
            except json.JSONDecodeError:
                kw[key] = val
        setattr(namespace, self.dest, kw)


def parse_args(args=None):
    parser = argparse.ArgumentParser("cosmos_tpu_torch trainer")
    add = parser.add_argument

    # data
    add("--train-data", type=str, default=None)
    add("--train-data-upsampling-factors", type=str, default=None)
    add("--val-data", type=str, default=None)
    add("--train-eval-data", type=str, default=None,
        help="webdataset shards FROM THE TRAIN DISTRIBUTION to run the "
             "val-loss eval on each --val-frequency epoch (overfitting "
             "monitor; reference data.py:923-925, train.py:365-374)")
    add("--train-num-samples", type=int, default=None)
    add("--val-num-samples", type=int, default=None)
    add("--train-val-num-samples", type=int, default=5120,
        help="samples drawn from --train-eval-data per eval (the "
             "reference caps its train_eval splits at 5120)")
    add("--dataset-type", choices=["webdataset", "csv", "coco", "synthetic", "auto"],
        default="auto")
    add("--dataset-resampled", default=False, action="store_true")
    add("--csv-separator", type=str, default="\t")
    add("--csv-img-key", type=str, default="filepath")
    add("--csv-caption-key", type=str, default="title")
    add("--data-root-dir", type=str, default=None,
        help="root dir for COCO/Flickr retrieval eval data")
    add("--imagenet-val", type=str, default=None)
    add("--imagenet-v2", type=str, default=None)
    add("--classification-data-dir", type=str, default=None,
        help="root containing the 10 extra classification datasets")
    add("--zeroshot-eval-datasets", type=str, default="",
        help="comma list of extra classification datasets to eval")
    add("--workers", type=int, default=4)

    # experiment
    add("--logs-dir", type=str, default="./logs/")
    add("--log-local", action="store_true", default=False)
    add("--name", type=str, default=None)
    add("--seed", type=int, default=0)

    # training
    add("--batch-size", type=int, default=64, help="per-device batch size")
    add("--epochs", type=int, default=32)
    add("--epochs-cooldown", type=int, default=None)
    add("--steps-per-epoch", type=int, default=None,
        help="override; else train_num_samples // global_batch")
    add("--lr", type=float, default=None)
    add("--beta1", type=float, default=None)
    add("--beta2", type=float, default=None)
    add("--eps", type=float, default=None)
    add("--wd", type=float, default=0.2)
    add("--warmup", type=int, default=10000)
    add("--lr-scheduler", type=str, default="cosine",
        choices=["cosine", "const", "const-cooldown"])
    add("--lr-cooldown-end", type=float, default=0.0)
    add("--lr-cooldown-power", type=float, default=1.0)
    add("--grad-clip-norm", type=float, default=None)
    add("--log-grad-norm", action="store_true", default=False,
        help="report the global gradient norm every step even without "
             "clipping (costs a second read of every grad leaf, ~6% "
             "step time; with --grad-clip-norm it is free and always on)")
    add("--skip-scheduler", action="store_true", default=False,
        help="constant base LR — no warmup or decay (reference "
             "train.py:103 skips the per-step scheduler call)")
    add("--accum-freq", type=int, default=1)
    add("--precision", type=str, default="amp",
        choices=["amp", "amp_bf16", "bf16", "pure_bf16", "fp32", "fp16"])
    add("--grad-checkpointing", action="store_true", default=False)
    # the JAX package's policy name for --grad-checkpointing ("" = full
    # recompute), mapped to selective checkpointing (models/transformer.py
    # REMAT_POLICIES); e.g. dots_with_no_batch_dims_saveable keeps the
    # matmul outputs and recomputes the rest, the kernels (K1) among it
    add("--remat-policy", type=str, default="")
    add("--local-loss", action="store_true", default=False,
        help="compute [B_local, B_global] logit rows per rank")
    # default True, as in the JAX package (the reference's is False): the
    # gather's backward sums the features' gradients across ranks, which
    # gives the same total gradient as a no-grad gather with the local
    # block spliced in (losses/contrastive.py)
    add("--gather-with-grad", action=argparse.BooleanOptionalAction,
        default=True)
    add("--force-quick-gelu", action="store_true", default=False)
    add("--force-patch-dropout", type=float, default=None)
    add("--force-image-size", type=int, default=None)
    # routing of self-attention to the packed-QKV kernel (K1 forward, K2
    # backward): 'auto' (default) and 'on' take it wherever its gate
    # admits the geometry (on a CPU tensor through the kernels' plain
    # versions); 'off' sends every self-attention to the plain torch path
    add("--flash-attention", type=str, default="auto",
        choices=["auto", "on", "off"])
    add("--use-flash-attention", action="store_true", default=False,
        help="deprecated alias for --flash-attention on")
    add("--trace", action="store_true", default=False,
        help="export the normalised encoders at --batch-size with "
             "torch.export (<trace-path>/encode_{image,text}.pt2, weights "
             "inside; models/trace.py) before training")
    add("--trace-path", type=str, default=None,
        help="where --trace writes (default <logs>/<name>/traced)")
    add("--gelu-approx", action="store_true", default=False,
        help="tanh-approximated GELU (a small numeric deviation from "
             "the exact GELU; for from-scratch training)")
    add("--text-bucket", type=int, default=0,
        help="length-bucketed text tower for COSMOS training (>0 = short "
             "bucket length, e.g. 32): EOT-sorts the caption views past "
             "the 2 globals and runs the shortest 3/4 at this length when "
             "they fit. Mathematically exact under causal masking + "
             "argmax-EOT pooling (see models/clip.py); cuts the padding "
             "FLOPs the reference pays at context 77 for single-sentence "
             "textcrop captions")

    # model
    add("--model", type=str, default="ViT-B-16")
    add("--pretrained", type=str, default="")
    add("--pool-type", type=str, default=None, choices=["tok", "avg", "none"],
        help="override the vision pooling type (reference params.py:566-571)."
             " Default keeps the model config's pool_type: the reference "
             "stomps it with 'tok' unconditionally (factory.py:271), which "
             "would silently break MAP-pooled SigLIP configs here")
    add("--force-custom-text", action="store_true", default=False,
        help="accepted for launch-script parity (reference factory.py:286 "
             "picks the CustomTextCLIP class, a state-dict-layout choice); "
             "this framework has one unified model class, so it is a no-op")
    add("--pretrained-image", action="store_true", default=False,
        help="reference downloads timm-pretrained image towers at "
             "construction (factory.py:259-264); unsupported here — load "
             "a converted timm checkpoint via --pretrained instead")
    add("--lock-image", action="store_true", default=False)
    add("--lock-image-unlocked-groups", type=int, default=0)
    add("--lock-text", action="store_true", default=False)
    add("--lock-text-unlocked-layers", type=int, default=0,
        help="leave the last n text resblocks (+ ln_final/text_projection) "
             "trainable under --lock-text (reference params.py:441-445)")
    # the reference pairs these with freeze-RUNNING-STATS semantics; in JAX
    # LN has no running stats and frozen-BN stats never update unless
    # passed as mutable, so only the param-freezing half has effect here
    add("--lock-text-freeze-layer-norm", action=argparse.BooleanOptionalAction,
        default=None,
        help="freeze LayerNorm params inside locked text modules.  Unset "
             "= reference-exact per tower (native towers always freeze "
             "them, transformer.py:881-883; HF towers leave them "
             "trainable, hf_model.py:174 under the reference CLI "
             "default); --lock-text-freeze-layer-norm / "
             "--no-lock-text-freeze-layer-norm force either behavior")
    add("--lock-image-freeze-bn-stats", action="store_true", default=False,
        help="accepted for launch-script parity; BN running stats are "
             "frozen by construction in this framework (PARITY.md)")
    add("--aug-cfg", nargs="*", default={}, action=ParseKwargs)
    # preprocessing overrides (reference params.py:258-271): train-side
    # normalization is fused into the jitted step (TrainStepConfig
    # image_mean/std); eval transforms honor all four via
    # data.transforms.eval_transform_from_args
    add("--image-mean", type=float, nargs="+", default=None, metavar="MEAN",
        help="override the dataset image mean (e.g. 0 0 0 for MobileCLIP)")
    add("--image-std", type=float, nargs="+", default=None, metavar="STD",
        help="override the dataset image std")
    add("--image-interpolation", type=str, default=None,
        choices=("bicubic", "bilinear", "random"),
        help="eval resize interpolation ('random' maps to bicubic at "
             "inference, matching the reference transform.py:301)")
    add("--image-resize-mode", type=str, default=None,
        choices=("shortest", "longest", "squash"),
        help="eval resize (& crop) mode")
    add("--alpha-init-weight", type=float, default=0.8,
        help="accepted for launch-script parity: the reference defines it "
             "(params.py:543-546) for a 'DINOtokenwise' scheduler that "
             "exists nowhere in its codebase — consumed by no code path "
             "there or here")
    add("--siglip", action="store_true", default=False)
    add("--coca-caption-loss-weight", type=float, default=2.0)
    add("--coca-contrastive-loss-weight", type=float, default=1.0)

    # model distillation from a second frozen CLIP (reference
    # params.py:495-502, main.py:289-296): both flags or neither
    add("--distill-model", type=str, default=None)
    add("--distill-pretrained", type=str, default=None)

    # COSMOS augmentation + distillation (params.py:275-560)
    add("--use-imagecrop-aug", action="store_true", default=False)
    add("--global-crops-number", type=int, default=2)
    add("--local-crops-number", type=int, default=6)
    add("--crop-scale", type=float, default=0.4)
    add("--num-sampled-captions", type=int, default=8)
    add("--caption-sampling-mode", type=str, default="raw",
        choices=["raw", "raw_pixelprose", "random", "random_pixelprose",
                 "short", "long", "textcrop", "textcrop_pixelprose"])
    add("--momentum-teacher", type=float, default=0.999)
    add("--fix-momentum", action="store_true", default=False)
    add("--cosmos", action="store_true", default=False)
    add("--output-all", action="store_true", default=False)
    add("--attentional-pool", action="store_true", default=False)
    add("--attn-pooler-heads", type=int, default=8)
    add("--add-zero-attn", action="store_true", default=False)
    add("--init-last-layer", action="store_true", default=False,
        help="re-draw the last transformer block's weights in both towers "
             "(student and teacher get independent draws, main.py:281-283)")

    # segmentation eval (params.py:591-601)
    add("--use-csa", action="store_true", default=False)
    add("--seg-w-background", action="store_true", default=False)

    # checkpointing / resume (main.py:150-214)
    add("--checkpoint-path", type=str, default=None)
    add("--resume", type=str, default=None, help="path or 'latest'")
    add("--save-frequency", type=int, default=1)
    add("--save-most-recent", action="store_true", default=False)
    add("--delete-previous-checkpoint", action="store_true", default=False)
    add("--remote-sync", type=str, default=None)
    add("--remote-sync-frequency", type=int, default=300)
    add("--remote-sync-protocol", type=str, default="s3",
        choices=["s3", "fsspec"])
    add("--huggingface-model-name", type=str, default="")
    add("--huggingface-repo-name", type=str, default="sankim2/cosmos")

    # eval control
    add("--val-frequency", type=int, default=1)
    add("--zeroshot-frequency", type=int, default=2)
    add("--retrieval-frequency", type=int, default=1)
    add("--eval-mode", type=str, default="",
        choices=["", "retrieval", "classification", "segmentation"])
    add("--eval-teacher", action=argparse.BooleanOptionalAction,
        default=True,
        help="also evaluate the EMA teacher (reference evaluates both); "
             "--no-eval-teacher for student-only eval")
    add("--use-ema-model", dest="eval_teacher", action="store_true",
        default=argparse.SUPPRESS,
        help="reference alias (params.py:585-588, consumed by its "
             "clip_segmentor.py:81) for --eval-teacher")

    # logging
    add("--log-every-n-steps", type=int, default=100)
    add("--report-to", type=str, default="",
        help="comma list: tensorboard,wandb")
    add("--wandb-project-name", type=str, default="cosmos-tpu")
    add("--wandb-entity-name", type=str, default=None)
    add("--wandb-notes", type=str, default="")
    add("--wandbkeyword", type=str, default="",
        help="extra 'key_<word>' segment in the auto experiment name "
             "(reference main.py:117)")
    add("--copy-codebase", action="store_true", default=False,
        help="snapshot the cosmos_tpu package into <logs>/<name>/code "
             "for reproducibility (reference main.py:604-619)")
    add("--debug", action="store_true", default=False)
    add("--profile-steps", type=int, default=0,
        help="trace the first N train steps of the first epoch with "
             "torch.profiler (host and card) into "
             "<logs>/<name>/profile/rank<r>.trace.json, a Chrome trace")

    add("--prefetch-depth", type=int, default=2,
        help="device-input prefetch depth (data/prefetch.py): a producer "
             "thread copies the next N batches to the card from pinned "
             "memory on a stream of its own, so the copy overlaps the "
             "step; 0 disables")

    add("--fsdp", action="store_true", default=False,
        help="shard parameters, gradients, optimizer state and the EMA "
             "teacher over the ranks (not ported yet: refused)")

    add("--num-slices", type=int, default=1,
        help="groups of ranks with a hierarchical contrastive gather, "
             "within each group first (not ported yet: refused)")
    add("--gather-scope", type=str, default="global",
        choices=["global", "slice"],
        help="with --num-slices: 'global' gathers negatives from every "
             "rank, 'slice' within each group (not ported yet: refused)")

    # ranks
    add("--mesh-shape", type=str, default=None,
        help="'N': the data axis, N ranks of one card each (the world "
             "size); 'dp,tp' with tp > 1, tensor parallelism, is not "
             "ported yet (refused)")
    add("--coordinator-address", type=str, default=None)
    add("--num-processes", type=int, default=None)
    add("--process-id", type=int, default=None)

    ns = parser.parse_args(args)

    # per-model default hyperparams
    defaults = get_default_params(ns.model)
    for name, val in defaults.items():
        if getattr(ns, name) is None:
            setattr(ns, name, val)

    # COSMOS distillation pairs the teacher against 2 caption views;
    # raw-mode sampling yields a single caption, which would silently
    # corrupt the distill loss (the reference asserts 2 views, loss.py:189).
    # TRAINING-only: eval-only runs (--eval-mode, or no train data at all —
    # the inference scripts load released weights with the default 'raw'
    # mode) never build the distill loss and must not be rejected.
    will_train = not ns.eval_mode and (
        ns.train_data is not None or ns.dataset_type == "synthetic"
    )
    if will_train and ns.cosmos and ns.caption_sampling_mode in (
            "raw", "raw_pixelprose"):
        parser.error(
            "--cosmos requires >=2 caption views: use "
            "--caption-sampling-mode textcrop/random (+ --num-sampled-captions >= 2), "
            f"not {ns.caption_sampling_mode!r}"
        )
    if will_train and ns.cosmos and ns.num_sampled_captions < 2:
        parser.error("--cosmos requires --num-sampled-captions >= 2")
    # the COSMOS loss consumes cross-modal token features, which only exist
    # with the token-mapping heads and cross-attention poolers enabled
    # (reference train scripts always pass the three flags together,
    # train_cc3m.sh:36-38; without them the loss would KeyError mid-trace)
    if ns.cosmos and not (ns.output_all and ns.attentional_pool):
        parser.error(
            "--cosmos requires --output-all and --attentional-pool "
            "(the cross-modality heads the COSMOS loss distills through)"
        )
    # model distillation (reference main.py:232-240: distill excludes the
    # COSMOS teacher path and gradient accumulation)
    ns.distill = bool(ns.distill_model and ns.distill_pretrained)
    if bool(ns.distill_model) != bool(ns.distill_pretrained):
        parser.error(
            "--distill-model and --distill-pretrained must be given together"
        )
    if ns.distill and (ns.cosmos or ns.siglip):
        parser.error("--distill-model is incompatible with --cosmos/--siglip")
    if ns.distill and ns.accum_freq != 1:
        parser.error("--distill-model requires --accum-freq 1")
    if "coca" in ns.model.lower() and (ns.cosmos or ns.siglip or ns.distill):
        parser.error("CoCa models train with the CoCa loss only")
    if "coca" in ns.model.lower() and will_train and ns.use_imagecrop_aug:
        # the CoCa step trains on single-view batches (crop 0 / caption 0,
        # train.py coca branch; reference coca recipe uses plain
        # transforms, coca_model.py:157-191) — multicrop would decode and
        # copy 6 local crops per sample to the card that the step never
        # reads: pure wasted host work.  Fail loudly instead.
        parser.error(
            "--use-imagecrop-aug with a CoCa model: the CoCa caption loss "
            "trains on single-view batches and would silently discard the "
            "local crops after paying their decode + transfer cost; drop "
            "--use-imagecrop-aug (and --local-crops-number)"
        )
    if ns.pretrained_image:
        parser.error(
            "--pretrained-image downloads timm weights at construction in "
            "the reference (factory.py:259-264); unsupported here — convert "
            "a timm checkpoint offline and pass it via --pretrained"
        )
    # legacy alias folds into the tri-state
    if ns.use_flash_attention:
        ns.flash_attention = "on"
    return ns
