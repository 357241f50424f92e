"""The lists of HF model types the port's ``models/hf_arch.py`` refuses by,
in the JAX package's order of checks (``cosmos_tpu/models/hf_model.py``
``resolve_hf_config``, ``resolve_hf_module_cls``), taken from
``transformers``:

- ``known``: the keys of ``CONFIG_MAPPING`` in its order, which
  ``AutoConfig.for_model``'s ``ValueError`` for an unknown type names;
- ``encoder_decoder``: the types whose config is encoder-decoder by
  default;
- ``flax``: the types ``FlaxAutoModel`` maps (``FLAX_MODEL_MAPPING_NAMES``).

``PYTHONPATH=. python tests/torch_hf_types.py`` rewrites
``cosmos_tpu_torch/assets/hf_model_types.json`` from the installed
``transformers``; ``tests/test_torch_hf_refusals.py`` pins the file.  The
script sets ``HF_HUB_OFFLINE`` before it imports ``transformers``: a few
configs (``edgetam``) build a sub-config from the hub, and then fail here
without reaching it; they count as not encoder-decoder.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

ASSET = (Path(__file__).resolve().parent.parent / "cosmos_tpu_torch"
         / "assets" / "hf_model_types.json")


def encoder_decoder(config_class) -> bool:
    """Whether ``config_class()`` is encoder-decoder (False where it does
    not build with its defaults)."""
    try:
        return bool(getattr(config_class(), "is_encoder_decoder", False))
    except Exception:
        return False


def generate() -> dict:
    import transformers
    from transformers import CONFIG_MAPPING
    from transformers.models.auto.modeling_flax_auto import \
        FLAX_MODEL_MAPPING_NAMES

    known = list(CONFIG_MAPPING.keys())
    return {"transformers": transformers.__version__,
            "known": known,
            "encoder_decoder": [k for k in known
                                if encoder_decoder(CONFIG_MAPPING[k])],
            "flax": list(FLAX_MODEL_MAPPING_NAMES)}


if __name__ == "__main__":
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
    types = generate()
    ASSET.write_text(json.dumps(types, indent=0) + "\n")
    print(ASSET, {k: len(v) for k, v in types.items()
                  if isinstance(v, list)})
