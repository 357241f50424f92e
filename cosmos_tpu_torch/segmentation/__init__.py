"""Open-vocabulary segmentation evals (counterpart of
``cosmos_tpu/segmentation``): the benchmarks' configs, the mmseg-layout
dataset, ``IoUMetric``, PAMR and ``CLIPSegmentor``.  The CLI is
``python -m cosmos_tpu_torch.training.seg_eval``."""

from .configs import (SEG_BENCHMARKS, WITH_BACKGROUND,  # noqa: F401
                      WITHOUT_BACKGROUND, SegBenchmark)
from .dataset import SegDataset  # noqa: F401
from .metrics import IoUMetric  # noqa: F401
from .pamr import pamr  # noqa: F401
from .segmentor import CLIPSegmentor, load_seg_classnames  # noqa: F401
