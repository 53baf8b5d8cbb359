"""fastvideotagging_tpu_torch: the PyTorch / CUDA port of fastvideotagging_tpu.

It serves (the R(2+1)D eval forward, ``tag(video)`` and
``evaluation.tagger.iter_pack_tags``), evaluates (``evaluation.evaluate.
evaluate`` over a ``ClipDataset`` or a decode-once ``.fvtpack`` pack) and
trains (``python -m fastvideotagging_tpu_torch.cli.train`` / ``train.fit.fit``:
the loader, device prefetch, the train step, checkpoints and resume),
with the factorized (2+1)D convs and their gradients on hand-written Hopper
kernels (csrc/). ``ops.fused_infer.r2plus1d_fused_infer``, the fused serving
engine, runs each stride-1 (2+1)D pair with its BatchNorm and ReLU as one
kernel (K4). It deploys through ``cli.export``: a ``torch.export`` artifact,
or an AOTInductor package that the C++ runner (csrc/native_runner.cpp,
``native.runner``, ``evaluation.native_tagger``) serves with no Python in its
process. It imports neither JAX nor the JAX package. Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from fastvideotagging_tpu_torch.config import (
    PRESETS,
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from fastvideotagging_tpu_torch.evaluation.tagger import Tagger, tag
from fastvideotagging_tpu_torch.models import get_model, list_models, model_from_config

__all__ = ["__version__", "ClipSamplerConfig", "DataConfig", "ExperimentConfig",
           "ModelConfig", "PRESETS", "ParallelConfig", "Tagger", "TrainConfig", "get_model",
           "list_models", "model_from_config", "tag"]
