"""Frozen configuration tree of the PyTorch port.

A copy of ``fastvideotagging_tpu/config.py`` (the port imports nothing of the
JAX package): the same dataclasses with the same defaults, except
``ModelConfig.kernels``, whose names and default are the port's own.
``TrainConfig``, ``ParallelConfig`` (and their ``ExperimentConfig`` fields)
and ``PRESETS`` wait for the training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ClipSamplerConfig:
    """Clip sampling semantics (the golden-spec component).

    clip_len:   number of frames per clip (T).
    stride:     temporal stride between sampled frames.
    train_mode: 'random'  — random start offset (seeded per (epoch, sample)).
    eval_mode:  'center'  — single centered clip,
                'uniform' — num_eval_clips starts evenly spaced over the video,
                'dense'   — consecutive non-overlapping windows covering the video.
    """

    clip_len: int = 16
    stride: int = 1
    train_mode: str = "random"
    eval_mode: str = "center"
    num_eval_clips: int = 10


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Decode + preprocess pipeline config."""

    root: str = ""
    train_list: str = ""
    val_list: str = ""
    # Decoded source size the loader ships to the device. If set, frames go
    # to the device raw and the device does the (spec-exact) resize; if None,
    # the host pre-resizes to resize_hw and the device resize is an identity.
    source_hw: Optional[Tuple[int, int]] = None
    # Resize target (height, width) before cropping. (128, 171) is the
    # canonical C3D/UCF101 geometry (Tran'15); Kinetics configs use (256, 342).
    resize_hw: Tuple[int, int] = (128, 171)
    crop_hw: Tuple[int, int] = (112, 112)
    # Per-channel RGB normalization in [0,1] units.
    mean: Tuple[float, float, float] = (0.43216, 0.394666, 0.37645)
    std: Tuple[float, float, float] = (0.22803, 0.22145, 0.216989)
    random_flip: bool = True
    host_crop: bool = False
    num_workers: int = 8
    prefetch_depth: int = 2
    cache_mb: int = 0
    cache_on_device: bool = False
    sampler: ClipSamplerConfig = dataclasses.field(default_factory=ClipSamplerConfig)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "r2plus1d_18"
    num_classes: int = 101
    multilabel: bool = False  # sigmoid tag head vs softmax CE
    dropout: float = 0.5
    # 'cuda'  -> the hand-written Hopper kernels for the factorized (2+1)D
    #            convs (ops/conv2plus1d.py; the counterpart of 'pallas')
    # 'torch' -> F.conv3d for every conv (the counterpart of 'xla')
    # The JAX package defaults to 'xla' on TPU v5e measurements, which say
    # nothing about an H100; the port's default is its own kernels.
    kernels: str = "cuda"
    compute_dtype: str = "bfloat16"  # params stay f32; compute in bf16
    # 'batch' | 'frozen' (eval-identical in this slice); other kinds wait
    # for the training slice.
    norm: str = "batch"
    remat: str = "none"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
