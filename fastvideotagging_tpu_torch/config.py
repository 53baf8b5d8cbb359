"""Frozen configuration tree of the PyTorch port.

A copy of ``fastvideotagging_tpu/config.py`` (the port imports nothing of the
JAX package): the same dataclasses with the same defaults, except
``ModelConfig.kernels``, whose names and default are the port's own. A
preset may name a model or a setting the port cannot build yet; the
constructors raise for those.
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
    # 'batch'     -> BatchNorm, batch statistics in train mode
    # 'frozen'    -> running averages always (scale/bias still train)
    # 'group'     -> GroupNorm, no statistics (train == eval)
    # 'scaleonly' -> affine only, with weight standardization and SkipInit
    # (models/layers.py Norm; the r2plus1d family, tiny3d, r3d/mc3, S3D, I3D)
    norm: str = "batch"
    # Activation rematerialization on the residual blocks (r2plus1d family;
    # models/r2plus1d.py, REMAT_POLICIES): 'none'|'full'|'dots'|'mid'|'conv'.
    # Numerics-identical to 'none' (the same math, recomputed); a
    # training-memory knob only.
    remat: str = "none"


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 32
    num_epochs: int = 30
    base_lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 1e-4
    # Multi-factor LR schedule: multiply by lr_decay at each epoch in lr_steps.
    lr_steps: Tuple[int, ...] = (10, 20)
    lr_decay: float = 0.1
    warmup_epochs: int = 0
    # >0 clips gradients to this global L2 norm before SGD; 0 disables
    # (default: plain SGD).
    clip_grad_norm: float = 0.0
    # >1 averages the gradients of k micro steps and updates every k-th
    # (optax.MultiSteps semantics; train/state.py)
    grad_accum_steps: int = 1
    seed: int = 0
    log_every: int = 20
    checkpoint_dir: str = "checkpoints"  # "" disables checkpointing
    checkpoint_every_steps: int = 0  # 0 -> once per epoch
    resume: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh/partitioning config, kept field for field (parallel/mesh.py:
    one process a card, ``data_parallel * model_parallel`` of them).

    data_axis:  batch sharded over this axis, grads allreduced.
    model_axis: channel sharding for the dual-pathway stretch config.
    ``data_parallel = -1`` means "the processes of the job over
    model_parallel". The axis names are the JAX package's; the port's model
    group is a process group, not a name.
    """

    data_parallel: int = -1
    model_parallel: int = 1
    data_axis: str = "data"
    model_axis: str = "model"


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)


def _kinetics_data(**kw) -> DataConfig:
    return DataConfig(
        resize_hw=(256, 342),
        crop_hw=(224, 224),
        sampler=ClipSamplerConfig(clip_len=32, stride=2, eval_mode="uniform"),
        **kw,
    )


# The BASELINE.json configs as named presets, field for field as in the JAX
# package (``kernels`` takes the port's default).
PRESETS = {
    # C3D on one UCF101 clip: 16x112x112, batch 1, forward + sigmoid loss.
    "c3d_ucf101_smoke": ExperimentConfig(
        model=ModelConfig(name="c3d", num_classes=101, multilabel=True),
        train=TrainConfig(batch_size=1),
    ),
    # R(2+1)D-18 on UCF101: 16x112x112 clips, batch 32, full train step.
    "r2plus1d18_ucf101": ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=101),
        train=TrainConfig(batch_size=32),
    ),
    # UCF101 top-1 parity protocol: 128x171 resize -> center 112x112 crop,
    # 10 uniformly spaced eval clips per video, video-level top-1.
    "ucf101_parity": ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=101),
        data=DataConfig(
            sampler=ClipSamplerConfig(clip_len=16, eval_mode="uniform",
                                      num_eval_clips=10)),
        train=TrainConfig(batch_size=32),
    ),
    # P3D-63 / R(2+1)D-34 on Kinetics-400: 32x224x224, multi-clip eval.
    "p3d63_kinetics": ExperimentConfig(
        model=ModelConfig(name="p3d_63", num_classes=400),
        data=_kinetics_data(),
    ),
    "r2plus1d34_kinetics": ExperimentConfig(
        model=ModelConfig(name="r2plus1d_34", num_classes=400),
        data=_kinetics_data(),
    ),
    # Multi-label tagging: 1k-tag sigmoid head, dense clip sampling.
    "multilabel_tagging_1k": ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=1000, multilabel=True),
        data=DataConfig(sampler=ClipSamplerConfig(eval_mode="dense")),
    ),
    # SlowFast-style dual-pathway stretch, channel-sharded.
    "slowfast_stretch": ExperimentConfig(
        model=ModelConfig(name="slowfast_r2plus1d", num_classes=400),
        data=_kinetics_data(),
        parallel=ParallelConfig(model_parallel=2),
    ),
}
