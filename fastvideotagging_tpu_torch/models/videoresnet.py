"""R3D / MC3 backbones, the full-3D and mixed-convolution siblings of
R(2+1)D (Tran et al. CVPR'18); the counterpart of
``fastvideotagging_tpu/models/videoresnet.py``, in torchvision's
VideoResNet layout (r3d_18 / mc3_18).

- r3d_18: stem Conv3d(3x7x7, s(1,2,2)) -> 64; four BasicBlock stages of
  full 3x3x3 convs, stride (2,2,2) at each later stage's entry.
- mc3_18: the same stem and stage 1; stages 2-4 use 1x3x3 ("no_t") convs
  with stride (1,2,2) at entry.

Every conv is the library's (no factorized conv, so no hand kernel).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import (
    Conv3D,
    Norm,
    dense,
    dropout,
    global_avg_pool_3d,
)

CONV_TYPES = ("3d", "no_t")


class Block3D(nn.Module):
    """VideoResNet BasicBlock with a full-3D or no-temporal conv type."""

    def __init__(self, cin: int, features: int, stride: int = 1, conv_type: str = "3d",
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if conv_type not in CONV_TYPES:
            raise ValueError(f"conv_type {conv_type!r} not in {CONV_TYPES}")
        kernel = (3, 3, 3) if conv_type == "3d" else (1, 3, 3)

        def strides(s):  # torchvision's get_downsample_stride, too
            return (s, s, s) if conv_type == "3d" else (1, s, s)

        g = generator
        self.conv1 = Conv3D(cin, features, kernel, strides=strides(stride), dtype=dtype,
                            generator=g)
        self.bn1 = Norm(features, kind=norm, dtype=dtype)
        self.conv2 = Conv3D(features, features, kernel, dtype=dtype, generator=g)
        self.bn2 = Norm(features, kind=norm, dtype=dtype)
        self.downsample = self.bn_down = None
        if stride != 1 or cin != features:
            self.downsample = Conv3D(cin, features, (1, 1, 1), strides=strides(stride),
                                     dtype=dtype, generator=g)
            self.bn_down = Norm(features, kind=norm, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.bn_down(self.downsample(x))
        return torch.relu(y + residual)


class VideoResNet3D(nn.Module):
    """r3d_18 / mc3_18 (torchvision VideoResNet layout, NTHWC)."""

    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 stage_conv_types: Sequence[str] = ("3d", "3d", "3d", "3d"),
                 num_classes: int = 101, dropout: float = 0.0,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.dtype = dtype
        self.dropout = dropout
        g = generator
        self.stem_conv = Conv3D(3, 64, (3, 7, 7), strides=(1, 2, 2), dtype=dtype, generator=g)
        self.stem_bn = Norm(64, kind=norm, dtype=dtype)
        cin = 64
        self.block_names = []
        for stage, (num_blocks, conv_type) in enumerate(zip(stage_blocks, stage_conv_types)):
            features = 64 * (2 ** stage)
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, Block3D(cin, features, stride=stride,
                                              conv_type=conv_type, dtype=dtype, norm=norm,
                                              generator=g))
                self.block_names.append(name)
                cin = features
        self.fc = dense(cin, num_classes, g)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask."""
        x = torch.relu(self.stem_bn(self.stem_conv(x.to(self.dtype))))
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = dropout(global_avg_pool_3d(x), self.dropout, self.training, generator)
        return self.fc(x.float())
