"""P3D backbone (Qiu et al. ICCV'17, "Pseudo-3D Residual Networks"), the
counterpart of ``fastvideotagging_tpu/models/p3d.py``.

ResNet bottlenecks with three pseudo-3D block variants cycled A -> B -> C:

    reduce 1x1x1 -> { A: T(S(x)) serial
                    , B: S(x) + T(x) parallel sum
                    , C: S(x) + T(S(x)) serial with skip } -> expand 1x1x1

where S = spatial 1x3x3 conv and T = temporal 3x1x1 conv, each followed by
BN + ReLU. Depths: p3d_63 [3,4,6,3], p3d_131 [3,4,23,3], p3d_199
[3,8,36,3]. Stem: 1x7x7 s(1,2,2) conv-BN-ReLU + 2x3x3 maxpool s(2,2,2).
Spatial stride 2 at stages 2-4, in the reduce conv; T is cut only by the
stem pool (32 frames -> 16 through every stage).

S and T are ``SpatialConv`` / ``TemporalConv`` at stride 1: with
``backend='cuda'`` they go to K1 / K2 (and K3 for T's weight gradient),
wherever ops/conv2plus1d.py's routing takes them. The 1x1x1 convs and the
stem are the library's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import (
    Conv3D,
    Norm,
    SpatialConv,
    TemporalConv,
    dense,
    dropout,
    global_avg_pool_3d,
    max_pool_3d,
)

BLOCK_CYCLE = "ABC"


class BottleneckP3D(nn.Module):
    def __init__(self, cin: int, planes: int, block_type: str, spatial_stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if block_type not in BLOCK_CYCLE:
            raise ValueError(f"unknown P3D block type {block_type!r}")
        self.block_type = block_type
        s = spatial_stride
        cout = planes * 4
        g = generator
        self.reduce = Conv3D(cin, planes, (1, 1, 1), strides=(1, s, s), dtype=dtype,
                             generator=g)
        self.bn_reduce = Norm(planes, dtype=dtype)
        self.spatial = SpatialConv(planes, planes, 3, backend=backend, dtype=dtype,
                                   generator=g)
        self.temporal = TemporalConv(planes, planes, 3, backend=backend, dtype=dtype,
                                     generator=g)
        self.bn_s = Norm(planes, dtype=dtype)
        self.bn_t = Norm(planes, dtype=dtype)
        self.expand = Conv3D(planes, cout, (1, 1, 1), dtype=dtype, generator=g)
        self.bn_expand = Norm(cout, dtype=dtype)
        self.downsample = self.bn_down = None
        if s != 1 or cin != cout:
            self.downsample = Conv3D(cin, cout, (1, 1, 1), strides=(1, s, s), dtype=dtype,
                                     generator=g)
            self.bn_down = Norm(cout, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn_reduce(self.reduce(x)))
        if self.block_type == "A":
            y = torch.relu(self.bn_s(self.spatial(y)))
            y = torch.relu(self.bn_t(self.temporal(y)))
        elif self.block_type == "B":
            y = (torch.relu(self.bn_s(self.spatial(y)))
                 + torch.relu(self.bn_t(self.temporal(y))))
        else:
            ys = torch.relu(self.bn_s(self.spatial(y)))
            y = ys + torch.relu(self.bn_t(self.temporal(ys)))
        y = self.bn_expand(self.expand(y))
        residual = x if self.downsample is None else self.bn_down(self.downsample(x))
        return torch.relu(y + residual)


class P3D(nn.Module):
    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), num_classes: int = 400,
                 backend: str = "cuda", dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.stage_blocks = tuple(stage_blocks)
        self.dtype = dtype
        self.dropout = dropout
        g = generator
        self.stem_conv = Conv3D(3, 64, (1, 7, 7), strides=(1, 2, 2), dtype=dtype, generator=g)
        self.stem_bn = Norm(64, dtype=dtype)
        cin, idx = 64, 0
        self.block_names = []
        for stage, num_blocks in enumerate(self.stage_blocks):
            planes = 64 * (2 ** stage)
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, BottleneckP3D(
                    cin, planes, BLOCK_CYCLE[idx % 3], spatial_stride=stride,
                    backend=backend, dtype=dtype, generator=g))
                self.block_names.append(name)
                idx += 1
                cin = planes * 4
        self.fc = dense(cin, num_classes, g)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask."""
        x = torch.relu(self.stem_bn(self.stem_conv(x.to(self.dtype))))
        # symmetric (0, 1, 1) pads: torch/MXNet max-pool semantics
        x = max_pool_3d(x, (2, 3, 3), strides=(2, 2, 2), padding=((0, 0), (1, 1), (1, 1)),
                        train=self.training)
        for name in self.block_names:
            x = getattr(self, name)(x)
        x = dropout(global_avg_pool_3d(x), self.dropout, self.training, generator)
        return self.fc(x.float())
