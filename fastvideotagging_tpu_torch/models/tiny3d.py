"""Tiny 3D-CNN debug backbone (the counterpart of
``fastvideotagging_tpu/models/tiny3d.py``); not part of the reference
surface.

Used by the fit and pipeline tests, where a full backbone would dominate
the wall clock. It exercises the same structural elements: conv3d, BN,
striding, global pool. Its convs are the library's (``layers.Conv3D``), so
it runs no hand kernel. Module names follow the JAX tree (``conv1.kernel``,
``bn1.scale``, ``fc``), so models/convert.py maps one onto the other.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import (
    Conv3D,
    Norm,
    dense,
    global_avg_pool_3d,
)


class Tiny3D(nn.Module):
    def __init__(self, num_classes: int = 10, width: int = 16,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.dtype = dtype
        ws = norm == "scaleonly"  # the stats-free mode standardizes kernels
        self.conv1 = Conv3D(3, width, (3, 3, 3), strides=(1, 2, 2), ws=ws, dtype=dtype,
                            generator=generator)
        self.bn1 = Norm(width, kind=norm, dtype=dtype)
        self.conv2 = Conv3D(width, width * 2, (3, 3, 3), strides=(2, 2, 2), ws=ws,
                            dtype=dtype, generator=generator)
        self.bn2 = Norm(width * 2, kind=norm, dtype=dtype)
        self.fc = dense(width * 2, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` is accepted for the train step's call and unused:
        the model has no dropout."""
        x = torch.relu(self.bn1(self.conv1(x.to(self.dtype))))
        x = torch.relu(self.bn2(self.conv2(x)))
        return self.fc(global_avg_pool_3d(x).float())
