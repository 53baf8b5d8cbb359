"""I3D, the two-stream inflated 3D ConvNet's RGB stream (Carreira &
Zisserman CVPR'17); the counterpart of ``fastvideotagging_tpu/models/i3d.py``,
in the layout of the pytorch-i3d port of the DeepMind checkpoint.

- stem 7x7x7 stride-2 conv; (1,3,3) s(1,2,2) maxpool; 1x1x1 conv; 3x3x3
  conv; maxpool; nine Inception blocks (S3D's ``_INCEPTION_BLOCKS`` widths)
  with (3,3,3) s2 and (2,2,2) s2 maxpools between stages; BN epsilon 1e-3.
- Padding is TF-SAME (``tf_same_pads``: the extra element high when the
  total pad is odd), computed per call from the input's shape. An
  asymmetric pad is an ``F.pad`` before the conv (``F.conv3d`` pads
  symmetrically only) and a -inf pad before a pool.
- Head: S3D's (``s3d.head_mean``) -> dropout -> Dense ``fc`` in f32.

Every conv is a full 3D conv and the library's; I3D runs no hand kernel.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import Conv3D, Norm, dense, dropout
from fastvideotagging_tpu_torch.models.s3d import (
    _INCEPTION_BLOCKS,
    head_mean,
    inception_out,
)
from fastvideotagging_tpu_torch.ops.maxpool_grad import max_pool_nthwc


def max_pool_same(x: torch.Tensor, window, strides, train: bool = False) -> torch.Tensor:
    """TF-SAME max-pool over (T, H, W) (ops/maxpool_grad.py: separable in
    train mode, one 3D window in eval)."""
    return max_pool_nthwc(x, tuple(window), tuple(strides), "SAME", train=train)


class Unit3D(nn.Module):
    """conv (TF-SAME, no bias) + BN (epsilon 1e-3) + ReLU."""

    def __init__(self, cin: int, features: int, kernel=(1, 1, 1), stride=(1, 1, 1),
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = Conv3D(cin, features, kernel, strides=stride, padding="SAME",
                           dtype=dtype, generator=generator)
        self.bn = Norm(features, kind=norm, epsilon=1e-3, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class Inception3D(nn.Module):
    """Inception block with full-3D 3x3x3 branches (the unfactorized
    sibling of s3d.SepInception; same widths and concat order)."""

    def __init__(self, cin: int, widths, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch", generator: torch.Generator | None = None):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3 = widths
        kw = dict(dtype=dtype, norm=norm, generator=generator)
        self.b0 = Unit3D(cin, c0, **kw)
        self.b1_reduce = Unit3D(cin, c1a, **kw)
        self.b1_conv = Unit3D(c1a, c1b, kernel=(3, 3, 3), **kw)
        self.b2_reduce = Unit3D(cin, c2a, **kw)
        self.b2_conv = Unit3D(c2a, c2b, kernel=(3, 3, 3), **kw)
        self.b3_conv = Unit3D(cin, c3, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = max_pool_same(x, (3, 3, 3), (1, 1, 1), train=self.training)
        return torch.cat([self.b0(x), self.b1_conv(self.b1_reduce(x)),
                          self.b2_conv(self.b2_reduce(x)), self.b3_conv(b3)], dim=-1)


class I3D(nn.Module):
    """I3D RGB stream on NTHWC input."""

    def __init__(self, num_classes: int = 400, dropout: float = 0.5,
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.dtype = dtype
        self.dropout = dropout
        kw = dict(dtype=dtype, norm=norm, generator=generator)
        self.conv1 = Unit3D(3, 64, kernel=(7, 7, 7), stride=(2, 2, 2), **kw)
        self.conv2 = Unit3D(64, 64, **kw)
        self.conv3 = Unit3D(64, 192, kernel=(3, 3, 3), **kw)
        cin = 192
        for name, widths in _INCEPTION_BLOCKS:
            if widths is not None:
                self.add_module(name, Inception3D(cin, widths, **kw))
                cin = inception_out(widths)
        self.fc = dense(cin, num_classes, generator)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask."""
        train = self.training
        x = self.conv1(x.to(self.dtype))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2), train=train)
        x = self.conv3(self.conv2(x))
        x = max_pool_same(x, (1, 3, 3), (1, 2, 2), train=train)
        for name, widths in _INCEPTION_BLOCKS:
            if widths is None:
                window = (3, 3, 3) if name == "pool3" else (2, 2, 2)
                x = max_pool_same(x, window, (2, 2, 2), train=train)
            else:
                x = getattr(self, name)(x)
        m = dropout(head_mean(x), self.dropout, train, generator)
        return self.fc(m)
