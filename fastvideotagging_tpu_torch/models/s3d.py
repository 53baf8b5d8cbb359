"""S3D, the separable-3D Inception network (Xie et al. ECCV'18); the
counterpart of ``fastvideotagging_tpu/models/s3d.py``.

Every 3x3x3 conv of the I3D / BN-Inception backbone becomes a spatial 1xkxk
conv + BN + ReLU followed by a temporal kx1x1 conv + BN + ReLU (``SepConv``).
``gating=True`` is S3D-G: each separable conv's output is scaled
per channel by sigmoid(W . its own spatiotemporal mean). Geometry of
torchvision's ``models.video.s3d`` (stem sep-conv 7, 1x1x1 conv, sep-conv
3, nine SepInception blocks mixed3b..mixed5c, BN epsilon 1e-3).

Head: f32 spatial mean -> temporal window-2 stride-1 mean (when T' > 1)
-> temporal mean -> dropout -> Dense ``fc`` in f32; torchvision's
AvgPool3d((2,7,7)) + 1x1x1 classifier at the 224 geometry, since the
classifier is linear and position-independent.

The separable convs are ``SpatialConv`` / ``TemporalConv``: with
``backend='cuda'`` the stride-1 ones go to K1 / K2 where the routing of
ops/conv2plus1d.py takes them (C >= 32 for K1, T >= 2 for K2); the stem's
stride-2 7x7 pair and the narrow b2 reductions (16-24 channels) stay on
``F.conv3d``, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from fastvideotagging_tpu_torch.models.layers import (
    Conv3D,
    Norm,
    SpatialConv,
    TemporalConv,
    dense,
    dropout,
    max_pool_3d,
)

# (name, branch widths c0, c1a, c1b, c2a, c2b, c3) of the nine blocks, and
# the two pools between them; BN-Inception geometry.
_INCEPTION_BLOCKS = (
    ("mixed3b", (64, 96, 128, 16, 32, 32)),     # 192 -> 256
    ("mixed3c", (128, 128, 192, 32, 96, 64)),   # 256 -> 480
    ("pool3", None),                            # (3,3,3) s2 p1
    ("mixed4b", (192, 96, 208, 16, 48, 64)),    # 480 -> 512
    ("mixed4c", (160, 112, 224, 24, 64, 64)),   # 512 -> 512
    ("mixed4d", (128, 128, 256, 24, 64, 64)),   # 512 -> 512
    ("mixed4e", (112, 144, 288, 32, 64, 64)),   # 512 -> 528
    ("mixed4f", (256, 160, 320, 32, 128, 128)),  # 528 -> 832
    ("pool4", None),                            # (2,2,2) s2 p0
    ("mixed5b", (256, 160, 320, 32, 128, 128)),  # 832 -> 832
    ("mixed5c", (384, 192, 384, 48, 128, 128)),  # 832 -> 1024
)


def inception_out(widths) -> int:
    c0, _, c1b, _, c2b, c3 = widths
    return c0 + c1b + c2b + c3


def head_mean(x: torch.Tensor) -> torch.Tensor:
    """S3D's and I3D's pooling head: (N, T', H', W', C) -> (N, C) f32."""
    m = x.float().mean(dim=(2, 3))
    if m.shape[1] > 1:
        m = (m[:, :-1] + m[:, 1:]) * 0.5
    return m.mean(dim=1)


class SepConv(nn.Module):
    """spatial(1xkxk) + BN + ReLU -> temporal(kx1x1) + BN + ReLU, the
    stride inside each factor; with ``gating`` the S3D-G feature gate."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 gating: bool = False, backend: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 bn_eps: float = 1e-3, generator: torch.Generator | None = None):
        super().__init__()
        g = generator
        self.spatial = SpatialConv(cin, features, kernel, stride=stride, backend=backend,
                                   dtype=dtype, generator=g)
        self.bn_s = Norm(features, kind=norm, epsilon=bn_eps, dtype=dtype)
        self.temporal = TemporalConv(features, features, kernel, stride=stride,
                                     backend=backend, dtype=dtype, generator=g)
        self.bn_t = Norm(features, kind=norm, epsilon=bn_eps, dtype=dtype)
        self.gate = dense(features, features, g) if gating else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn_s(self.spatial(x)))
        y = torch.relu(self.bn_t(self.temporal(y)))
        if self.gate is not None:
            gate = torch.sigmoid(self.gate(y.float().mean(dim=(1, 2, 3)))).to(y.dtype)
            y = y * gate[:, None, None, None, :]
        return y


class SepInception(nn.Module):
    """b0: 1x1x1 -> c0; b1: 1x1x1 -> c1a, sep-conv3 -> c1b; b2: 1x1x1 ->
    c2a, sep-conv3 -> c2b; b3: maxpool3 s1, 1x1x1 -> c3; concat on C."""

    def __init__(self, cin: int, widths, gating: bool = False, backend: str = "cuda",
                 dtype: torch.dtype = torch.bfloat16, norm: str = "batch",
                 bn_eps: float = 1e-3, generator: torch.Generator | None = None):
        super().__init__()
        c0, c1a, c1b, c2a, c2b, c3 = widths
        g = generator

        def conv1(cout):
            return Conv3D(cin, cout, (1, 1, 1), dtype=dtype, generator=g)

        def bn(c):
            return Norm(c, kind=norm, epsilon=bn_eps, dtype=dtype)

        def sep(c_in, c_out):
            return SepConv(c_in, c_out, 3, gating=gating, backend=backend, dtype=dtype,
                           norm=norm, bn_eps=bn_eps, generator=g)

        self.b0, self.b0_bn = conv1(c0), bn(c0)
        self.b1_reduce, self.b1_bn, self.b1_sep = conv1(c1a), bn(c1a), sep(c1a, c1b)
        self.b2_reduce, self.b2_bn, self.b2_sep = conv1(c2a), bn(c2a), sep(c2a, c2b)
        self.b3_conv, self.b3_bn = conv1(c3), bn(c3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = torch.relu(self.b0_bn(self.b0(x)))
        b1 = self.b1_sep(torch.relu(self.b1_bn(self.b1_reduce(x))))
        b2 = self.b2_sep(torch.relu(self.b2_bn(self.b2_reduce(x))))
        b3 = max_pool_3d(x, (3, 3, 3), strides=(1, 1, 1), padding=((1, 1),) * 3,
                         train=self.training)
        b3 = torch.relu(self.b3_bn(self.b3_conv(b3)))
        return torch.cat([b0, b1, b2, b3], dim=-1)


class S3D(nn.Module):
    """S3D / S3D-G (``gating``) on NTHWC input."""

    def __init__(self, num_classes: int = 400, gating: bool = False, dropout: float = 0.2,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch", bn_eps: float = 1e-3,
                 generator: torch.Generator | None = None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.dtype = dtype
        self.dropout = dropout
        g = generator
        kw = dict(gating=gating, backend=backend, dtype=dtype, norm=norm, bn_eps=bn_eps,
                  generator=g)
        self.stem = SepConv(3, 64, kernel=7, stride=2, **kw)
        self.conv2 = Conv3D(64, 64, (1, 1, 1), dtype=dtype, generator=g)
        self.conv2_bn = Norm(64, kind=norm, epsilon=bn_eps, dtype=dtype)
        self.conv3 = SepConv(64, 192, kernel=3, **kw)
        cin = 192
        for name, widths in _INCEPTION_BLOCKS:
            if widths is not None:
                self.add_module(name, SepInception(cin, widths, **kw))
                cin = inception_out(widths)
        self.fc = dense(cin, num_classes, g)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask."""
        train = self.training
        x = self.stem(x.to(self.dtype))
        x = max_pool_3d(x, (1, 3, 3), strides=(1, 2, 2), padding=((0, 0), (1, 1), (1, 1)),
                        train=train)
        x = torch.relu(self.conv2_bn(self.conv2(x)))
        x = self.conv3(x)
        x = max_pool_3d(x, (1, 3, 3), strides=(1, 2, 2), padding=((0, 0), (1, 1), (1, 1)),
                        train=train)
        for name, widths in _INCEPTION_BLOCKS:
            if widths is None:  # pool3: (3,3,3) s2 p1; pool4: (2,2,2) s2
                pool3 = name == "pool3"
                x = max_pool_3d(x, (3, 3, 3) if pool3 else (2, 2, 2), strides=(2, 2, 2),
                                padding=((1, 1),) * 3 if pool3 else "VALID", train=train)
            else:
                x = getattr(self, name)(x)
        m = dropout(head_mean(x), self.dropout, train, generator)
        return self.fc(m)
