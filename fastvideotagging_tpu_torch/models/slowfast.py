"""SlowFast-style dual-pathway network on the R(2+1)D substrate, on one
card; the counterpart of ``fastvideotagging_tpu/models/slowfast.py``.

Two pathways over the same clip: Slow takes every ``alpha``-th frame at
full width, Fast every frame at ``1/beta`` of the channels. Lateral
connections after the stem and after each stage fuse Fast into Slow (a
conv to 2 * C_fast channels, concatenated on C). Head: global-pool both
pathways, concat, dropout, FC.

``pack_fast=True`` is the ``slowfast_r2plus1d_tpu`` variant: ``alpha``
consecutive frames fold into the channels of the Fast pathway
((N,T,H,W,C) -> (N,T/alpha,H,W,alpha*C)), so both pathways share the time
axis and the laterals are stride-free 3x1x1 convs. Not weight-compatible
with the faithful model.

Every conv is a full ``Conv3D``, the library's (the JAX package pops
``backend`` for this family). Channel sharding (``shard_axis``) is
ROADMAP.md Queue A item 7 and raises.
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


class SFBlock(nn.Module):
    """Basic (2+1)D residual block of full 3D convs: 1x3x3 (stride s) ->
    BN ReLU -> 3x1x1 -> BN ReLU -> 1x3x3 -> BN, + residual, ReLU."""

    def __init__(self, cin: int, features: int, spatial_stride: int = 1,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        s = spatial_stride
        g = generator

        def conv(c_in, k, st):
            return Conv3D(c_in, features, k, strides=st, dtype=dtype, generator=g)

        self.spatial1 = conv(cin, (1, 3, 3), (1, s, s))
        self.bn1 = Norm(features, dtype=dtype)
        self.temporal1 = conv(features, (3, 1, 1), (1, 1, 1))
        self.bn2 = Norm(features, dtype=dtype)
        self.spatial2 = conv(features, (1, 3, 3), (1, 1, 1))
        self.bn3 = Norm(features, dtype=dtype)
        self.down = self.bn_down = None
        if s != 1 or cin != features:
            self.down = conv(cin, (1, 1, 1), (1, s, s))
            self.bn_down = Norm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.spatial1(x)))
        y = torch.relu(self.bn2(self.temporal1(y)))
        y = self.bn3(self.spatial2(y))
        residual = x if self.down is None else self.bn_down(self.down(x))
        return torch.relu(y + residual)


class SlowFastR2Plus1D(nn.Module):
    def __init__(self, num_classes: int = 400, alpha: int = 4, beta: int = 8,
                 base_width: int = 64, stage_blocks: Sequence[int] = (1, 1, 1, 1),
                 dropout: float = 0.5, dtype: torch.dtype = torch.bfloat16,
                 shard_axis: str | None = None, pack_fast: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        if shard_axis is not None:
            raise NotImplementedError(
                "shard_axis (channel sharding) is not ported yet "
                "(ROADMAP.md Queue A item 7, parallelism)")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        self.alpha, self.pack_fast = alpha, pack_fast
        self.dtype = dtype
        self.dropout = dropout
        g = generator
        cf = max(base_width // beta, 8)
        fmul = alpha if pack_fast else 1  # the packed fast widths carry alpha frames
        self.slow_stem = Conv3D(3, base_width, (1, 7, 7), strides=(1, 2, 2), dtype=dtype,
                                generator=g)
        self.slow_stem_bn = Norm(base_width, dtype=dtype)
        if pack_fast:
            self.fast_stem = Conv3D(3 * alpha, cf * fmul, (3, 7, 7), strides=(1, 2, 2),
                                    dtype=dtype, generator=g)
        else:
            self.fast_stem = Conv3D(3, cf, (5, 7, 7), strides=(1, 2, 2), dtype=dtype,
                                    generator=g)
        self.fast_stem_bn = Norm(cf * fmul, dtype=dtype)
        slow_c, fast_c = base_width, cf * fmul
        self._add_lateral(0, fast_c, cf, g)
        slow_c += 2 * cf
        self.stage_names = []
        for stage, num_blocks in enumerate(stage_blocks):
            ws = base_width * (2 ** stage)
            wf = max(ws // beta, 8)
            names = []
            for b in range(num_blocks):
                stride = 2 if (stage > 0 and b == 0) else 1
                self.add_module(f"slow_s{stage}_b{b}",
                                SFBlock(slow_c, ws, spatial_stride=stride, dtype=dtype,
                                        generator=g))
                self.add_module(f"fast_s{stage}_b{b}",
                                SFBlock(fast_c, wf * fmul, spatial_stride=stride,
                                        dtype=dtype, generator=g))
                names.append((f"slow_s{stage}_b{b}", f"fast_s{stage}_b{b}"))
                slow_c, fast_c = ws, wf * fmul
            self._add_lateral(stage + 1, fast_c, wf, g)
            slow_c += 2 * wf
            self.stage_names.append(names)
        self.fc = dense(slow_c + fast_c, num_classes, g)

    def _add_lateral(self, idx: int, fast_c: int, cf: int,
                     generator: torch.Generator | None) -> None:
        """Lateral fast -> slow: faithful, a time-strided 5x1x1 (stride
        alpha) aligns the rates; packed, a stride-free 3x1x1."""
        k, st = ((3, 1, 1), (1, 1, 1)) if self.pack_fast else ((5, 1, 1), (self.alpha, 1, 1))
        self.add_module(f"lateral{idx}", Conv3D(fast_c, 2 * cf, k, strides=st,
                                                dtype=self.dtype, generator=generator))
        self.add_module(f"lateral{idx}_bn", Norm(2 * cf, dtype=self.dtype))

    def _fuse(self, slow: torch.Tensor, fast: torch.Tensor, idx: int) -> torch.Tensor:
        lat = getattr(self, f"lateral{idx}")(fast)
        lat = torch.relu(getattr(self, f"lateral{idx}_bn")(lat))
        return torch.cat([slow, lat], dim=-1)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask."""
        a = self.alpha
        if x.shape[1] % a != 0:
            raise ValueError(f"clip length {x.shape[1]} must be divisible by alpha={a}")
        x = x.to(self.dtype)
        slow = torch.relu(self.slow_stem_bn(self.slow_stem(x[:, ::a])))
        if self.pack_fast:
            n, t, h, w, c = x.shape
            fast = x.reshape(n, t // a, a, h, w, c).movedim(2, 4).reshape(n, t // a, h, w, a * c)
        else:
            fast = x
        fast = torch.relu(self.fast_stem_bn(self.fast_stem(fast)))
        slow = self._fuse(slow, fast, 0)
        for stage, names in enumerate(self.stage_names):
            for slow_name, fast_name in names:
                slow = getattr(self, slow_name)(slow)
                fast = getattr(self, fast_name)(fast)
            slow = self._fuse(slow, fast, stage + 1)
        pooled = torch.cat([global_avg_pool_3d(slow), global_avg_pool_3d(fast)], dim=-1)
        pooled = dropout(pooled, self.dropout, self.training, generator)
        return self.fc(pooled.float())
