"""R(2+1)D backbone (Tran et al. CVPR'18).

The counterpart of ``fastvideotagging_tpu/models/r2plus1d.py``: every 3x3x3
conv is factorized into a spatial 1x3x3 conv (M mid-channels) + BN + ReLU +
a temporal 3x1x1 conv. Stem: 1x7x7 s(1,2,2) -> 45 mid-channels -> 3x1x1 ->
64. Stages 64/128/256/512; temporal and spatial stride 2 at each later
stage's entry, applied inside the respective factor. Head: global average
pool + FC in f32.

Module and parameter names follow the JAX tree (``stage1_block0.conv1.
spatial.kernel``, ``...bn_mid.scale``), so models/convert.py maps one onto
the other by name. ``module.train()`` / ``.eval()`` take the place of the
JAX ``train`` argument: in train mode BatchNorm uses batch statistics and
dropout (before ``fc``) is drawn from the ``generator`` given to
``forward``. ``norm`` takes every kind of ``layers.Norm``; 'scaleonly'
also standardizes every conv kernel (``ws``) and starts each block's
``bn2`` scale at zero (SkipInit), as the JAX modules do. ``remat`` (``REMAT_POLICIES``) recomputes parts of each
residual block's forward in the backward instead of keeping them; its
numerics are those of ``'none'``.

``bn_axis_name`` (a process group) syncs every BatchNorm's train-mode
statistics over its ranks (``layers.Norm``'s ``group``), the mid BNs of the
factorized convs included; ``time_axis`` (a process group over which the
clip's T is sharded: evaluation/long_clip.py, train/time_sharded.py) runs
every temporal conv as the halo conv of parallel/temporal.py. The
time-sharded step passes the time group as both.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from fastvideotagging_tpu_torch.models.layers import (
    Conv3D,
    Norm,
    SpatialConv,
    TemporalConv,
    dense,
    dropout,
    global_avg_pool_3d,
    r2plus1d_mid_channels,
    recomputing,
)

# Activation rematerialization of the residual blocks (ModelConfig.remat;
# the JAX package's ``remat_policy``). Each policy is a hand-made
# segmentation of ``BasicBlock.forward``: a segment runs under
# ``torch.utils.checkpoint``, which keeps its inputs and recomputes the rest
# of it (its convs included) in the backward. What each keeps:
# - 'full': the block's input only; the whole block is recomputed.
# - 'dots': the outputs of the block's convs (and its input); BN, ReLU and
#   the residual add are recomputed, each with the conv that follows it.
# - 'mid':  everything except the (2+1)D mid activation (the ReLU'd spatial
#   conv output): BN + ReLU + temporal conv of each (2+1)D conv recomputed.
# - 'conv': the temporal conv outputs and the block's input; each (2+1)D
#   conv, its mid activation and the norm/ReLU elementwise are recomputed.
# The hand kernels run inside ``torch.autograd.Function``s that an op-level
# checkpoint policy cannot see, hence segments. Norm leaves its running
# statistics alone while a segment is recomputed (layers.recomputing).
REMAT_POLICIES = ("none", "full", "dots", "mid", "conv")


def _check_remat(name: str) -> str:
    if name not in REMAT_POLICIES:
        raise ValueError(
            f"unknown remat policy {name!r}; expected none|full|dots|mid|conv")
    return name


def _recompute_context():
    return contextlib.nullcontext(), recomputing()


def _segment(fn, *args):
    """``fn(*args)``, its inside recomputed in the backward. The blocks draw
    no random numbers, so no RNG state is stashed."""
    return checkpoint(fn, *args, use_reentrant=False, context_fn=_recompute_context,
                      preserve_rng_state=False)


class Conv2Plus1D(nn.Module):
    """Factorized spatiotemporal conv: spatial(1xkxk) -> BN -> ReLU -> temporal(kx1x1)."""

    def __init__(self, cin: int, features: int, mid_features: int,
                 spatial_stride: int = 1, temporal_stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch", generator: torch.Generator | None = None,
                 bn_axis_name=None, time_axis=None):
        super().__init__()
        ws = norm == "scaleonly"  # the stats-free mode standardizes kernels
        self.spatial = SpatialConv(cin, mid_features, 3, stride=spatial_stride,
                                   backend=backend, dtype=dtype, ws=ws, generator=generator)
        # the group reaches the mid BN too: with local statistics here a
        # sharded step would normalize the mid activation by its own shard's
        self.bn_mid = Norm(mid_features, kind=norm, dtype=dtype, group=bn_axis_name)
        self.temporal = TemporalConv(mid_features, features, 3, stride=temporal_stride,
                                     backend=backend, dtype=dtype, ws=ws, generator=generator,
                                     time_axis=time_axis)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mid_to_out(self.spatial(x))

    def mid_to_out(self, s: torch.Tensor) -> torch.Tensor:
        """From the spatial conv's output: BN, ReLU, temporal conv."""
        return self.temporal(torch.relu(self.bn_mid(s)))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch",
                 mid_channels_fn: Callable[[int, int], int] = r2plus1d_mid_channels,
                 generator: torch.Generator | None = None, remat: str = "none",
                 bn_axis_name=None, time_axis=None):
        super().__init__()
        self.remat = _check_remat(remat)
        kw = dict(backend=backend, dtype=dtype, norm=norm, generator=generator,
                  bn_axis_name=bn_axis_name, time_axis=time_axis)
        self.conv1 = Conv2Plus1D(cin, features, mid_channels_fn(cin, features),
                                 spatial_stride=stride, temporal_stride=stride, **kw)
        self.bn1 = Norm(features, kind=norm, dtype=dtype, group=bn_axis_name)
        self.conv2 = Conv2Plus1D(features, features, mid_channels_fn(features, features),
                                 **kw)
        # scaleonly: the branch's last scale starts at zero (SkipInit), so
        # the block is the identity at init
        self.bn2 = Norm(features, kind=norm, dtype=dtype, scale_init="zeros",
                        group=bn_axis_name)
        self.downsample = self.bn_down = None
        if stride != 1 or cin != features:
            self.downsample = Conv3D(cin, features, (1, 1, 1), strides=stride,
                                     ws=norm == "scaleonly", dtype=dtype, generator=generator)
            self.bn_down = Norm(features, kind=norm, dtype=dtype, group=bn_axis_name)

    def _tail(self, t2: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """bn2, the residual (``r``: x, or the downsample conv's output) and
        the last ReLU."""
        if self.bn_down is not None:
            r = self.bn_down(r)
        return torch.relu(self.bn2(t2) + r)

    def _residual_input(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.downsample is None else self.downsample(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        policy = self.remat if self.training and torch.is_grad_enabled() else "none"
        if policy == "none":
            return self._forward_none(x)
        if policy == "full":
            return _segment(self._forward_none, x)
        if policy == "dots":
            t1 = _segment(self.conv1.mid_to_out, self.conv1.spatial(x))
            s2 = _segment(lambda t: self.conv2.spatial(torch.relu(self.bn1(t))), t1)
            t2 = _segment(self.conv2.mid_to_out, s2)
            return _segment(self._tail, t2, self._residual_input(x))
        if policy == "mid":
            t1 = _segment(self.conv1.mid_to_out, self.conv1.spatial(x))
            s2 = self.conv2.spatial(torch.relu(self.bn1(t1)))
            t2 = _segment(self.conv2.mid_to_out, s2)
            return self._tail(t2, self._residual_input(x))
        # 'conv'
        t1 = _segment(self.conv1, x)
        t2 = _segment(lambda t: self.conv2(torch.relu(self.bn1(t))), t1)
        return _segment(lambda t, a: self._tail(t, self._residual_input(a)), t2, x)

    def _forward_none(self, x: torch.Tensor) -> torch.Tensor:
        t1 = self.conv1(x)
        t2 = self.conv2(torch.relu(self.bn1(t1)))
        return self._tail(t2, self._residual_input(x))


class R2Plus1D(nn.Module):
    def __init__(self, stage_blocks: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 101, backend: str = "cuda",
                 dropout: float = 0.0, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "batch",
                 mid_channels_fn: Callable[[int, int], int] = r2plus1d_mid_channels,
                 stem_mid: int = 45, generator: torch.Generator | None = None,
                 remat: str = "none", bn_axis_name=None, time_axis=None):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout must be in [0, 1), got {dropout}")
        if time_axis is not None and norm == "group":
            raise ValueError("norm='group' takes per-clip statistics over the whole T, "
                             "which a time-sharded model does not sync")
        self.stage_blocks = tuple(stage_blocks)
        self.dtype = dtype
        self.dropout = dropout
        self.time_axis = time_axis
        g = generator
        ws = norm == "scaleonly"
        self.stem_spatial = SpatialConv(3, stem_mid, 7, stride=2, backend=backend,
                                        dtype=dtype, ws=ws, generator=g)
        self.stem_bn1 = Norm(stem_mid, kind=norm, dtype=dtype, group=bn_axis_name)
        self.stem_temporal = TemporalConv(stem_mid, 64, 3, backend=backend,
                                          dtype=dtype, ws=ws, generator=g, time_axis=time_axis)
        self.stem_bn2 = Norm(64, kind=norm, dtype=dtype, group=bn_axis_name)
        cin = 64
        self.block_names = []
        for stage, num_blocks in enumerate(self.stage_blocks):
            features = 64 * (2 ** stage)
            for block in range(num_blocks):
                stride = 2 if (stage > 0 and block == 0) else 1
                name = f"stage{stage + 1}_block{block}"
                self.add_module(name, BasicBlock(
                    cin, features, stride=stride, backend=backend, dtype=dtype,
                    norm=norm, mid_channels_fn=mid_channels_fn, generator=g,
                    remat=remat, bn_axis_name=bn_axis_name, time_axis=time_axis))
                self.block_names.append(name)
                cin = features
        self.fc = dense(cin, num_classes, g)

    def forward(self, x: torch.Tensor, features_only: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator`` (on x's device) draws the train-mode dropout mask;
        None takes PyTorch's default generator."""
        x = x.to(self.dtype)
        x = torch.relu(self.stem_bn1(self.stem_spatial(x)))
        x = torch.relu(self.stem_bn2(self.stem_temporal(x)))
        for name in self.block_names:
            x = getattr(self, name)(x)
        if features_only:
            return x  # pre-pool feature map (B, T', H', W', C)
        x = dropout(global_avg_pool_3d(x), self.dropout, self.training, generator)
        return self.fc(x.float())
