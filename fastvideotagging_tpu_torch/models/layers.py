"""Conv and norm building blocks of the port's video backbones.

Counterparts of ``fastvideotagging_tpu/models/layers.py``. Tensors are NTHWC
at every module boundary. Conv kernels are kept in the JAX layout
(kt, kh, kw, Cin, Cout) in float32 and cast to the compute dtype at each
conv, as the JAX modules do; the hand kernels read that layout directly.

``backend`` selects the factorized convs' route: 'cuda' (the hand kernels of
ops/conv2plus1d.py, plain versions on the CPU) or 'torch' (``F.conv3d``).
Both routes are differentiable: the kernels through the
``torch.autograd.Function``s of ops/conv2plus1d.py, ``F.conv3d`` through
PyTorch's own autograd.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
from torch import nn

from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

BACKENDS = ("cuda", "torch")


def r2plus1d_mid_channels(cin: int, cout: int, kt: int = 3, kd: int = 3) -> int:
    """Mid-channel count M matching the full-3D conv parameter budget.

    M = floor( kt*kd^2*cin*cout / (kd^2*cin + kt*cout) )  (Tran'18).
    """
    return (kt * kd * kd * cin * cout) // (kd * kd * cin + kt * cout)


def mxu_aligned_mid_channels(cin: int, cout: int, kt: int = 3, kd: int = 3) -> int:
    """The `*_tpu` zoo variants' mid-channel rule: M rounded to the nearest
    multiple of 128 (>= 128). An architecture name, kept as it is."""
    m = r2plus1d_mid_channels(cin, cout, kt, kd)
    return max(128, int(round(m / 128)) * 128)


# Set while torch.utils.checkpoint recomputes a segment of the forward for the
# backward (models/r2plus1d.py, remat): Norm then leaves its running
# statistics alone, so that they move once per forward, as with remat off.
_recompute = threading.local()


@contextlib.contextmanager
def recomputing():
    """The recompute context that the remat segments hand to
    ``torch.utils.checkpoint`` (``context_fn``)."""
    before = getattr(_recompute, "active", False)
    _recompute.active = True
    try:
        yield
    finally:
        _recompute.active = before


def symmetric_padding(kernel: tuple[int, int, int]) -> tuple[int, int, int]:
    """k//2 per dim — torch/MXNet 'pad=k//2' conv semantics (Flax's 'SYM')."""
    return tuple(k // 2 for k in kernel)


def _triple(v) -> tuple[int, int, int]:
    if isinstance(v, int):
        return (v, v, v)
    t = tuple(v)
    if len(t) != 3:
        raise ValueError(f"expected 3 values, got {v!r}")
    return t


def _variance_scaling(shape, scale: float, fan_in: int,
                      generator: torch.Generator | None) -> torch.Tensor:
    """Flax's variance_scaling(scale, 'fan_in', 'truncated_normal'): a normal
    truncated at two standard deviations, rescaled to variance scale/fan_in."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    t = torch.empty(shape, dtype=torch.float32)
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def he_normal(shape, generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax ``he_normal`` for a (..., Cin, Cout) kernel."""
    return _variance_scaling(shape, 2.0, math.prod(shape[:-1]), generator)


def lecun_normal(shape, generator: torch.Generator | None = None) -> torch.Tensor:
    """Flax ``lecun_normal`` for a (Cin, Cout) dense kernel."""
    return _variance_scaling(shape, 1.0, math.prod(shape[:-1]), generator)


def _check_backend(backend: str) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernels backend {backend!r}; expected one of {BACKENDS}")
    return backend


class Conv3D(nn.Module):
    """3D convolution on NTHWC input, kernel (kt, kh, kw, Cin, Cout),
    symmetric k//2 padding; always the library conv."""

    def __init__(self, cin: int, features: int, kernel_size, strides=(1, 1, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.dtype = dtype
        self.kernel = nn.Parameter(
            he_normal(self.kernel_size + (cin, features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = ops.conv3d_nthwc(x.to(self.dtype), self.kernel.to(self.dtype),
                             self.strides, symmetric_padding(self.kernel_size))
        return y.to(self.dtype)


class SpatialConv(nn.Module):
    """1 x k x k conv — the spatial factor of a (2+1)D conv."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k = kernel
        self.stride = stride
        self.backend = _check_backend(backend)
        self.dtype = dtype
        self.kernel = nn.Parameter(he_normal((1, kernel, kernel, cin, features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        if self.backend == "cuda":
            y = ops.spatial_conv(x, w[0], stride=self.stride)
        else:
            p = self.k // 2
            y = ops.conv3d_nthwc(x, w, (1, self.stride, self.stride), (0, p, p))
        return y.to(self.dtype)


class TemporalConv(nn.Module):
    """k x 1 x 1 conv — the temporal factor of a (2+1)D conv."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.k = kernel
        self.stride = stride
        self.backend = _check_backend(backend)
        self.dtype = dtype
        self.kernel = nn.Parameter(he_normal((kernel, 1, 1, cin, features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = self.kernel.to(self.dtype)
        if self.backend == "cuda":
            y = ops.temporal_conv(x, w[:, 0, 0], stride=self.stride)
        else:
            p = self.k // 2
            y = ops.conv3d_nthwc(x, w, (self.stride, 1, 1), (p, 0, 0))
        return y.to(self.dtype)


class Norm(nn.Module):
    """BatchNorm over the channel (last) axis with Flax's semantics.
    Parameters ``scale``/``bias`` and buffers ``mean``/``var`` in f32, as
    Flax's BatchNorm keeps them.

    - 'batch': in train mode the statistics of the batch, taken in f32 over
      (B, T, H, W) as ``var = max(0, mean(x^2) - mean(x)^2)`` (biased), and
      the running ``mean``/``var`` move to ``momentum * old + (1 - momentum)
      * batch`` (the running var from the biased batch var, unlike
      ``nn.BatchNorm3d``), except while a remat segment is recomputed
      (``recomputing``); in eval mode the running averages.
    - 'frozen': the running averages always (``scale``/``bias`` still
      train); the buffers never move.

    ``(x - mean) * (rsqrt(var + eps) * scale) + bias`` is computed in f32
    and cast to the compute dtype, Flax's order and promotion."""

    KINDS = ("batch", "frozen")

    def __init__(self, features: int, kind: str = "batch", epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, momentum: float = 0.9):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(
                f"norm kind {kind!r} is not ported yet (ROADMAP.md Queue A item 4); "
                f"expected one of {self.KINDS}")
        self.kind = kind
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # Flax promotes to at least f32 (an f64 input keeps f64).
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training and self.kind == "batch":
            dims = tuple(range(x.ndim - 1))
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean, min=0.0)
            if not getattr(_recompute, "active", False):
                with torch.no_grad():
                    self.mean.mul_(self.momentum).add_(mean, alpha=1.0 - self.momentum)
                    self.var.mul_(self.momentum).add_(var, alpha=1.0 - self.momentum)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        y = (xf - mean) * mul + self.bias
        return y.to(self.dtype)


def global_avg_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """Mean over (T, H, W): NTHWC -> NC, accumulated in f32."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)
