"""Conv and norm building blocks of the port's video backbones.

Counterparts of ``fastvideotagging_tpu/models/layers.py``. Tensors are NTHWC
at every module boundary. Conv kernels are kept in the JAX layout
(kt, kh, kw, Cin, Cout) in float32 and cast to the compute dtype at each
conv, as the JAX modules do; the hand kernels read that layout directly.

``backend`` selects the factorized convs' route: 'cuda' (the hand kernels of
ops/conv2plus1d.py, plain versions on the CPU) or 'torch' (``F.conv3d``).
Both routes are differentiable: the kernels through the
``torch.autograd.Function``s of ops/conv2plus1d.py, ``F.conv3d`` through
PyTorch's own autograd. ``ws`` standardizes a conv's kernel first
(``scaled_ws``, the companion of norm='scaleonly'); the standardized kernel
still goes to the hand kernels.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F
from torch import nn

from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops.arch_spec import tf_same_pads
from fastvideotagging_tpu_torch.ops.maxpool_grad import max_pool_nthwc

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


def scaled_ws(kernel: torch.Tensor, gain: float = 1.7139) -> torch.Tensor:
    """Scaled weight standardization over the fan-in axes (NF-ResNets,
    Brock et al. 2021): W' = gain * (W - mu) / sqrt(N * var + eps) per output
    channel, N = fan-in, gain = sqrt(2/(1-1/pi)) for ReLU signal propagation.
    The companion of norm='scaleonly'."""
    dims = tuple(range(kernel.ndim - 1))
    fan_in = math.prod(kernel.shape[:-1])
    mu = kernel.mean(dim=dims, keepdim=True)
    var = kernel.var(dim=dims, keepdim=True, unbiased=False)
    return gain * (kernel - mu) * torch.rsqrt(var * fan_in + 1e-8)


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


def _conv_pads(padding, kernel: tuple, strides: tuple, spatial: tuple) -> tuple:
    """Flax conv padding -> (lo, hi) per (T, H, W) dim: 'SYM' (k//2 both
    sides), 'SAME' (TF-SAME, the extra pixel high), 'VALID' or explicit
    ``((lo, hi),) * 3``."""
    if isinstance(padding, str):
        if padding == "SYM":
            return tuple((p, p) for p in symmetric_padding(kernel))
        if padding == "SAME":
            return tuple(tf_same_pads(n, k, st) for n, k, st in zip(spatial, kernel, strides))
        if padding == "VALID":
            return ((0, 0),) * 3
        raise ValueError(f"unknown padding {padding!r}")
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != 3:
        raise ValueError("explicit padding must give (lo, hi) for T, H, W")
    return pads


class Conv3D(nn.Module):
    """3D convolution on NTHWC input, kernel (kt, kh, kw, Cin, Cout); always
    the library conv. ``padding``: 'SYM' (k//2 per dim, the default),
    'SAME', 'VALID' or explicit ``((lo, hi),) * 3``; ``use_bias`` adds a
    zero-initialized bias; ``ws`` standardizes the kernel (``scaled_ws``)."""

    def __init__(self, cin: int, features: int, kernel_size, strides=(1, 1, 1),
                 padding="SYM", use_bias: bool = False, ws: bool = False,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.padding = padding
        self.ws = ws
        self.dtype = dtype
        self.kernel = nn.Parameter(
            he_normal(self.kernel_size + (cin, features), generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = (scaled_ws(self.kernel) if self.ws else self.kernel).to(self.dtype)
        pads = _conv_pads(self.padding, self.kernel_size, self.strides, tuple(x.shape[1:4]))
        if any(lo != hi for lo, hi in pads):  # F.conv3d pads symmetrically only
            (t0, t1), (h0, h1), (w0, w1) = pads
            x, pads = F.pad(x, (0, 0, w0, w1, h0, h1, t0, t1)), ((0, 0),) * 3
        y = ops.conv3d_nthwc(x, w, self.strides, tuple(lo for lo, _ in pads))
        if self.bias is not None:  # Flax's y + bias: the f32 bias promotes the sum
            y = y.to(torch.promote_types(y.dtype, self.bias.dtype)) + self.bias
        return y.to(self.dtype)


class SpatialConv(nn.Module):
    """1 x k x k conv — the spatial factor of a (2+1)D conv."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 backend: str = "cuda", dtype: torch.dtype = torch.bfloat16,
                 ws: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.k = kernel
        self.stride = stride
        self.backend = _check_backend(backend)
        self.dtype = dtype
        self.ws = ws
        self.kernel = nn.Parameter(he_normal((1, kernel, kernel, cin, features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = (scaled_ws(self.kernel) if self.ws else self.kernel).to(self.dtype)
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
                 ws: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.k = kernel
        self.stride = stride
        self.backend = _check_backend(backend)
        self.dtype = dtype
        self.ws = ws
        self.kernel = nn.Parameter(he_normal((kernel, 1, 1, cin, features), generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        w = (scaled_ws(self.kernel) if self.ws else self.kernel).to(self.dtype)
        if self.backend == "cuda":
            y = ops.temporal_conv(x, w[:, 0, 0], stride=self.stride)
        else:
            p = self.k // 2
            y = ops.conv3d_nthwc(x, w, (self.stride, 1, 1), (p, 0, 0))
        return y.to(self.dtype)


def _num_groups(channels: int, max_groups: int = 32) -> int:
    """Largest group count <= max_groups dividing ``channels`` (GroupNorm
    needs an exact division; the paper mid-channels 45/144/230/... are not
    all multiples of 32)."""
    for g in range(min(max_groups, channels), 0, -1):
        if channels % g == 0:
            return g
    return 1


class Norm(nn.Module):
    """The normalization layer selected by ``kind`` (ModelConfig.norm), with
    Flax's semantics. Parameters ``scale``/``bias`` in f32 for every kind;
    the batch kinds also keep buffers ``mean``/``var`` in f32, as Flax's
    BatchNorm does.

    - 'batch': in train mode the statistics of the batch, taken in f32 over
      (B, T, H, W) as ``var = max(0, mean(x^2) - mean(x)^2)`` (biased), and
      the running ``mean``/``var`` move to ``momentum * old + (1 - momentum)
      * batch`` (the running var from the biased batch var, unlike
      ``nn.BatchNorm3d``), except while a remat segment is recomputed
      (``recomputing``); in eval mode the running averages.
    - 'frozen': the running averages always (``scale``/``bias`` still
      train); the buffers never move.
    - 'group': GroupNorm over ``_num_groups(features)`` groups, statistics
      per (example, group) over (T, H, W) and the group's channels, the same
      way; no buffers, train == eval.
    - 'scaleonly': ``x * scale + bias`` in the compute dtype, no statistics
      and no buffers. ``scale_init='zeros'`` starts a residual branch's last
      affine at zero (SkipInit).

    The normalizing kinds compute ``(x - mean) * (rsqrt(var + eps) * scale)
    + bias`` in f32 and cast to the compute dtype, Flax's order and
    promotion."""

    KINDS = ("batch", "frozen", "group", "scaleonly")

    def __init__(self, features: int, kind: str = "batch", epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16, momentum: float = 0.9,
                 scale_init: str = "ones"):
        super().__init__()
        if kind not in self.KINDS:
            raise ValueError(f"unknown norm kind {kind!r}; expected one of {self.KINDS}")
        if scale_init not in ("ones", "zeros"):
            raise ValueError(f"scale_init must be 'ones' or 'zeros', got {scale_init!r}")
        self.kind = kind
        self.epsilon = epsilon
        self.momentum = momentum
        self.dtype = dtype
        init = torch.zeros if kind == "scaleonly" and scale_init == "zeros" else torch.ones
        self.scale = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        if kind in ("batch", "frozen"):
            self.register_buffer("mean", torch.zeros(features))
            self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "scaleonly":
            return x.to(self.dtype) * self.scale.to(self.dtype) + self.bias.to(self.dtype)
        # Flax promotes to at least f32 (an f64 input keeps f64).
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.kind == "group":
            c = x.shape[-1]
            g = _num_groups(c)
            xg = xf.reshape(*x.shape[:-1], g, c // g)
            dims = tuple(range(1, x.ndim - 1)) + (x.ndim,)
            mean = xg.mean(dim=dims, keepdim=True)
            var = torch.clamp((xg * xg).mean(dim=dims, keepdim=True) - mean * mean, min=0.0)
            shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (c,)
            mean = mean.expand(*mean.shape[:-1], c // g).reshape(shape)
            var = var.expand(*var.shape[:-1], c // g).reshape(shape)
        elif self.training and self.kind == "batch":
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


def max_pool_3d(x: torch.Tensor, window, strides=None, padding="VALID",
                train: bool = False) -> torch.Tensor:
    """Max-pool over (T, H, W) of an NTHWC tensor through
    ops/maxpool_grad.py (separable 1D pools in train mode, one 3D window in
    eval; values identical)."""
    return max_pool_nthwc(x, _triple(window), _triple(strides or window), padding, train=train)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """Flax's Dropout: in train mode keep each value with probability
    1 - rate (drawn from ``generator``, on x's device) and scale by
    1 / (1 - rate); the identity otherwise."""
    if not training or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return x * mask / keep


def dense(cin: int, features: int, generator: torch.Generator | None) -> nn.Linear:
    """``nn.Linear`` with Flax Dense's init: lecun_normal kernel, zero bias."""
    fc = nn.Linear(cin, features)
    with torch.no_grad():
        fc.weight.copy_(lecun_normal((cin, features), generator).T)
        fc.bias.zero_()
    return fc


def global_avg_pool_3d(x: torch.Tensor) -> torch.Tensor:
    """Mean over (T, H, W): NTHWC -> NC, accumulated in f32."""
    return x.float().mean(dim=(1, 2, 3)).to(x.dtype)
