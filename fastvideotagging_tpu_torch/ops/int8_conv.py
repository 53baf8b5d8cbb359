"""The int8 engine's two hand-written Hopper kernels, their plain PyTorch
versions and their launch counts (csrc/int8_conv.cu).

- ``conv3d_s8_hopper_kernel`` (Q1): the int8 x int8 -> int32 conv over a
  general 3-D tap set (strides, low and high pads) with the requant
  epilogue ``relu?(fma(f32(acc), mul * s, add))``, stored as bf16 or f32.
- ``quantize_s8_kernel`` (Q2) and, in the dynamic mode, its amax pass
  ``quantize_amax_kernel``: a bf16 or f32 activation to int8 in the two
  operation orders of the JAX engine (static, dynamic).

Neither replaces a TPU kernel: the JAX engine (``fastvideotagging_tpu/ops/
int8_infer.py``) leaves both to XLA. A CUDA tensor goes to the kernel, a
CPU tensor to the plain version; nothing falls back. The activations cross
between them as ``(N, T, H, W, cp)`` int8 with the channels zero-padded to
``cp``, a multiple of 16 (a 16-byte load holds 16 channels; zero channels
leave the int32 sum exact); the weights as ``(Co, taps, cp)`` int8, K-major,
laid out once per qpack by ``weight_layout``. The scale ``s`` stays on the
device as a 0-d f32 tensor: no scale is read back to the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops.conv2plus1d import _K1_BNS, _route

# Launches since the last reset: Q1, Q2's quantize pass, Q2's amax pass
# (dynamic mode only).
launch_counts = {"conv3d_s8": 0, "quantize_s8": 0, "quantize_s8_amax": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


CHANNEL_ALIGN = 16  # int8 channels of one 16-byte load
# The dynamic scale is amax / 127 in the JAX engine's source; XLA computes
# it as amax times the f32 reciprocal of 127 (one rounding off the
# quotient in some cases), and so do Q2 and its plain version, so that the
# two engines' dynamic scales agree bit for bit.
INV_127 = torch.tensor(1.0, dtype=torch.float32) / 127.0


def padded_channels(c: int) -> int:
    return -(-c // CHANNEL_ALIGN) * CHANNEL_ALIGN


# fvt_conv3d_s8(x, wk, mul, add, s, y, n, t, h, w, cp, to, ho, wo, kt, kh, kw,
# st, sh, sw, pt, ph, pw, co, relu, out_f32, bn, smem_bytes, device, stream)
_Q1_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 22 + [ctypes.c_void_p]
# fvt_quantize_s8(y, in_f32, inv_f, s_in, amax, s_out, q, rows, c, cp, device, stream)
_Q2_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                + [ctypes.c_int] * 3 + [ctypes.c_void_p])

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("int8_conv")
        lib.fvt_conv3d_s8.argtypes = _Q1_ARGTYPES
        lib.fvt_quantize_s8.argtypes = _Q2_ARGTYPES
        lib.fvt_conv3d_s8.restype = lib.fvt_quantize_s8.restype = ctypes.c_int
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# Q1: the int8 conv
# ---------------------------------------------------------------------------

_Q1_BM = 128  # output rows per block
_Q1_BK = 128  # contraction slice: 128 int8, 128 bytes a row
_Q1_STAGES = 3  # slices in the cp.async ring
_Q1_ALIGN = 1024


class ConvS8Plan(NamedTuple):
    bn: int  # output channels per block (wgmma's N: 64, 128 or 144, all valid for .s8)
    smem_bytes: int  # dynamic shared memory of one block
    row_tiles: int  # blocks along the output rows (128 each)
    col_tiles: int  # blocks along the output channels (bn each)
    slices: int  # 128-deep slices of the contraction taps * cp

    @property
    def grid(self) -> int:
        return self.row_tiles * self.col_tiles


@functools.lru_cache(maxsize=256)
def conv_s8_plan(rows: int, co: int, taps: int, cp: int) -> ConvS8Plan:
    """Q1's launch plan: ``rows`` output rows, ``co`` output channels, a
    contraction of ``taps`` taps of ``cp`` channels. The column tile is K1's
    rule (ops/conv2plus1d.py::_taps_plan): the narrowest tile that covers
    Co, else the widest that divides it, else the least wasteful."""
    covering = [bn for bn in _K1_BNS if bn >= co]
    dividing = [bn for bn in _K1_BNS if co % bn == 0]
    if covering:
        bn = covering[-1]
    elif dividing:
        bn = dividing[0]
    else:
        bn = min(_K1_BNS, key=lambda b: (-(-co // b) * b - co, -b))
    smem = _Q1_STAGES * (_Q1_BM + bn) * _Q1_BK + _Q1_ALIGN
    return ConvS8Plan(bn, smem, -(-rows // _Q1_BM), -(-co // bn), -(-taps * cp // _Q1_BK))


def weight_layout(w: torch.Tensor) -> torch.Tensor:
    """int8 weights (kt, kh, kw, C, Co) -> Q1's K-major (Co, kt*kh*kw, cp),
    the input channels zero-padded to ``cp``. Done once per qpack."""
    kt, kh, kw, c, co = w.shape
    wk = w.permute(4, 0, 1, 2, 3).reshape(co, kt * kh * kw, c)
    return F.pad(wk, (0, padded_channels(c) - c)).contiguous()


def out_size(n: int, k: int, s: int, pad) -> int:
    return (n + pad[0] + pad[1] - k) // s + 1


def _check_q1(q, wk, kernel_size, mul, add, s, strides, pads):
    if q.dtype != torch.int8 or wk.dtype != torch.int8 or q.ndim != 5 or wk.ndim != 3:
        raise ValueError(f"q (N,T,H,W,cp) and wk (Co,taps,cp) must be int8, got "
                         f"{q.dtype} {tuple(q.shape)} and {wk.dtype} {tuple(wk.shape)}")
    kt, kh, kw = kernel_size
    cp = q.shape[-1]
    if cp % CHANNEL_ALIGN or wk.shape[1:] != (kt * kh * kw, cp):
        raise ValueError(f"q's channels {cp} must be a multiple of {CHANNEL_ALIGN} and wk "
                         f"(Co, {kt * kh * kw}, {cp}); got wk {tuple(wk.shape)}")
    co = wk.shape[0]
    for name, t in (("mul", mul), ("add", add)):
        if t.dtype != torch.float32 or tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be f32 ({co},), got {t.dtype} {tuple(t.shape)}")
    if s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"s must be one f32 value, got {s.dtype} {tuple(s.shape)}")
    if len(strides) != 3 or len(pads) != 3 or min(strides) < 1:
        raise ValueError(f"bad strides {strides} or pads {pads}")


def conv3d_s8_cuda(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool,
                   out_f32: bool) -> torch.Tensor:
    """Q1 on the card: q (N, T, H, W, cp) int8, wk (Co, kt*kh*kw, cp) int8,
    mul / add (Co,) f32, s a 0-d f32, all on one CUDA device; ``pads`` (lo,
    hi) per (T, H, W) -> (N, To, Ho, Wo, Co) bf16, or f32 with ``out_f32``."""
    _check_q1(q, wk, kernel_size, mul, add, s, strides, pads)
    dev = q.device
    for name, t in (("q", q), ("wk", wk), ("mul", mul), ("add", add), ("s", s)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    n, t, h, w, cp = q.shape
    kt, kh, kw = kernel_size
    to, ho, wo = (out_size(d, k, st, p) for d, k, st, p in
                  zip((t, h, w), kernel_size, strides, pads))
    co = wk.shape[0]
    q = q.clone() if q.data_ptr() % 16 else q
    wk = wk.clone() if wk.data_ptr() % 16 else wk
    plan = conv_s8_plan(n * to * ho * wo, co, kt * kh * kw, cp)
    y = torch.empty((n, to, ho, wo, co), dtype=torch.float32 if out_f32 else torch.bfloat16,
                    device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernels().fvt_conv3d_s8(
        q.data_ptr(), wk.data_ptr(), mul.data_ptr(), add.data_ptr(), s.data_ptr(),
        y.data_ptr(), n, t, h, w, cp, to, ho, wo, kt, kh, kw, *strides,
        *(p[0] for p in pads), co, int(relu), int(out_f32), plan.bn, plan.smem_bytes,
        dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_conv3d_s8 launch failed: CUDA error {rc}")
    launch_counts["conv3d_s8"] += 1
    return y


def conv3d_s8_accumulate(q, wk, kernel_size, strides, pads) -> torch.Tensor:
    """The exact int32 sums of Q1 as f64 (every partial sum is an integer
    below 2^53): ``F.conv3d`` in f64 on the int8 values."""
    kt, kh, kw = kernel_size
    co, _, cp = wk.shape
    (tl, th), (hl, hh), (wl, wh) = pads
    x = F.pad(q.to(torch.float64), (0, 0, wl, wh, hl, hh, tl, th))
    w = wk.to(torch.float64).reshape(co, kt, kh, kw, cp).permute(0, 4, 1, 2, 3)
    acc = F.conv3d(x.permute(0, 4, 1, 2, 3).contiguous(), w.contiguous(), stride=tuple(strides))
    return acc.permute(0, 2, 3, 4, 1)


def requant_epilogue(acc: torch.Tensor, mul, add, s, relu: bool, out_f32: bool) -> torch.Tensor:
    """Q1's epilogue on the int32 sums (any dtype that holds them exactly):
    ``fma(f32(acc), mul * s, add)`` in f32 with one rounding (``addcmul``
    is a fused multiply-add; XLA contracts the JAX engine's ``acc * (mul *
    s) + add`` into one too), then ReLU and the output cast."""
    y = torch.addcmul(add, acc.to(torch.float32), mul * s)
    if relu:
        y = torch.relu(y)
    return (y if out_f32 else y.to(torch.bfloat16)).contiguous()


def conv3d_s8_plain(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool,
                    out_f32: bool) -> torch.Tensor:
    """The plain version of Q1: an exact integer conv (f64 ``F.conv3d``), then
    the same epilogue in f32."""
    _check_q1(q, wk, kernel_size, mul, add, s, strides, pads)
    acc = conv3d_s8_accumulate(q, wk, kernel_size, strides, pads)
    return requant_epilogue(acc, mul, add, s, relu, out_f32)


def conv3d_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool = False,
              out_f32: bool = False) -> torch.Tensor:
    """Q1 for a CUDA ``q``, its plain version for a CPU one."""
    return _route(conv3d_s8_cuda, conv3d_s8_plain, q, wk, tuple(kernel_size), mul, add, s,
                  tuple(strides), tuple(tuple(p) for p in pads), relu, out_f32)


# ---------------------------------------------------------------------------
# Q2: the quantize pass
# ---------------------------------------------------------------------------


def _check_q2(y, inv_f):
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"y must be bf16 or f32, got {y.dtype}")
    if inv_f.dtype != torch.float32 or tuple(inv_f.shape) != (y.shape[-1],):
        raise ValueError(f"inv_f must be f32 ({y.shape[-1]},), got {inv_f.dtype} "
                         f"{tuple(inv_f.shape)}")


def quantize_s8_cuda(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None):
    """Q2 on the card: y (..., C) bf16 or f32 -> (q (..., cp) int8 with
    channels C..cp-1 zero, s a 0-d f32). Static with ``s`` (a 0-d f32 on the
    device); dynamic without: the amax pass, then the quantize pass, which
    writes the scale it used."""
    _check_q2(y, inv_f)
    dev = y.device
    y = y.contiguous()
    c = y.shape[-1]
    cp = padded_channels(c)
    rows = y.numel() // c
    q = torch.empty(y.shape[:-1] + (cp,), dtype=torch.int8, device=dev)
    if s is None:
        amax = torch.empty((), dtype=torch.int32, device=dev)
        s_out = torch.empty((), dtype=torch.float32, device=dev)
        args = (None, amax.data_ptr(), s_out.data_ptr())
    else:
        if s.dtype != torch.float32 or s.numel() != 1 or s.device != dev:
            raise ValueError(f"s must be one f32 value on {dev}")
        s_out = s
        args = (s.data_ptr(), None, None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernels().fvt_quantize_s8(y.data_ptr(), int(y.dtype == torch.float32),
                                    inv_f.contiguous().data_ptr(), *args, q.data_ptr(), rows, c,
                                    cp, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_quantize_s8 launch failed: CUDA error {rc}")
    launch_counts["quantize_s8"] += 1
    if s is None:
        launch_counts["quantize_s8_amax"] += 1
    return q, s_out.reshape(())


def quantize_s8_plain(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None):
    """The plain version of Q2, in the JAX engine's two orders: static
    ``round(f32(y) * (inv_f / s))``, dynamic ``xs = f32(y) * inv_f``, ``s =
    max(amax|xs|, 1e-12) * f32(1/127)`` (``INV_127``), ``round(xs / s)``;
    clipped to +-127 and the channels zero-padded to a multiple of 16."""
    _check_q2(y, inv_f)
    if s is None:
        xs = y.to(torch.float32) * inv_f
        s = torch.clamp_min(xs.abs().amax(), 1e-12) * INV_127
        t = xs / s
    else:
        s = s.reshape(())
        t = y.to(torch.float32) * (inv_f / s)
    q = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    c = y.shape[-1]
    return F.pad(q, (0, padded_channels(c) - c)).contiguous(), s


def quantize_s8(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None):
    """Q2 for a CUDA ``y``, its plain version for a CPU one."""
    return _route(quantize_s8_cuda, quantize_s8_plain, y, inv_f, s)

