"""The temporal-conv micro-benchmark's five kernel designs: hand-written
Hopper kernels (csrc/temporal_micro.cu), their plain PyTorch versions, their
tile plans and launch counts.

They are the counterparts of the Pallas kernels in the JAX package's
``benchmarks/kernel_micro.py``, three designs of the temporal k x 1 x 1
conv's forward and two of its weight gradient, kept side by side so that
the benchmark compares designs:

- K5 ``temporal_v2`` (``pallas_temporal_v2``): x padded on T by a separate
  pass (the counterpart of ``jnp.pad``), then per (b, s-tile) slab the k
  taps' products over the halo'd (T + 2p, tile_s, C) slab, accumulated in
  registers; tile_s halved from 512 until it divides S.
- K6 ``temporal_v3`` (``pallas_temporal_v3``): no pad; the centre tap
  starts the f32 accumulator and each other tap adds its product over the
  rows whose shifted input lies in [0, T) (each tap's row range clipped, an
  empty one skipped); tile_s the largest divisor of S up to ``max_tile``.
  ``temporal_dx_v3`` is K6 on the time-flipped, io-transposed weight.
- K8 ``temporal_v3p`` (``pallas_temporal_v3p``): packed taps, one
  contraction over k * C per output tile; the A loader writes zeros for
  rows outside [0, T).
- K7 ``temporal_dw_v3`` (``pallas_temporal_dw_v3``): dw without a pad, each
  tap's x^T g over its clipped rows.
- K9 ``temporal_dw_v2`` (``pallas_temporal_dw``): dw over K5's padded x.

The TPU dw kernels add into one output block across a grid that runs in
order; CUDA blocks run at once, so K7 and K9 write f32 partial sums per
chunk of (b, s-tile) steps and a second kernel adds them in chunk order (no
atomics: two launches are bitwise equal). ``dw_plan`` sizes the chunks.

Shapes follow the JAX file: x (B, T, S, C), w (k, C, Co), g (B, T, S, Co);
the forward returns x's dtype, dw is f32 (k, C, Co). Odd k only; any C,
Co >= 1 (ragged widths are masked in the kernels).

Each public function routes as the port's other kernels do
(``ops.conv2plus1d._route``): a CUDA tensor goes to the kernel wrapper
(``*_cuda``: bf16 contiguous tensors on one device, launches on the current
stream, raises on a launch error and adds one to ``launch_counts``), a CPU
tensor to the plain version (``*_plain``: the kernel's arithmetic step by
step, in f32 accumulation); nothing falls back from the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops.conv2plus1d import (
    SMS,
    _acc_dtype,
    _check_kernel_tensors,
    _f32_accumulation,
    _route,
    _sm_count,
)

# Kernel launches since the last reset, by design (a K5 / K9 launch counts
# its pad pass, a K7 / K9 launch its reduce; ``v3`` counts the dx too).
launch_counts = {"v2": 0, "v3": 0, "dw_v3": 0, "v3p": 0, "dw_v2": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# The forward kernels' output tile (csrc/temporal_micro.cu: BM rows of a
# slab by BN output channels) and the dw kernels' (DW_BM input by DW_BN
# output channels of one tap).
BM, BN = 128, 64
DW_BM, DW_BN = 64, 64
DW_CHUNKS_PER_SM = 2  # the dw chunk count is capped at this many a SM


def _pick_tile(total: int, max_tile: int) -> int:
    """Largest divisor of ``total`` that is <= max_tile (the JAX package's
    ``ops/conv2plus1d.py::_pick_tile``, which the JAX benchmark imports as
    ``_divisor_tile``)."""
    for cand in range(min(max_tile, total), 0, -1):
        if total % cand == 0:
            return cand
    return 1


def _halved_tile(total: int, tile_s: int = 512) -> int:
    """v2's tile rule: halve from ``tile_s`` until the tile divides S."""
    while total % tile_s:
        tile_s //= 2
    return tile_s


class ForwardPlan(NamedTuple):
    tile_s: int  # (b, s) columns of a slab; a slab is (T, tile_s) rows of one clip
    slabs: int  # B * S / tile_s
    row_tiles: int  # BM-row tiles of a slab's T * tile_s rows
    co_tiles: int  # BN-wide tiles of the output channels

    @property
    def grid(self) -> int:
        return self.slabs * self.row_tiles * self.co_tiles


class DwPlan(NamedTuple):
    tile_s: int
    steps: int  # (b, s-tile) slabs, b-major as the TPU grid walks them
    chunks: int  # runs of steps, each a partial sum (1: dw written directly)
    steps_per_chunk: int
    c_tiles: int  # DW_BM-wide tiles of the input channels
    co_tiles: int  # DW_BN-wide tiles of the output channels


@functools.lru_cache(maxsize=256)
def forward_plan(x_shape, co: int, tile_s: int) -> ForwardPlan:
    """The forward kernels' grid for x (B, T, S, C) -> Co channels (the
    kernel works it out from the same arguments)."""
    b, t, s, _ = x_shape
    return ForwardPlan(tile_s, b * (s // tile_s), -(-t * tile_s // BM), -(-co // BN))


@functools.lru_cache(maxsize=256)
def dw_plan(x_shape, co: int, tile_s: int, sms: int = SMS) -> DwPlan:
    """K7's and K9's chunks: the (b, s-tile) steps cut into at most
    ``DW_CHUNKS_PER_SM * sms`` runs of equal length (the last may be
    shorter), one f32 partial of (k, C, Co) each; a block per (tap, C tile,
    Co tile, chunk)."""
    b, _, s, c = x_shape
    steps = b * (s // tile_s)
    per_chunk = -(-steps // max(1, min(steps, DW_CHUNKS_PER_SM * sms)))
    return DwPlan(tile_s, steps, -(-steps // per_chunk), per_chunk, -(-c // DW_BM),
                  -(-co // DW_BN))


def _sms(x: torch.Tensor) -> int:
    return _sm_count(x.device) if x.is_cuda else SMS


# ---------------------------------------------------------------------------
# The kernels' entry points (csrc/temporal_micro.cu)
# ---------------------------------------------------------------------------

# The entry points, one a kernel, by launch-count key: fvt_micro_<key>_bf16.
# fvt_micro_v2_bf16(x, w, xp, y, b, t, s, c, co, k, tile_s, device, stream)
# fvt_micro_v3_bf16 / fvt_micro_v3p_bf16(x, w, y, b, t, s, c, co, k, tile_s, device, stream)
# fvt_micro_dw_v3_bf16(x, g, ws, dw, b, t, s, c, co, k, tile_s, chunks, steps_per_chunk,
#                      device, stream)
# fvt_micro_dw_v2_bf16(x, g, xp, ws, dw, b, t, s, c, co, k, tile_s, chunks,
#                      steps_per_chunk, device, stream)
_ARGTYPES = {
    "v2": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "v3": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "v3p": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "dw_v3": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    "dw_v2": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
}

_entries: dict = {}


def _entry(key: str):
    """The C entry point of one design (csrc/temporal_micro.cu)."""
    if not _entries:
        lib = _build.load("temporal_micro")
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, f"fvt_micro_{name}_bf16")
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            _entries[name] = fn
    return _entries[key]


def _check_k(k: int) -> None:
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {k}")


def _check_forward(x: torch.Tensor, w: torch.Tensor, k: int) -> None:
    _check_kernel_tensors(x=x, w=w)
    _check_k(k)
    if x.ndim != 4:
        raise ValueError(f"x must be (B, T, S, C), got {tuple(x.shape)}")
    if w.ndim != 3 or tuple(w.shape[:2]) != (k, x.shape[-1]):
        raise ValueError(f"w must be ({k}, {x.shape[-1]}, Co), got {tuple(w.shape)}")


def _check_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> None:
    _check_kernel_tensors(x=x, g=g)
    _check_k(k)
    if x.ndim != 4 or g.ndim != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(f"x (B,T,S,C) and g (B,T,S,Co) must share B, T, S; got "
                         f"{tuple(x.shape)} and {tuple(g.shape)}")


def _padded_scratch(x: torch.Tensor, k: int) -> torch.Tensor:
    b, t, s, c = x.shape
    return torch.empty((b, t + 2 * (k // 2), s, c), dtype=x.dtype, device=x.device)


def _forward_launch(key: str, x: torch.Tensor, w: torch.Tensor, k: int,
                    tile_s: int) -> torch.Tensor:
    b, t, s, c = x.shape
    co = w.shape[-1]
    y = torch.empty((b, t, s, co), dtype=x.dtype, device=x.device)
    xp = _padded_scratch(x, k) if key == "v2" else None  # K5's scratch, held past the launch
    ptrs = [x.data_ptr(), w.data_ptr()] + ([xp.data_ptr()] if xp is not None else []) + [
        y.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry(key)(*ptrs, b, t, s, c, co, k, tile_s, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_micro_{key}_bf16 launch failed: CUDA error {rc}")
    launch_counts[key] += 1
    return y


def _dw_launch(key: str, x: torch.Tensor, g: torch.Tensor, k: int,
               tile_s: int) -> torch.Tensor:
    b, t, s, c = x.shape
    co = g.shape[-1]
    plan = dw_plan(tuple(x.shape), co, tile_s, _sms(x))
    dw = torch.empty((k, c, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((plan.chunks, k, c, co), dtype=torch.float32, device=x.device)
          if plan.chunks > 1 else None)
    xp = _padded_scratch(x, k) if key == "dw_v2" else None  # K9's scratch, held past the launch
    ptrs = [x.data_ptr(), g.data_ptr()] + ([xp.data_ptr()] if xp is not None else []) + [
        ws.data_ptr() if ws is not None else None, dw.data_ptr()]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry(key)(*ptrs, b, t, s, c, co, k, tile_s, plan.chunks, plan.steps_per_chunk,
                     x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_micro_{key}_bf16 launch failed: CUDA error {rc}")
    launch_counts[key] += 1
    return dw


# ---------------------------------------------------------------------------
# K5: pad, then the k taps over the halo'd slab
# ---------------------------------------------------------------------------


def temporal_v2_cuda(x: torch.Tensor, w: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    _check_forward(x, w, k)
    return _forward_launch("v2", x, w, k, _halved_tile(x.shape[2], tile_s))


def temporal_v2_plain(x: torch.Tensor, w: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    """K5's arithmetic: x zero-padded by k // 2 frames on T, then the k
    taps' products over the padded frames added into an f32 accumulator in
    tap order (the slab tiling only partitions the rows)."""
    t = x.shape[1]
    p = k // 2
    a = _acc_dtype(x)
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    acc = torch.zeros(x.shape[:3] + (w.shape[-1],), dtype=a, device=x.device)
    with _f32_accumulation():
        for dt in range(k):
            acc += xp[:, dt : dt + t].to(a) @ w[dt].to(a)
    return acc.to(x.dtype)


def temporal_v2(x: torch.Tensor, w: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    return _route(temporal_v2_cuda, temporal_v2_plain, x, w, k, tile_s)


# ---------------------------------------------------------------------------
# K6: no pad, the centre tap first, the other taps over their clipped rows
# ---------------------------------------------------------------------------


def temporal_v3_cuda(x: torch.Tensor, w: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    _check_forward(x, w, k)
    return _forward_launch("v3", x, w, k, _pick_tile(x.shape[2], max_tile))


def temporal_v3_plain(x: torch.Tensor, w: torch.Tensor,
                      k: int, max_tile: int = 448) -> torch.Tensor:
    """K6's arithmetic: the centre tap's product over every row starts the
    f32 accumulator; each other tap (offset off) adds its product to the
    output frames [max(0, -off), T - max(0, off)) from the input frames
    shifted by off; a tap with no such frame (T <= |off|) adds nothing."""
    t = x.shape[1]
    p = k // 2
    a = _acc_dtype(x)
    with _f32_accumulation():
        acc = x.to(a) @ w[p].to(a)
        for dt in range(k):
            off = dt - p
            rows = t - abs(off)
            if off == 0 or rows <= 0:
                continue
            lo_out, lo_in = max(0, -off), max(0, off)
            acc[:, lo_out : lo_out + rows] += x[:, lo_in : lo_in + rows].to(a) @ w[dt].to(a)
    return acc.to(x.dtype)


def temporal_v3(x: torch.Tensor, w: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    return _route(temporal_v3_cuda, temporal_v3_plain, x, w, k, max_tile)


def _dx_weight(w: torch.Tensor) -> torch.Tensor:
    """The dx's weight: time-flipped and io-transposed, (k, Co, C)."""
    return w.flip(0).transpose(1, 2).contiguous()


def temporal_dx_v3_cuda(g: torch.Tensor, w: torch.Tensor,
                        k: int, max_tile: int = 448) -> torch.Tensor:
    """dx of the stride-1 temporal conv with weight w (k, C, Co): K6 on the
    flipped, io-transposed weight. g (B, T, S, Co) -> (B, T, S, C)."""
    _check_kernel_tensors(g=g, w=w)
    return temporal_v3_cuda(g, _dx_weight(w), k, max_tile)


def temporal_dx_v3_plain(g: torch.Tensor, w: torch.Tensor,
                         k: int, max_tile: int = 448) -> torch.Tensor:
    return temporal_v3_plain(g, _dx_weight(w), k, max_tile)


def temporal_dx_v3(g: torch.Tensor, w: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    return _route(temporal_dx_v3_cuda, temporal_dx_v3_plain, g, w, k, max_tile)


# ---------------------------------------------------------------------------
# K8: packed taps, one contraction over k * C
# ---------------------------------------------------------------------------


def temporal_v3p_cuda(x: torch.Tensor, w: torch.Tensor,
                      k: int, max_tile: int = 448) -> torch.Tensor:
    _check_forward(x, w, k)
    return _forward_launch("v3p", x, w, k, _pick_tile(x.shape[2], max_tile))


def temporal_v3p_plain(x: torch.Tensor, w: torch.Tensor,
                       k: int, max_tile: int = 448) -> torch.Tensor:
    """K8's arithmetic: zero frames around x, the k shifted taps
    concatenated along channels into one (rows, k * C) operand, one product
    with w as (k * C, Co) in f32."""
    t, c = x.shape[1], x.shape[-1]
    p = k // 2
    a = _acc_dtype(x)
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    patches = torch.cat([xp[:, dt : dt + t] for dt in range(k)], dim=-1)
    with _f32_accumulation():
        return (patches.to(a) @ w.reshape(k * c, -1).to(a)).to(x.dtype)


def temporal_v3p(x: torch.Tensor, w: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    return _route(temporal_v3p_cuda, temporal_v3p_plain, x, w, k, max_tile)


# ---------------------------------------------------------------------------
# K7 and K9: the weight gradient, partial sums per chunk added in order
# ---------------------------------------------------------------------------


def _by_step(a: torch.Tensor, tile_s: int) -> torch.Tensor:
    """(B, T, S, C) as (steps, T, tile_s, C): the (b, s-tile) slabs b-major."""
    b, t, s, c = a.shape
    return a.reshape(b, t, s // tile_s, tile_s, c).transpose(1, 2).reshape(-1, t, tile_s, c)


def _dw_by_chunks(x_steps: torch.Tensor, g_steps: torch.Tensor, k: int, plan: DwPlan,
                  padded: bool) -> torch.Tensor:
    """Per chunk of steps, each tap's x^T g over the chunk's rows (the rows
    whose shifted input lies in [0, T), or every row of the padded x); the
    partials added in chunk order."""
    t = g_steps.shape[1]
    p = k // 2
    a = _acc_dtype(x_steps)
    dw = None
    with _f32_accumulation():
        for chunk in range(plan.chunks):
            steps = slice(chunk * plan.steps_per_chunk, (chunk + 1) * plan.steps_per_chunk)
            xc, gc = x_steps[steps], g_steps[steps]
            taps = []
            for dt in range(k):
                off = dt - p
                if padded:
                    rows, lo_in, lo_out = t, dt, 0
                else:
                    rows, lo_in, lo_out = t - abs(off), max(0, off), max(0, -off)
                if rows <= 0:
                    taps.append(torch.zeros((xc.shape[-1], gc.shape[-1]), dtype=a,
                                            device=xc.device))
                    continue
                xt = xc[:, lo_in : lo_in + rows].reshape(-1, xc.shape[-1]).to(a)
                gt = gc[:, lo_out : lo_out + rows].reshape(-1, gc.shape[-1]).to(a)
                taps.append(xt.T @ gt)
            part = torch.stack(taps)
            dw = part if dw is None else dw + part
    return dw


def temporal_dw_v3_cuda(x: torch.Tensor, g: torch.Tensor,
                        k: int, max_tile: int = 448) -> torch.Tensor:
    _check_dw(x, g, k)
    return _dw_launch("dw_v3", x, g, k, _pick_tile(x.shape[2], max_tile))


def temporal_dw_v3_plain(x: torch.Tensor, g: torch.Tensor,
                         k: int, max_tile: int = 448) -> torch.Tensor:
    """K7's arithmetic: dw[dt] = sum over rows of x[t + dt - p]^T g[t],
    over the rows where t + dt - p lies in [0, T), in f32, one partial per
    chunk of ``dw_plan``, the partials added in chunk order -> (k, C, Co)."""
    tile_s = _pick_tile(x.shape[2], max_tile)
    plan = dw_plan(tuple(x.shape), g.shape[-1], tile_s, _sms(x))
    return _dw_by_chunks(_by_step(x, tile_s), _by_step(g, tile_s), k, plan, padded=False)


def temporal_dw_v3(x: torch.Tensor, g: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    return _route(temporal_dw_v3_cuda, temporal_dw_v3_plain, x, g, k, max_tile)


def temporal_dw_v2_cuda(x: torch.Tensor, g: torch.Tensor,
                        k: int, tile_s: int = 512) -> torch.Tensor:
    _check_dw(x, g, k)
    return _dw_launch("dw_v2", x, g, k, _halved_tile(x.shape[2], tile_s))


def temporal_dw_v2_plain(x: torch.Tensor, g: torch.Tensor,
                         k: int, tile_s: int = 512) -> torch.Tensor:
    """K9's arithmetic: x zero-padded by k // 2 frames on T, then per chunk
    of ``dw_plan`` each tap's x_pad[t + dt]^T g[t] over every row, in f32;
    the partials added in chunk order -> (k, C, Co)."""
    tile_s = _halved_tile(x.shape[2], tile_s)
    plan = dw_plan(tuple(x.shape), g.shape[-1], tile_s, _sms(x))
    p = k // 2
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    return _dw_by_chunks(_by_step(xp, tile_s), _by_step(g, tile_s), k, plan, padded=True)


def temporal_dw_v2(x: torch.Tensor, g: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    return _route(temporal_dw_v2_cuda, temporal_dw_v2_plain, x, g, k, tile_s)
