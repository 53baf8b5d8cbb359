"""The temporal-conv micro-benchmark's five kernel designs: hand-written
Hopper kernels (csrc/temporal_micro.cu), their plain PyTorch versions, their
tile plans and launch counts.

They are the counterparts of the Pallas kernels in the JAX package's
``benchmarks/kernel_micro.py``, three designs of the temporal k x 1 x 1
conv's forward and two of its weight gradient, kept side by side so that
the benchmark compares designs:

- K5 ``temporal_v2`` (``pallas_temporal_v2``): the k taps' products over
  the halo'd (T + 2p) frames, accumulated in f32; the pad exists only in
  the kernel's shared memory (TMA fills frames outside [0, T) with zeros).
- K6 ``temporal_v3`` (``pallas_temporal_v3``): no pad; the centre tap
  starts the f32 accumulator and each other tap adds its product over the
  output frames whose shifted input lies in [0, T) (a tap with none is
  skipped). ``temporal_dx_v3`` is K6 on the time-flipped, io-transposed
  weight.
- K8 ``temporal_v3p`` (``pallas_temporal_v3p``): packed taps, one
  contraction over kappa = dt * C + c, k * C deep; the packed operand's
  zero rows are the halo frames (TMA's zero fill, as K5's).
- K7 ``temporal_dw_v3`` (``pallas_temporal_dw_v3``): dw without a pad, each
  tap's x^T g over its clipped rows.
- K9 ``temporal_dw_v2`` (``pallas_temporal_dw``): dw over every row of the
  padded x, the halo frames TMA's zero fill (no pad pass).

K5, K6 and K8 run on one kernel, ``micro_ring_kernel`` (K8 on K5's walk): a
work item is one clip, 64 columns of S, one Co tile, one group of input
channels and one group of taps, and walks T with each input frame loaded
once into a ring of frame slots (``ring_plan`` sizes it). Their tile
arguments (``tile_s``, ``max_tile``) keep the JAX signatures and do
nothing else.

The TPU dw kernels add into one output block across a grid that runs in
order; CUDA blocks run at once, so K9 and K7 run on
``micro_dw_ring_kernel``: a block owns a tap group, a C tile and a 64-wide
Co tile of dw and keeps it in registers over a chunk of (clip, 64-column)
items, each walked over T with each x and g frame loaded once into rings
of frame slots (K9 every frame of the padded walk, K7 the walk clipped to
[0, T), each tap issued only where its x frame lies there), and writes an
f32 partial per chunk that a second kernel adds in DW_REDUCE_GROUPS
interleaved groups, a fixed order (no atomics: two launches are bitwise
equal). ``dw_ring_plan`` sizes both; their tile arguments keep the JAX
signatures only.

Shapes follow the JAX file: x (B, T, S, C), w (k, C, Co), g (B, T, S, Co);
the forward returns x's dtype, dw is f32 (k, C, Co). Odd k only; any C,
Co >= 1 (ragged widths are masked in the kernels). Where the k taps'
weights and k + 1 frame slots do not fit a block's shared memory (k >= 15
at one 64-channel box), ``ring_plan`` splits the taps into groups whose
f32 partials the reduce adds, as it splits C.

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

# Kernel launches since the last reset, by design (a launch counts its
# channel pads and reduce where the plan or the inputs need them; ``v3``
# counts the dx too).
launch_counts = {"v2": 0, "v3": 0, "dw_v3": 0, "v3p": 0, "dw_v2": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# K5's, K6's and K8's ring (csrc/temporal_micro.cu, micro_ring_kernel): an item's
# S columns, the channels of one TMA box (128 bytes, the swizzle's row), the
# Co tiles it can take, the shared memory of a block, the bytes of a box and
# the alignment slack; frame slots past k + 1 (the fewest that cannot
# deadlock: two output frames in flight) up to RING_AHEAD more.
RING_COLS, RING_CH = 64, 64
RING_BNS = (64, 128, 144)
RING_SMEM_MAX = 232_448
RING_BOX = RING_COLS * RING_CH * 2
RING_ALIGN = 1024
RING_AHEAD = 4
RING_CONSUMERS = 2  # warpgroups, one output frame each
# K9's and K7's ring (micro_dw_ring_kernel): a consumer warpgroup per tap
# of a tap group, a 64-wide Co tile (wgmma's M, one g box).
DW_RING_TAPS = 3
DW_RING_M = 64
# Their reduce (micro_dw_ring_reduce_kernel): group j adds chunks j, j + G,
# ... in order, then the G group sums are added in group order.
DW_REDUCE_GROUPS = 8


class RingPlan(NamedTuple):
    bn: int  # Co tile
    co_tiles: int
    groups: int  # of input channels, each an f32 partial sum (1: y written directly)
    chunks: int  # 64-channel boxes of a group
    slots: int  # frame slots of the ring
    stage: int  # bytes of a consumer warpgroup's y staging tile (0: stores from registers)
    cols: int  # 64-column tiles of S, all clips: B * ceil(S / 64)
    items: int  # cols * co_tiles * groups * tap_groups
    blocks: int  # persistent, one an SM
    smem: int  # dynamic shared memory of a block, bytes
    taps: int  # taps of a tap group (k: one group)
    tap_groups: int  # each an f32 partial sum beside the channel groups' (1: all k taps)

    @property
    def partials(self) -> int:
        """The f32 partial sums the reduce adds (1: y written directly)."""
        return self.groups * self.tap_groups


class DwRingPlan(NamedTuple):
    bn: int  # C tile (wgmma's N)
    c_tiles: int
    co_tiles: int  # DW_RING_M wide
    taps: int  # of a tap group (the last may have fewer)
    tap_groups: int
    xslots: int  # x frame slots (taps + RING_AHEAD)
    gslots: int  # g frame slots (1 + RING_AHEAD)
    cols: int  # items: B * ceil(S / 64)
    chunks: int  # runs of items, each an f32 partial (1: dw written directly)
    cols_per_chunk: int
    blocks: int  # tiles * chunks: one an SM where the tiles fit the SMs
    smem: int  # dynamic shared memory of a block, bytes
    partial_bytes: int  # f32 partials written and read again by the reduce (0: one chunk)

    @property
    def tiles(self) -> int:
        """Output tiles: (tap group, C tile, Co tile), one a block of a chunk."""
        return self.tap_groups * self.c_tiles * self.co_tiles


def _ring_smem(taps: int, chunks: int, bn: int, slots: int, stage: int = 0) -> int:
    """The weights (a tap group's taps of BN rows x the group's boxes), the
    frame slots and their two mbarriers, the two consumer warpgroups' y
    staging tiles, the slack to align the base."""
    return (RING_ALIGN + taps * chunks * bn * 128 + slots * (chunks * RING_BOX + 16)
            + RING_CONSUMERS * stage)


@functools.lru_cache(maxsize=256)
def ring_plan(x_shape, co: int, k: int, sms: int = SMS) -> RingPlan:
    """K5's, K6's and K8's plan for x (B, T, S, C) -> Co channels. The Co tile
    covers Co, or is the narrowest of RING_BNS with the fewest tiles; where
    the k taps' weights and k + 1 frame slots do not fit a block's shared
    memory, a narrower tile with more tiles, then C split into the fewest
    groups that fit, then (k >= 15) the taps split into the fewest groups
    that fit, each group an f32 partial that a second kernel adds. y goes
    out through a staging tile and TMA stores where there is one partial,
    Co % 8 == 0, the tile's 64-channel store boxes stay inside its Co tile
    (BN = 144 only where it covers Co) and the tiles fit beside taps + 2
    slots, else from registers. Blocks: one an SM, a multiple of the
    (tap group, channel group, Co tile) count where there are as many SMs,
    so that a block's weights never change."""
    b, _, s, c = x_shape
    boxes = -(-c // RING_CH)
    by_tiles = sorted(RING_BNS, key=lambda bn: (-(-co // bn), bn))
    for tap_groups in range(1, k + 1):
        taps = -(-k // tap_groups)
        if -(-k // taps) != tap_groups:
            continue  # the same taps a group as fewer groups
        for groups in range(1, boxes + 1):
            chunks = -(-boxes // groups)
            if -(-boxes // chunks) != groups:
                continue  # the same boxes a group as fewer groups
            for bn, stage in ((bn, stage) for bn in by_tiles
                              for stage in (-(-bn // RING_CH) * RING_BOX, 0)):
                if stage and (groups > 1 or tap_groups > 1 or co % 8
                              or (bn % RING_CH and co > bn)):
                    continue
                room = RING_SMEM_MAX - _ring_smem(taps, chunks, bn, 0, stage)
                slots = min(taps + 1 + RING_AHEAD, room // (chunks * RING_BOX + 16))
                if slots < taps + 1 + (stage > 0):
                    continue
                co_tiles = -(-co // bn)
                cols = b * -(-s // RING_COLS)
                n_w = co_tiles * groups * tap_groups
                blocks = min(cols * n_w, sms)
                if blocks >= n_w:
                    blocks -= blocks % n_w
                return RingPlan(bn, co_tiles, groups, chunks, slots, stage, cols, cols * n_w,
                                blocks, _ring_smem(taps, chunks, bn, slots, stage), taps,
                                tap_groups)
    raise AssertionError("one tap of one 64-channel box always fits")


def _dw_ring_smem(boxes: int, xslots: int, gslots: int) -> int:
    """The x ring (xslots of a C tile's boxes), the g ring (gslots of one
    box), their full and empty mbarriers, the slack to align the base."""
    return RING_ALIGN + (xslots * boxes + gslots) * RING_BOX + (xslots + gslots) * 16


@functools.lru_cache(maxsize=256)
def dw_ring_plan(x_shape, co: int, k: int, sms: int = SMS) -> DwRingPlan:
    """K9's and K7's plan for x (B, T, S, C), g (B, T, S, Co). A block owns one tile
    of dw: a tap group (up to DW_RING_TAPS taps, a consumer warpgroup each),
    a C tile (the fewest of RING_BNS, then the narrowest) and a 64-wide Co
    tile; the (clip, 64-column) items are cut into as many runs ("chunks")
    of equal length (the last may be shorter) as fill the SMs with every
    tile once a chunk, each chunk an f32 partial of (k, C, Co) that a second
    kernel adds in order (one chunk: dw written directly). x is read once
    per Co tile and tap group, g once per C tile and tap group. The rings
    hold taps + RING_AHEAD x frames and 1 + RING_AHEAD g frames."""
    b, _, s, c = x_shape
    bn = min(RING_BNS, key=lambda bn: (-(-c // bn), bn))
    taps = min(k, DW_RING_TAPS)
    tap_groups = -(-k // taps)
    c_tiles, co_tiles = -(-c // bn), -(-co // DW_RING_M)
    tiles = tap_groups * c_tiles * co_tiles
    cols = b * -(-s // RING_COLS)
    per_chunk = -(-cols // max(1, min(cols, sms // tiles)))
    chunks = -(-cols // per_chunk)
    xslots, gslots = taps + RING_AHEAD, 1 + RING_AHEAD
    smem = _dw_ring_smem(-(-bn // RING_CH), xslots, gslots)
    assert smem <= RING_SMEM_MAX
    return DwRingPlan(bn, c_tiles, co_tiles, taps, tap_groups, xslots, gslots, cols, chunks,
                      per_chunk, tiles * chunks, smem,
                      chunks * k * c * co * 4 if chunks > 1 else 0)


def _sms(x: torch.Tensor) -> int:
    return _sm_count(x.device) if x.is_cuda else SMS


# ---------------------------------------------------------------------------
# The kernels' entry points (csrc/temporal_micro.cu)
# ---------------------------------------------------------------------------

# The entry points, one a kernel, by launch-count key: fvt_micro_<key>_bf16.
# fvt_micro_v2_bf16 / fvt_micro_v3_bf16 / fvt_micro_v3p_bf16(x, w, xs, ws, y, b, t, s, c, co,
#                                    k, bn, slots, groups, taps, stage, blocks, smem, device,
#                                    stream)
# fvt_micro_dw_v3_bf16 / fvt_micro_dw_v2_bf16(x, g, xs, gs, ws, dw, b, t, s, c, co, k, bn,
#                                             taps, xslots, gslots, chunks, cols_per_chunk,
#                                             smem, device, stream)
_RING_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_DW_RING_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
_ARGTYPES = {
    "v2": _RING_ARGTYPES,
    "v3": _RING_ARGTYPES,
    "dw_v3": _DW_RING_ARGTYPES,
    "v3p": _RING_ARGTYPES,
    "dw_v2": _DW_RING_ARGTYPES,
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


def channel_pad_launches() -> int:
    """The channel-pad copies (``micro_ring_pad_kernel``) the library has
    launched: x of K5, K6 and K8, x and g of K9 and K7, where C (Co) % 8 != 0 or
    the tensor is not 16-byte aligned; aligned inputs launch none."""
    fn = _build.load("temporal_micro").fvt_micro_channel_pad_launches
    fn.argtypes, fn.restype = [], ctypes.c_longlong
    return fn()


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


def _channel_padded(a: torch.Tensor) -> torch.Tensor | None:
    """The scratch for a channel-padded copy of ``a`` that TMA can read
    (channels rounded up to 8), where ``a``'s rows are not 16-byte rows at
    a 16-byte aligned start; else None."""
    c = a.shape[-1]
    if c % 8 == 0 and a.data_ptr() % 16 == 0:
        return None
    return torch.empty((a.numel() // c, -(-c // 8) * 8), dtype=a.dtype, device=a.device)


def _ring_launch(key: str, x: torch.Tensor, w: torch.Tensor, k: int) -> torch.Tensor:
    """K5 / K6 / K8 with ``ring_plan``'s plan: y, and only where the plan or x
    needs them, the channel-padded copy of x that TMA can read (C % 8 != 0,
    or x not 16-byte aligned) and the groups' f32 partials; all held past
    the launch."""
    b, t, s, c = x.shape
    co = w.shape[-1]
    plan = ring_plan(tuple(x.shape), co, k, _sms(x))
    y = torch.empty((b, t, s, co), dtype=x.dtype, device=x.device)
    xs = _channel_padded(x)
    ws = (torch.empty((plan.partials, b * t * s, co), dtype=torch.float32, device=x.device)
          if plan.partials > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry(key)(x.data_ptr(), w.data_ptr(), xs.data_ptr() if xs is not None else None,
                     ws.data_ptr() if ws is not None else None, y.data_ptr(), b, t, s, c, co, k,
                     plan.bn, plan.slots, plan.groups, plan.taps, plan.stage, plan.blocks,
                     plan.smem, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_micro_{key}_bf16 launch failed: CUDA error {rc}")
    launch_counts[key] += 1
    return y


def _dw_ring_launch(key: str, x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """K9 or K7 (``key``) with ``dw_ring_plan``'s plan: dw, and only where the plan or the
    inputs need them, the channel-padded copies of x and g that TMA can
    read and the chunks' f32 partials; all held past the launch."""
    b, t, s, c = x.shape
    co = g.shape[-1]
    plan = dw_ring_plan(tuple(x.shape), co, k, _sms(x))
    dw = torch.empty((k, c, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((plan.chunks, k, c, co), dtype=torch.float32, device=x.device)
          if plan.chunks > 1 else None)
    xs, gs = _channel_padded(x), _channel_padded(g)
    ptrs = [a.data_ptr() if a is not None else None for a in (x, g, xs, gs, ws, dw)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _entry(key)(*ptrs, b, t, s, c, co, k, plan.bn, plan.taps, plan.xslots, plan.gslots,
                     plan.chunks, plan.cols_per_chunk, plan.smem, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_micro_{key}_bf16 launch failed: CUDA error {rc}")
    launch_counts[key] += 1
    return dw


# ---------------------------------------------------------------------------
# K5: the k taps over the halo'd frames
# ---------------------------------------------------------------------------


def temporal_v2_cuda(x: torch.Tensor, w: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    """K5 on the ring (``tile_s`` keeps the JAX signature only)."""
    _check_forward(x, w, k)
    return _ring_launch("v2", x, w, k)


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
    """K6 on the ring (``max_tile`` keeps the JAX signature only)."""
    _check_forward(x, w, k)
    return _ring_launch("v3", x, w, k)


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
    """K8 on the ring, K5's walk (``max_tile`` keeps the JAX signature
    only)."""
    _check_forward(x, w, k)
    return _ring_launch("v3p", x, w, k)


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
# K9 and K7: the weight gradient on the dw ring, partial sums per chunk
# ---------------------------------------------------------------------------


def _by_step(a: torch.Tensor, tile_s: int) -> torch.Tensor:
    """(B, T, S, C) as (steps, T, tile_s, C): the (b, s-tile) slabs b-major."""
    b, t, s, c = a.shape
    return a.reshape(b, t, s // tile_s, tile_s, c).transpose(1, 2).reshape(-1, t, tile_s, c)


def _add_in_groups(parts: list) -> torch.Tensor:
    """The partials added as the ring's reduce adds them: group j of
    DW_REDUCE_GROUPS sums partials j, j + DW_REDUCE_GROUPS, ... in order,
    then the group sums are added in group order."""
    sums = [None] * DW_REDUCE_GROUPS
    for i, part in enumerate(parts):
        j = i % DW_REDUCE_GROUPS
        sums[j] = part if sums[j] is None else sums[j] + part
    dw = sums[0]
    for part in sums[1:]:
        if part is not None:
            dw = dw + part
    return dw


def _dw_by_chunks(x_steps: torch.Tensor, g_steps: torch.Tensor, k: int, chunks: int,
                  per_chunk: int, padded: bool) -> torch.Tensor:
    """Per chunk of ``per_chunk`` steps, each tap's x^T g over the chunk's
    rows (the rows whose shifted input lies in [0, T), or every row of the
    padded x); the partials added as the ring's reduce adds them."""
    t = g_steps.shape[1]
    p = k // 2
    a = _acc_dtype(x_steps)
    parts = []
    with _f32_accumulation():
        for chunk in range(chunks):
            steps = slice(chunk * per_chunk, (chunk + 1) * per_chunk)
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
            parts.append(torch.stack(taps))
        return _add_in_groups(parts)


def _dw_ring_plain(x: torch.Tensor, g: torch.Tensor, k: int, padded: bool) -> torch.Tensor:
    """The dw ring's arithmetic: per chunk of ``dw_ring_plan`` (a run of
    (clip, 64-column) items, S zero-padded to whole items) each tap's x^T g
    in f32, over every row of x zero-padded by k // 2 frames on T (K9) or
    over the rows whose shifted frame lies in [0, T) (K7); the partials
    added as the kernel's reduce adds them (in DW_REDUCE_GROUPS interleaved
    groups, each in chunk order, then the groups in order) -> (k, C, Co)."""
    plan = dw_ring_plan(tuple(x.shape), g.shape[-1], k, _sms(x))
    p = k // 2 if padded else 0
    cols = -(-x.shape[2] // RING_COLS) * RING_COLS - x.shape[2]
    xp = F.pad(x, (0, 0, 0, cols, p, p))
    gp = F.pad(g, (0, 0, 0, cols))
    return _dw_by_chunks(_by_step(xp, RING_COLS), _by_step(gp, RING_COLS), k, plan.chunks,
                         plan.cols_per_chunk, padded)


def temporal_dw_v3_cuda(x: torch.Tensor, g: torch.Tensor,
                        k: int, max_tile: int = 448) -> torch.Tensor:
    """K7 on the dw ring, the clipped walk (``max_tile`` keeps the JAX
    signature only)."""
    _check_dw(x, g, k)
    return _dw_ring_launch("dw_v3", x, g, k)


def temporal_dw_v3_plain(x: torch.Tensor, g: torch.Tensor,
                         k: int, max_tile: int = 448) -> torch.Tensor:
    """K7's arithmetic: dw[dt] = sum over rows of x[t + dt - p]^T g[t],
    over the rows where t + dt - p lies in [0, T) (a tap with none: zeros),
    chunk by chunk as the ring walks them (``_dw_ring_plain``). ``max_tile``
    keeps the JAX signature only."""
    return _dw_ring_plain(x, g, k, padded=False)


def temporal_dw_v3(x: torch.Tensor, g: torch.Tensor, k: int, max_tile: int = 448) -> torch.Tensor:
    return _route(temporal_dw_v3_cuda, temporal_dw_v3_plain, x, g, k, max_tile)


def temporal_dw_v2_cuda(x: torch.Tensor, g: torch.Tensor,
                        k: int, tile_s: int = 512) -> torch.Tensor:
    """K9 on the dw ring (``tile_s`` keeps the JAX signature only)."""
    _check_dw(x, g, k)
    return _dw_ring_launch("dw_v2", x, g, k)


def temporal_dw_v2_plain(x: torch.Tensor, g: torch.Tensor,
                         k: int, tile_s: int = 512) -> torch.Tensor:
    """K9's arithmetic: dw[dt] = sum over rows of x_pad[t + dt]^T g[t], x
    zero-padded by k // 2 frames on T, every row, chunk by chunk as the
    ring walks them (``_dw_ring_plain``). ``tile_s`` keeps the JAX
    signature only."""
    return _dw_ring_plain(x, g, k, padded=True)


def temporal_dw_v2(x: torch.Tensor, g: torch.Tensor, k: int, tile_s: int = 512) -> torch.Tensor:
    return _route(temporal_dw_v2_cuda, temporal_dw_v2_plain, x, g, k, tile_s)
