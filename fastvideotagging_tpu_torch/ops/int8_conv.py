"""The int8 engine's two hand-written Hopper kernels, their plain PyTorch
versions and their launch counts (csrc/int8_conv.cu).

- ``conv3d_s8_hopper_kernel`` (Q1): the int8 x int8 -> int32 conv over a
  general 3-D tap set (strides, low and high pads) with the requant
  epilogue ``fma(f32(acc), mul * s, add)``, then one of three forms: (a)
  ReLU? and a bf16 or f32 store; (b) ReLU?, bf16, and Q2's static quantize
  for the next site (``Requant``), stored int8 at its padded width; (c) a
  block's tail: a ``Residual`` added, ReLU, bf16, then (b)'s quantize and/or
  the bf16 store. Each form is the chain of plain steps it replaces,
  rounding for rounding (``conv3d_s8_plain`` composes them). A bf16 output
  (form (a), or (c) with the bf16 store) can also reduce the next site's
  dynamic amax (``Amax``), so that Q2 runs its quantize pass alone there.
- ``quantize_s8_kernel`` (Q2): a bf16 or f32 activation to int8 in the two
  operation orders of the JAX engine (static, dynamic), the dynamic scale
  from an amax that a Q1 epilogue reduced, or from Q2's own amax pass
  ``quantize_amax_kernel`` where no Q1 call alone produced the activation.

Neither replaces a TPU kernel: the JAX engine (``fastvideotagging_tpu/ops/
int8_infer.py``) leaves both to XLA. A CUDA tensor goes to the kernel, a
CPU tensor to the plain version; nothing falls back. The activations cross
between them as ``(N, T, H, W, cp)`` int8 with the channels zero-padded to
``cp``, a multiple of 16 (a 16-byte load holds 16 channels; zero channels
leave the int32 sum exact); the weights as ``(Co, taps, cp)`` int8, K-major,
laid out once per qpack by ``weight_layout``. The scales stay on the device
as 0-d f32 tensors: no scale is read back to the host. A dynamic forward
takes each site's amax and scale from one ``ScaleSlots`` buffer, zeroed
once.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops.conv2plus1d import (
    _K1_BNS,
    SMEM_LIMIT,
    SMS,
    _sm_count,
)

# Launches since the last reset: Q1, Q2's quantize pass, Q2's amax pass
# (dynamic mode, where no Q1 epilogue reduced the amax).
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


# fvt_conv3d_s8(x, wk, mul, add, s, y, y2, res, res_inv_f, res_s, q_inv_f, q_s, amax,
# amax_inv_f, n, t, h, w, cp, to, ho, wo, kt, kh, kw, st, sh, sw, pt, ph, pw, co, relu, out,
# ld, res_kind, res_ld, bn, stages, staged, blocks, smem_bytes, device, stream)
_Q1_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_longlong] + [ctypes.c_int] * 28
                + [ctypes.c_void_p])
# fvt_quantize_s8(y, in_f32, inv_f, s_in, amax, s_out, q, rows, c, cp, mode, device, stream)
_Q2_ARGTYPES = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
# Q2's modes (the entry point's `mode`)
_Q2_STATIC, _Q2_DYNAMIC, _Q2_GIVEN = 0, 1, 2

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

_Q1_BM = 128  # output rows of a tile (64 a consumer warpgroup)
_Q1_BK = 128  # contraction slice: 128 int8, 128 bytes a row
_Q1_CONSUMERS = 2  # consumer warpgroups (a producer warpgroup beside them)
_Q1_MAX_STAGES = 6  # slices in the ring, at most
_Q1_MIN_STAGES = 4
_Q1_ALIGN = 1024
_Q1_ROWS_TABLE = _Q1_BM * 16  # the tile's row coordinates, an int4 a row
_Q1_OUT_BOX = 16  # bytes of a row of an output staging box (64 rows a box)
_Q1_FIXED = 64  # a tile's cost past its columns, in columns (its epilogue, its ring's fill)
# the form of Q1's output (the kernel's `out`) and of its residual (`res_kind`)
_OUT = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}
_RES = {None: 0, "dequant": 1, "f32": 2, "bf16": 3}


class ConvS8Plan(NamedTuple):
    bn: int  # output channels per tile (wgmma's N: 64, 128 or 144, all valid for .s8)
    stages: int  # slices in the ring
    staged: bool  # the output goes through shared memory and TMA stores
    smem_bytes: int  # dynamic shared memory of one block
    row_tiles: int  # tiles along the output rows (128 each)
    col_tiles: int  # tiles along the output channels (bn each)
    slices: int  # 128-deep slices of the contraction taps * cp
    grid: int  # blocks launched (persistent: one an SM, each walks its tiles)

    @property
    def tiles(self) -> int:
        return self.row_tiles * self.col_tiles


def _q1_smem(bn: int, stages: int, out_bytes: int, staged: bool) -> int:
    """The ring, the two consumers' staging tiles, the row table, their
    column tables (a float4 a column) and the barriers
    (csrc/int8_conv.cu::conv_smem computes the same)."""
    staging = _Q1_CONSUMERS * 64 * bn * out_bytes if staged else 0
    return (_Q1_ALIGN + stages * (_Q1_BM + bn) * _Q1_BK + staging + _Q1_ROWS_TABLE
            + _Q1_CONSUMERS * bn * 16 + 16 * stages)


@functools.lru_cache(maxsize=512)
def conv_s8_plan(rows: int, co: int, taps: int, cp: int, out_bytes: int = 2,
                 row_bytes: int | None = None, sms: int = SMS) -> ConvS8Plan:
    """Q1's launch plan: ``rows`` output rows, ``co`` output channels, a
    contraction of ``taps`` taps of ``cp`` channels, an output of
    ``out_bytes`` an element and ``row_bytes`` a row (``co * out_bytes``
    unless the output is the next site's padded int8).

    The column tile is K1's rule (ops/conv2plus1d.py::_taps_plan): the
    narrowest tile that covers Co, else the widest that divides it, else the
    least wasteful. Where the row tiles are fewer than the SMs, a narrower
    tile is taken if it finishes sooner: the waves of tiles times a tile's
    cost, its columns plus a fixed part (ties go to the wider tile, which
    reads A fewer times). The output is staged for TMA stores where a row is
    a whole number of 16-byte boxes. The ring takes what shared memory is
    left, up to 6 stages; the block uses more than half of an SM's shared
    memory, so one block runs on an SM (what setmaxnreg's split of the
    register file assumes)."""
    covering = [bn for bn in _K1_BNS if bn >= co]
    dividing = [bn for bn in _K1_BNS if co % bn == 0]
    if covering:
        bn = covering[-1]
    elif dividing:
        bn = dividing[0]
    else:
        bn = min(_K1_BNS, key=lambda b: (-(-co // b) * b - co, -b))
    row_tiles = -(-rows // _Q1_BM)
    if row_tiles < sms:
        def makespan(b):
            return -(-row_tiles * -(-co // b) // sms) * (b + _Q1_FIXED)
        bn = min([bn] + [b for b in _K1_BNS if b < bn], key=lambda b: (makespan(b), -b))
    row_bytes = co * out_bytes if row_bytes is None else row_bytes
    staged = row_bytes % _Q1_OUT_BOX == 0
    stages = _Q1_MAX_STAGES
    while _q1_smem(bn, stages, out_bytes, staged) > SMEM_LIMIT:
        stages -= 1
    if stages < _Q1_MIN_STAGES:
        raise ValueError(f"Q1 has no plan for BN {bn} with {out_bytes}-byte outputs")
    smem = _q1_smem(bn, stages, out_bytes, staged)
    tiles = row_tiles * -(-co // bn)
    return ConvS8Plan(bn, stages, staged, smem, row_tiles, -(-co // bn), -(-taps * cp // _Q1_BK),
                      min(tiles, sms))


def weight_layout(w: torch.Tensor) -> torch.Tensor:
    """int8 weights (kt, kh, kw, C, Co) -> Q1's K-major (Co, kt*kh*kw, cp),
    the input channels zero-padded to ``cp``. Done once per qpack."""
    kt, kh, kw, c, co = w.shape
    wk = w.permute(4, 0, 1, 2, 3).reshape(co, kt * kh * kw, c)
    return F.pad(wk, (0, padded_channels(c) - c)).contiguous()


class Residual(NamedTuple):
    """A block's residual, added to its last conv's requantized output
    before the block's ReLU (epilogue form (c)): ``kind`` 'dequant' (``t``
    the block input's int8 q, read back as ``q * (s / inv_f)`` with its
    site's ``inv_f`` and scale ``s``), 'f32' (``t`` the downsample conv's
    f32 output) or 'bf16' (``t`` the bf16 block input). ``t`` has the
    output's shape (q: at its padded width)."""
    kind: str
    t: torch.Tensor
    inv_f: torch.Tensor | None = None
    s: torch.Tensor | None = None


class Requant(NamedTuple):
    """The next site's static quantize in Q1's epilogue (forms (b), (c)):
    Q2's static pass on the bf16 output with the site's ``inv_f`` and scale
    ``s``; ``keep_bf16`` returns the bf16 output beside the int8 one."""
    inv_f: torch.Tensor
    s: torch.Tensor
    keep_bf16: bool = False


class Amax(NamedTuple):
    """The next site's dynamic amax, reduced in the epilogue of a bf16
    output (form (a), or (c) with the bf16 store): ``max |f32(bf16 y) *
    inv_f|`` over the output, Q2's amax pass on it, into ``out`` (a 0-d
    f32 that holds 0 or an earlier partial max; None: a new one)."""
    inv_f: torch.Tensor
    out: torch.Tensor | None = None


class ScaleSlots:
    """The device words of one dynamic forward: a site's amax (reduced from
    0 by Q1's epilogue or Q2's amax pass, as the bits of a non-negative
    f32) and its scale (Q2's quantize pass writes it), all zeroed by one
    fill. ``take()`` hands out the next site's pair of 0-d f32 views."""

    def __init__(self, n: int, device):
        self._words = torch.zeros((n, 2), dtype=torch.float32, device=device)
        self._used = 0

    def take(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._used == len(self._words):
            raise RuntimeError(f"all {len(self._words)} scale slots of the forward are taken")
        self._used += 1
        return self._words[self._used - 1, 0], self._words[self._used - 1, 1]


def _fresh_slot(device) -> tuple[torch.Tensor, torch.Tensor]:
    return ScaleSlots(1, device).take()


def out_size(n: int, k: int, s: int, pad) -> int:
    return (n + pad[0] + pad[1] - k) // s + 1


def _check_form(out_f32, requant, amax):
    if requant is not None and out_f32:
        raise ValueError("a requantized output is int8 (and bf16), not f32")
    if amax is not None and (out_f32 or requant is not None):
        raise ValueError("the amax is reduced over a bf16 output, not an f32 or int8 one")


def _check_q1(q, wk, kernel_size, mul, add, s, strides, pads, out_f32=False, residual=None,
              requant=None, amax=None):
    if q.dtype != torch.int8 or wk.dtype != torch.int8 or q.ndim != 5 or wk.ndim != 3:
        raise ValueError(f"q (N,T,H,W,cp) and wk (Co,taps,cp) must be int8, got "
                         f"{q.dtype} {tuple(q.shape)} and {wk.dtype} {tuple(wk.shape)}")
    kt, kh, kw = kernel_size
    cp = q.shape[-1]
    if cp % CHANNEL_ALIGN or wk.shape[1:] != (kt * kh * kw, cp):
        raise ValueError(f"q's channels {cp} must be a multiple of {CHANNEL_ALIGN} and wk "
                         f"(Co, {kt * kh * kw}, {cp}); got wk {tuple(wk.shape)}")
    co = wk.shape[0]
    _check_form(out_f32, requant, amax)
    vectors = [("mul", mul), ("add", add)]
    scalars = [("s", s)]
    if requant is not None:
        vectors.append(("requant.inv_f", requant.inv_f))
        scalars.append(("requant.s", requant.s))
    if amax is not None:
        vectors.append(("amax.inv_f", amax.inv_f))
        if amax.out is not None:
            scalars.append(("amax.out", amax.out))
    if residual is not None:
        if residual.kind not in ("dequant", "f32", "bf16"):
            raise ValueError(f"unknown residual kind {residual.kind!r}")
        want = {"dequant": torch.int8, "f32": torch.float32, "bf16": torch.bfloat16}[residual.kind]
        width = padded_channels(co) if residual.kind == "dequant" else co
        if residual.t.dtype != want or residual.t.ndim != 5 or residual.t.shape[-1] != width:
            raise ValueError(f"a {residual.kind} residual is {want} (..., {width}), got "
                             f"{residual.t.dtype} {tuple(residual.t.shape)}")
        if residual.kind == "dequant":
            vectors.append(("residual.inv_f", residual.inv_f))
            scalars.append(("residual.s", residual.s))
    for name, t in vectors:
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != (co,):
            raise ValueError(f"{name} must be f32 ({co},), got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
    for name, t in scalars:
        if t is None or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be one f32 value, got "
                             f"{None if t is None else (t.dtype, tuple(t.shape))}")
    if len(strides) != 3 or len(pads) != 3 or min(strides) < 1:
        raise ValueError(f"bad strides {strides} or pads {pads}")


def _out_shape(q, kernel_size, strides, pads, co):
    n, t, h, w, _ = q.shape
    return (n,) + tuple(out_size(d, k, st, p) for d, k, st, p in
                        zip((t, h, w), kernel_size, strides, pads)) + (co,)


def conv3d_s8_cuda(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool,
                   out_f32: bool, residual: Residual | None = None,
                   requant: Requant | None = None, amax: Amax | None = None):
    """Q1 on the card: q (N, T, H, W, cp) int8, wk (Co, kt*kh*kw, cp) int8,
    mul / add (Co,) f32, s a 0-d f32, all on one CUDA device; ``pads`` (lo,
    hi) per (T, H, W). Returns what ``conv3d_s8`` returns."""
    _check_q1(q, wk, kernel_size, mul, add, s, strides, pads, out_f32, residual, requant, amax)
    dev = q.device
    if amax is not None and amax.out is None:
        amax = amax._replace(out=torch.zeros((), dtype=torch.float32, device=dev))
    tensors = [("q", q), ("wk", wk), ("mul", mul), ("add", add), ("s", s)]
    if residual is not None:
        tensors += [("residual.t", residual.t), ("residual.inv_f", residual.inv_f),
                    ("residual.s", residual.s)]
    if requant is not None:
        tensors += [("requant.inv_f", requant.inv_f), ("requant.s", requant.s)]
    if amax is not None:
        tensors += [("amax.inv_f", amax.inv_f), ("amax.out", amax.out)]
    for name, t in tensors:
        if t is not None and (t.device != dev or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {dev}")
    n, t, h, w, cp = q.shape
    kt, kh, kw = kernel_size
    co = wk.shape[0]
    shape = _out_shape(q, kernel_size, strides, pads, co)
    q = q.clone() if q.data_ptr() % 16 else q
    wk = wk.clone() if wk.data_ptr() % 16 else wk
    y2 = None
    if requant is not None:
        ld = padded_channels(co)
        y = torch.empty(shape[:-1] + (ld,), dtype=torch.int8, device=dev)
        if requant.keep_bf16:
            y2 = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    else:
        ld = co
        y = torch.empty(shape, dtype=torch.float32 if out_f32 else torch.bfloat16, device=dev)
    rows = n * shape[1] * shape[2] * shape[3]
    plan = conv_s8_plan(rows, co, kt * kh * kw, cp, y.element_size(), ld * y.element_size(),
                        _sm_count(dev))
    res = residual.t if residual is not None else None
    ptr = (lambda t: None if t is None else t.data_ptr())  # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernels().fvt_conv3d_s8(
        q.data_ptr(), wk.data_ptr(), mul.data_ptr(), add.data_ptr(), s.data_ptr(),
        y.data_ptr(), ptr(y2), ptr(res), ptr(residual and residual.inv_f),
        ptr(residual and residual.s), ptr(requant and requant.inv_f),
        ptr(requant and requant.s), ptr(amax and amax.out), ptr(amax and amax.inv_f), n, t, h,
        w, cp, *shape[1:4], kt, kh, kw, *strides,
        *(p[0] for p in pads), co, int(relu), _OUT[y.dtype], ld,
        _RES[residual and residual.kind], 0 if res is None else res.shape[-1], plan.bn,
        plan.stages, int(plan.staged), plan.grid, plan.smem_bytes, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_conv3d_s8 launch failed: CUDA error {rc}")
    launch_counts["conv3d_s8"] += 1
    if amax is not None:
        return y, amax.out
    if requant is None:
        return y
    return y, requant.s.reshape(()), y2


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


def residual_tail(z: torch.Tensor, residual: Residual, relu: bool = True,
                  out_f32: bool = False) -> torch.Tensor:
    """A block's tail after its last conv's f32 output ``z``: the residual
    added in f32 (the dequantized input as one fused multiply-add,
    ``addcmul``, as XLA fuses the JAX engine's), ReLU, bf16 (f32 with
    ``out_f32``): the int8 engine's unfused ops."""
    c = z.shape[-1]
    if residual.kind == "dequant":
        z = torch.addcmul(z, residual.t[..., :c].float(), residual.s / residual.inv_f)
    else:
        z = z + residual.t.float()
    if relu:
        z = torch.relu(z)
    return z if out_f32 else z.to(torch.bfloat16)


def conv3d_s8_plain(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool,
                    out_f32: bool, residual: Residual | None = None,
                    requant: Requant | None = None, amax: Amax | None = None):
    """The plain version of Q1: an exact integer conv (f64 ``F.conv3d``),
    then the epilogue form as the composition of the plain steps it fuses:
    ``requant_epilogue``, ``residual_tail``, ``quantize_s8_plain`` (its
    amax pass for ``amax``)."""
    _check_q1(q, wk, kernel_size, mul, add, s, strides, pads, out_f32, residual, requant, amax)
    acc = conv3d_s8_accumulate(q, wk, kernel_size, strides, pads)
    f32 = out_f32 and requant is None
    if residual is None:
        y = requant_epilogue(acc, mul, add, s, relu, f32)
    else:
        y = residual_tail(requant_epilogue(acc, mul, add, s, False, True), residual, relu, f32)
    if amax is not None:
        return y, _reduce_amax(y, amax.inv_f, amax.out)
    if requant is None:
        return y
    qn, sn = _quantize_plain(y, requant.inv_f, requant.s)
    return qn, sn, (y if requant.keep_bf16 else None)


def conv3d_s8(q, wk, kernel_size, mul, add, s, strides, pads, relu: bool = False,
              out_f32: bool = False, residual: Residual | None = None,
              requant: Requant | None = None, amax: Amax | None = None):
    """Q1 for a CUDA ``q``, its plain version for a CPU one, through the
    op of its output form (ops/library.py).

    Without ``requant`` it returns the output, bf16 (f32 with ``out_f32``);
    with it, ``(q_next, s_next, y)``: the output quantized for the next site
    (int8 at its padded width), that site's scale, and the bf16 output where
    ``requant.keep_bf16`` asks for it (else None). With ``amax`` (a bf16
    output) it returns ``(y, amax)``: the next site's dynamic amax reduced
    into ``amax.out``. With ``residual`` the conv's own ReLU is off and
    ``relu`` is the block's, after the add."""
    _check_form(out_f32, requant, amax)
    res = ((residual.kind, residual.t, residual.inv_f, residual.s) if residual is not None
           else ("", None, None, None))
    args = (q, wk, [int(k) for k in kernel_size], mul, add, s, [int(st) for st in strides],
            [int(p) for pair in pads for p in pair], relu)
    if amax is not None:
        out = amax.out if amax.out is not None else torch.zeros((), dtype=torch.float32,
                                                                 device=q.device)
        return torch.ops.fvt.conv3d_s8_amax.default(*args, *res, amax.inv_f, out), out
    if requant is None:
        return torch.ops.fvt.conv3d_s8.default(*args, out_f32, *res)
    nxt = (requant.inv_f, requant.s)
    if requant.keep_bf16:
        qn, y = torch.ops.fvt.conv3d_s8_requant_bf16.default(*args, *res, *nxt)
    else:
        qn, y = torch.ops.fvt.conv3d_s8_requant.default(*args, *res, *nxt), None
    return qn, requant.s.reshape(()), y


# ---------------------------------------------------------------------------
# Q2: the quantize pass
# ---------------------------------------------------------------------------


def _check_q2(y, inv_f):
    if y.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"y must be bf16 or f32, got {y.dtype}")
    if inv_f.dtype != torch.float32 or tuple(inv_f.shape) != (y.shape[-1],):
        raise ValueError(f"inv_f must be f32 ({y.shape[-1]},), got {inv_f.dtype} "
                         f"{tuple(inv_f.shape)}")


def quantize_s8_cuda(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None,
                     amax: torch.Tensor | None = None, slot=None):
    """Q2 on the card: y (..., C) bf16 or f32 -> (q (..., cp) int8 with
    channels C..cp-1 zero, s a 0-d f32). Static with ``s`` (a 0-d f32 on the
    device). Dynamic without: ``slot``, a (amax, scale) pair of 0-d f32 on
    the device (``ScaleSlots.take``; None: a new zeroed pair), takes the
    scale the quantize pass writes; with ``amax`` (a 0-d f32 reduced
    already, e.g. by a Q1 epilogue) the quantize pass alone, else the amax
    pass into ``slot``'s amax (which holds 0), then the quantize pass."""
    _check_q2(y, inv_f)
    dev = y.device
    y = y.contiguous()
    c = y.shape[-1]
    cp = padded_channels(c)
    rows = y.numel() // c
    q = torch.empty(y.shape[:-1] + (cp,), dtype=torch.int8, device=dev)
    if s is not None:
        _check_scalar("s", s, dev)
        s_out = s
        mode, args = _Q2_STATIC, (s.data_ptr(), None, None)
    else:
        slot = _fresh_slot(dev) if slot is None else slot
        for name, t in (("amax", amax), ("slot[0]", slot[0]), ("slot[1]", slot[1])):
            if t is not None:
                _check_scalar(name, t, dev)
        s_out = slot[1]
        mode = _Q2_DYNAMIC if amax is None else _Q2_GIVEN
        args = (None, (slot[0] if amax is None else amax).data_ptr(), s_out.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernels().fvt_quantize_s8(y.data_ptr(), int(y.dtype == torch.float32),
                                    inv_f.contiguous().data_ptr(), *args, q.data_ptr(), rows, c,
                                    cp, mode, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_quantize_s8 launch failed: CUDA error {rc}")
    launch_counts["quantize_s8"] += 1
    if mode == _Q2_DYNAMIC:
        launch_counts["quantize_s8_amax"] += 1
    return q, s_out.reshape(())


def _check_scalar(name, t, dev):
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != dev:
        raise ValueError(f"{name} must be one f32 value on {dev}")


def quantize_s8_plain(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None,
                      amax: torch.Tensor | None = None, slot=None):
    """The plain version of Q2, in the JAX engine's two orders: static
    ``round(f32(y) * (inv_f / s))``, dynamic ``xs = f32(y) * inv_f``, ``s =
    max(amax, 1e-12) * f32(1/127)`` (``INV_127``), ``round(xs / s)`` with
    ``amax`` the one given or ``max |xs|`` (reduced into ``slot``'s amax as
    the kernel's pass does); clipped to +-127 and the channels zero-padded to
    a multiple of 16. ``slot``'s scale takes the dynamic scale."""
    _check_q2(y, inv_f)
    return _quantize_plain(y, inv_f, s, amax, slot)


def _reduce_amax(y: torch.Tensor, inv_f: torch.Tensor, out: torch.Tensor | None):
    """Q2's amax pass on Q1's bf16 output: ``max |f32(y) * inv_f|``, into
    ``out`` (the larger of the two) where one is given."""
    a = (y.to(torch.float32) * inv_f).abs().amax()
    return a if out is None else out.copy_(torch.maximum(out, a))


def _quantize_plain(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None,
                    amax: torch.Tensor | None = None, slot=None):
    """Q2's arithmetic (``quantize_s8_plain`` without its checks), which Q1's
    plain version also runs for forms (b) and (c)."""
    if s is None:
        xs = y.to(torch.float32) * inv_f
        if amax is None:
            amax = xs.abs().amax()
            if slot is not None:
                amax = slot[0].copy_(torch.maximum(slot[0], amax))
        s = torch.clamp_min(amax.reshape(()), 1e-12) * INV_127
        if slot is not None:
            s = slot[1].copy_(s)
        t = xs / s
    else:
        s = s.reshape(())
        t = y.to(torch.float32) * (inv_f / s)
    q = torch.clamp(torch.round(t), -127, 127).to(torch.int8)
    c = y.shape[-1]
    return F.pad(q, (0, padded_channels(c) - c)).contiguous(), s


def quantize_s8(y: torch.Tensor, inv_f: torch.Tensor, s: torch.Tensor | None = None,
                amax: torch.Tensor | None = None, slot=None):
    """Q2 for a CUDA ``y``, its plain version for a CPU one, through the op
    of its mode (ops/library.py): -> (q, s), ``s`` the static scale given or
    ``slot``'s scale (None: a new zeroed slot) that the dynamic modes write."""
    if s is not None:
        return torch.ops.fvt.quantize_s8.default(y, inv_f, s), s.reshape(())
    slot = _fresh_slot(y.device) if slot is None else slot
    if amax is None:
        return torch.ops.fvt.quantize_s8_dynamic.default(y, inv_f, slot[0], slot[1]), slot[1]
    return torch.ops.fvt.quantize_s8_given.default(y, inv_f, amax, slot[1]), slot[1]
