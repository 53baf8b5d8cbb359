"""The factorized (2+1)D convolutions: hand-written Hopper kernels, their
plain PyTorch versions, their gradients, and the routing of the JAX
package's ``ops/conv2plus1d.py`` (``spatial_conv`` / ``temporal_conv``).

- ``spatial_conv_hopper_kernel`` (K1, csrc/spatial_conv.cu) replaces the
  TPU kernel ``_spatial_kernel`` / ``_spatial_pallas``: a stride-1
  1 x k x k conv.
- ``temporal_conv_hopper_kernel`` (K2, csrc/spatial_conv.cu) replaces
  ``_temporal_kernel`` / ``_temporal_pallas``: a stride-1 k x 1 x 1 conv.
  K1 and K2 are one implicit GEMM over a general row geometry; their tile
  plans have one rule, ``_taps_plan`` (``spatial_plan`` / ``temporal_plan``).
- ``temporal_dw_hopper_kernel`` (K3, csrc/temporal_dw.cu) replaces
  ``_temporal_dw_kernel`` / ``_temporal_dw``: the temporal conv's weight
  gradient. Its launch plan has one source, ``temporal_dw_plan``.

Each wrapper (``spatial_conv_cuda`` / ``temporal_conv_cuda`` /
``temporal_dw_cuda``) takes bf16 contiguous CUDA tensors, launches its
kernel on the current stream, raises if the launch fails, and adds one to
``launch_counts``. A CUDA tensor goes to the kernel and a CPU tensor to the
plain version (``*_plain``: the same arithmetic as k or k*k shifted matmuls
into an f32 accumulator); nothing falls back from the kernel to the plain
version.

``spatial_conv`` / ``temporal_conv`` are differentiable through two
``torch.autograd.Function``s, the counterparts of the JAX package's
``_spatial_op`` / ``_temporal_op``. Their forward calls K1 / K2 through
the ops ``fvt::spatial_conv`` / ``fvt::temporal_conv`` (ops/library.py),
which ``torch.export`` records; their backward calls the wrappers: dx is
the same forward kernel on the flipped, channel-transposed weights
(``spatial_conv_dx_cuda`` / ``temporal_conv_dx_cuda`` lay the weight out
for it straight from the forward weight); the temporal dw is K3; the
spatial dw is k*k tap-sliced matmuls (XLA's in the JAX package, the matmul
library's here). With a profiler's scopes on (ops/scopes.py), the backward
opens ``fvt/dx/<layer>`` and ``fvt/dw/<layer>`` around its launches, the
layer being the site that was open when the forward ran.

Convs the kernels do not take (strided stage entries, the 3-channel stem,
C < MIN_C) go to ``F.conv3d``, as the JAX package sends them to
``lax.conv_general_dilated``.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import types
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fastvideotagging_tpu_torch.ops import _build, scopes

# Kernel eligibility (the JAX package's MIN_C): narrower contractions stay
# with the library conv.
MIN_C = 32

# Kernel launches since the last reset, by kernel (``fused_block`` is K4 of
# ops/fused_block.py).
launch_counts = {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0,
                 "fused_block": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_lib = None
_dw_lib = None


# fvt_spatial_conv_bf16(x, w, wk, y, ws, n, h, wd, cp, cw, cow, k, dx, bn,
# stages, splits, smem_bytes, device, stream)
_K1_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 12
                + [ctypes.c_void_p])
# fvt_temporal_conv_bf16(x, w, wk, xp, y, ws, b, t, s, cx, cp, cw, cow, k, dx,
# bn, stages, splits, smem_bytes, device, stream)
_K2_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 13
                + [ctypes.c_void_p])


def _kernels() -> types.SimpleNamespace:
    """K1's and K2's entry points (csrc/spatial_conv.cu)."""
    global _lib
    if _lib is None:
        lib = _build.load("spatial_conv")
        k1, k2 = lib.fvt_spatial_conv_bf16, lib.fvt_temporal_conv_bf16
        k1.argtypes, k2.argtypes = _K1_ARGTYPES, _K2_ARGTYPES
        k1.restype = k2.restype = ctypes.c_int
        _lib = types.SimpleNamespace(fvt_spatial_conv_bf16=k1, fvt_temporal_conv_bf16=k2)
    return _lib


# fvt_temporal_dw_bf16(x, g, xp, gp, dw, ws, b, t, s, c, co, k, bn, rows, ahead,
# chunks, steps_per_chunk, smem_bytes, device, stream)
_K3_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 12
                + [ctypes.c_void_p])


def _dw_kernels() -> ctypes.CDLL:
    """K3's entry point (csrc/temporal_dw.cu)."""
    global _dw_lib
    if _dw_lib is None:
        lib = _build.load("temporal_dw")
        lib.fvt_temporal_dw_bf16.argtypes = _K3_ARGTYPES
        lib.fvt_temporal_dw_bf16.restype = ctypes.c_int
        _dw_lib = lib
    return _dw_lib


def _check_kernel_tensors(**tensors: torch.Tensor) -> None:
    first = next(iter(tensors.values()))
    for name, t in tensors.items():
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != first.device:
            raise ValueError(f"tensors on {first.device} and {t.device}")


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor, x_dims: int,
                       w_shape: tuple) -> None:
    _check_kernel_tensors(x=x, w=w)
    if x.ndim != x_dims:
        raise ValueError(f"x must have {x_dims} dims, got {tuple(x.shape)}")
    if tuple(w.shape) != w_shape:
        raise ValueError(f"w must be {w_shape}, got {tuple(w.shape)}")
    if w_shape[0] % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {w_shape[0]}")


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' accumulator: f32, as in the kernels (f64 for an
    f64 input, which the kernels do not take)."""
    return torch.promote_types(x.dtype, torch.float32)


def _route(kernel, plain, x: torch.Tensor, *args):
    """The kernel for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return kernel(x, *args)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return plain(x, *args)


# ---------------------------------------------------------------------------
# Spatial 1 x k x k conv
# ---------------------------------------------------------------------------


# K1's and K2's tile plan (csrc/spatial_conv.cu), its one source: the ring
# depth is compiled in (NVCC_DEFINES, through _build), and each launch
# passes the column tile, the kappa split and the shared-memory bytes that
# _taps_plan sized.
_K1_BM = 128  # output rows per block
_K1_BK = 64  # contraction slice (128 bytes of bf16 a row)
_K1_STAGES = 3  # slices in the cp.async ring (two blocks fit an SM)
_K1_BNS = (144, 128, 64)  # column tiles the kernel is built for, widest first
_K1_ALIGN = 1024  # slack to align the ring to the 128-byte swizzle's period
_K1_MIN_SPLIT_SLICES = 8  # a kappa chunk of a split contraction is at least this deep
SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use (227 KB)
SMEM_PER_SM = 233_472  # bytes of shared memory of one H100 SM for blocks (228 KB)
SMS = 132  # streaming multiprocessors of an H100 SXM, for plans made off the card


def _ceil8(n: int) -> int:
    return -(-n // 8) * 8


class TapsPlan(NamedTuple):
    bn: int  # output channels per block
    stages: int  # slices in the ring
    smem_bytes: int  # dynamic shared memory of one block
    row_tiles: int  # blocks along the output rows (128 each)
    col_tiles: int  # blocks along the output channels (bn each)
    splits: int  # kappa chunks, each a block writing f32 partial sums (1: none)
    cp: int  # contraction width of a tap: the input channels rounded up to 8

    @property
    def grid(self) -> int:
        return self.row_tiles * self.col_tiles * self.splits

    @property
    def blocks_per_sm(self) -> int:  # as the shared memory and the launch bounds allow
        return min(3 if self.bn <= 64 else 2, SMEM_PER_SM // (self.smem_bytes + 1024))


def _taps_plan(rows: int, cp: int, co: int, taps: int, sms: int) -> TapsPlan:
    """The launch plan of K1 or K2: ``rows`` output rows, a contraction of
    ``taps`` taps of ``cp`` channels, ``co`` output channels.

    The column tile covers Co where it fits (the narrowest that does) and
    otherwise divides it (the widest that does), so that the A rows are
    gathered as few times as possible: Co = 144 -> 144 x 1, 288 / 576 /
    1152 -> 144 x 2 / 4 / 8, 64 / 128 -> one tile, 256 / 512 -> 128 x 2 /
    x 4. Tiles stop at 144 so that two blocks share an SM (a 192-wide tile
    with its ring fits one). A Co that no tile divides is covered by the
    least wasteful one.

    Where those tiles are fewer than the ``sms`` the card has (at 8 clips:
    K1's stage 4, 7 row tiles, and the dx of stage 3, 49 x 2 tiles; K2's
    stages 3-4), the contraction is split into chunks of at least 8 slices,
    enough to fill the card: each block writes f32 partial sums, and a
    second kernel adds them in chunk order (no atomics: two launches are
    bitwise equal)."""
    row_tiles = -(-rows // _K1_BM)
    covering = [bn for bn in _K1_BNS if bn >= co]
    dividing = [bn for bn in _K1_BNS if co % bn == 0]
    if covering:
        bn = covering[-1]
    elif dividing:
        bn = dividing[0]
    else:
        bn = min(_K1_BNS, key=lambda b: (-(-co // b) * b - co, -b))
    col_tiles = -(-co // bn)
    slices = -(-taps * cp // _K1_BK)
    tiles = row_tiles * col_tiles
    splits = max(1, min(-(-sms // tiles), slices // _K1_MIN_SPLIT_SLICES))
    smem = _K1_STAGES * (_K1_BM + bn) * _K1_BK * 2 + _K1_ALIGN
    return TapsPlan(bn, _K1_STAGES, smem, row_tiles, col_tiles, splits, cp)


@functools.lru_cache(maxsize=256)
def spatial_plan(x_shape, co: int, k: int, sms: int = SMS) -> TapsPlan:
    """K1's launch plan for x (N, H, W, C) -> Co channels (``_taps_plan``):
    k*k taps of C rounded up to 8."""
    n, h, w, c = x_shape
    return _taps_plan(n * h * w, _ceil8(c), co, k * k, sms)


@functools.lru_cache(maxsize=256)
def temporal_plan(x_shape, co: int, k: int, sms: int = SMS) -> TapsPlan:
    """K2's launch plan for x (B, T, S, C) -> Co channels (``_taps_plan``):
    k taps of C rounded up to 8."""
    b, t, s, c = x_shape
    return _taps_plan(b * t * s, _ceil8(c), co, k, sms)


def _pad_channels(x: torch.Tensor) -> torch.Tensor:
    """x with its channels zero-padded to a multiple of 8, as K1 takes its
    contraction (a 16-byte chunk of A then lies in one tap)."""
    pad = -x.shape[-1] % 8
    return F.pad(x, (0, pad)) if pad else x


def temporal_weight_layout_plain(w: torch.Tensor, dx: bool) -> torch.Tensor:
    """The plain version of K1's and K2's weight layout (csrc/spatial_conv.cu,
    ``weight_layout``): w (taps, C, Co) K-major, (out channel, tap, in
    channel) contiguous, the in channels zero-padded to a multiple of 8.

    Forward: (Co, taps, C). dx: (C, taps, Co) in the forward's tap order,
    one copy of w with no flipped intermediate; the kernel reads the taps in
    reverse."""
    return _pad_channels(w.permute(1, 0, 2) if dx else w.permute(2, 0, 1)).contiguous()


def spatial_weight_layout_plain(w: torch.Tensor, dx: bool) -> torch.Tensor:
    """K1's weight layout: w (k, k, C, Co) as k*k taps
    (``temporal_weight_layout_plain``)."""
    k, _, c, co = w.shape
    return temporal_weight_layout_plain(w.reshape(k * k, c, co), dx)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _k1_launch(x: torch.Tensor, w: torch.Tensor, dx: bool):
    """K1 on x with the forward weight w (k, k, C, Co): the conv (x has C
    channels) or its dx (x has Co). Returns y and the K-major weight the
    kernel laid out (its scratch)."""
    k, _, cw, cow = w.shape
    c_out = cw if dx else cow
    x = _pad_channels(x)
    # a view into a larger buffer: the kernels read 16 bytes at a time
    x = x.clone() if x.data_ptr() % 16 else x
    w = w.clone() if w.data_ptr() % 16 else w
    n, h, wd, cp = x.shape
    plan = spatial_plan(tuple(x.shape), c_out, k, _sm_count(x.device))
    wk = torch.empty((c_out, k * k, cp), dtype=x.dtype, device=x.device)
    y = torch.empty((n, h, wd, c_out), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.splits, n * h * wd, c_out), dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernels().fvt_spatial_conv_bf16(
        x.data_ptr(), w.data_ptr(), wk.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, n, h, wd, cp, cw, cow, k, int(dx),
        plan.bn, plan.stages, plan.splits, plan.smem_bytes, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_spatial_conv_bf16 launch failed: CUDA error {rc}")
    launch_counts["spatial_conv"] += 1
    return y, wk


def spatial_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1: x (N, H, W, C), w (k, k, C, Co), both bf16 contiguous on CUDA ->
    (N, H, W, Co) bf16. Stride 1, zero padding k//2."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    _check_kernel_args(x, w, 4, (k, k, c, w.shape[-1]))
    return _k1_launch(x, w, dx=False)[0]


def spatial_conv_dx_cuda(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of K1's forward with weight w (k, k, C, Co), on K1: g (N, H, W,
    Co), w, both bf16 contiguous on CUDA -> (N, H, W, C) bf16. The same
    conv as ``spatial_conv_cuda(g, w.flip(0, 1).transpose(2, 3))``."""
    k = w.shape[0]
    _check_kernel_args(g, w, 4, (k, k, w.shape[2], g.shape[-1]))
    return _k1_launch(g, w, dx=True)[0]


def spatial_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: k*k shifted (N*H*W, C) @ (C, Co) matmuls
    into an f32 accumulator, cast to x's dtype."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=_acc_dtype(x), device=x.device)
    for dh in range(k):
        for dw in range(k):
            acc += xp[:, dh : dh + h, dw : dw + wd, :].to(acc.dtype) @ w[dh, dw].to(acc.dtype)
    return acc.to(x.dtype)


def spatial_conv_dx_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of ``spatial_conv_dx_cuda``: the forward's plain
    version on the flipped, channel-transposed weights."""
    return spatial_conv_plain(g, w.flip(0, 1).transpose(2, 3))


@contextlib.contextmanager
def _f32_accumulation():
    """Matmuls inside sum in f32 all the way: no bf16 split-K reduction,
    no TF32 (the contractions here run over up to 1.6 M rows)."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32)
    mm.allow_bf16_reduced_precision_reduction = False
    mm.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_bf16_reduced_precision_reduction, mm.allow_tf32 = prev


def spatial_dw(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The spatial conv's weight gradient,
    dw[dh,dw,c,co] = sum_{n,h,w} x_pad[n,h+dh,w+dw,c] g[n,h,w,co], as k*k
    tap-sliced (rows, C)^T @ (rows, Co) matmuls accumulated in f32 (the JAX
    package's ``_spatial_dw`` leaves the same products to XLA). x (N,H,W,C),
    g (N,H,W,Co) -> (k, k, C, Co) in x's dtype."""
    n, h, wd, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
    taps = []
    with _f32_accumulation():
        for dh in range(k):
            for dw in range(k):
                patch = xp[:, dh : dh + h, dw : dw + wd, :].reshape(-1, c)
                taps.append(patch.T @ g2)
    return torch.stack(taps).reshape(k, k, c, -1)


class _SpatialOp(torch.autograd.Function):
    """K1 with its gradients (the JAX package's ``_spatial_op``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.site = scopes.current_path()  # the layer, for a profiler's scopes
        return torch.ops.fvt.spatial_conv.default(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx: correlate g with spatially flipped, channel-transposed weights.
            with scopes.site("dx", ctx.site):
                dx = _route(spatial_conv_dx_cuda, spatial_conv_dx_plain, g, w)
        if ctx.needs_input_grad[1]:
            with scopes.site("dw", ctx.site):
                dw = spatial_dw(x, g, w.shape[0]).to(w.dtype)
        return dx, dw


def spatial_eligible(x_shape, k: int, stride: int) -> bool:
    """Whether the 1 x k x k conv goes to K1. The JAX routing also asks
    for an H tile of at least k-1 rows, a limit of its VMEM halo scheme
    that this kernel does not have (it holds at every path shape)."""
    _, _, h, w, c = x_shape
    return stride == 1 and c >= MIN_C and h >= k and w >= k and k % 2 == 1


def spatial_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """1 x k x k conv on NTHWC input. x: (B, T, H, W, C); w: (k, k, C, Co)."""
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    if spatial_eligible(x.shape, k, stride):
        x4 = x.reshape(b * t, h, wd, c).contiguous()
        y = _SpatialOp.apply(x4, w.contiguous())
        return y.reshape(b, t, h, wd, -1)
    p = k // 2
    return conv3d_nthwc(x, w[None], (1, stride, stride), (0, p, p))


# ---------------------------------------------------------------------------
# Temporal k x 1 x 1 conv
# ---------------------------------------------------------------------------


def _k2_launch(x: torch.Tensor, w: torch.Tensor, dx: bool):
    """K2 on x (B, T, S, ·) with the forward weight w (k, C, Co): the conv
    (x has C channels, or C zero-padded to a multiple of 8) or its dx (x
    has Co). Channels that are not a multiple of 8 (the stem's 45) go
    through the kernel's pad pass. Returns y and the K-major weight the
    kernel laid out.

    The kernel's scratch is one allocation (a host cost per call that the
    small sites feel): the K-major weight, the padded x where there is one,
    and the f32 partial sums of a split plan, each 16-byte aligned."""
    k, cw, cow = w.shape
    c_out = cw if dx else cow
    # a view into a larger buffer: the kernel reads 16 bytes at a time
    x = x.clone() if x.data_ptr() % 16 else x
    w = w.clone() if w.data_ptr() % 16 else w
    b, t, s, cx = x.shape
    rows = b * t * s
    plan = temporal_plan(tuple(x.shape), c_out, k, _sm_count(x.device))
    n_wk = c_out * k * plan.cp  # bf16 values; cp % 8 == 0, so each part ends 16-byte aligned
    n_xp = rows * plan.cp if cx % 8 else 0
    n_ws = 2 * plan.splits * rows * c_out if plan.splits > 1 else 0  # f32 as bf16 pairs
    scratch = torch.empty(n_wk + n_xp + n_ws, dtype=x.dtype, device=x.device)
    y = torch.empty((b, t, s, c_out), dtype=x.dtype, device=x.device)
    base = scratch.data_ptr()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernels().fvt_temporal_conv_bf16(
        x.data_ptr(), w.data_ptr(), base, base + 2 * n_wk if n_xp else None, y.data_ptr(),
        base + 2 * (n_wk + n_xp) if n_ws else None, b, t, s, cx, plan.cp, cw, cow, k,
        int(dx), plan.bn, plan.stages, plan.splits, plan.smem_bytes, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_temporal_conv_bf16 launch failed: CUDA error {rc}")
    launch_counts["temporal_conv"] += 1
    return y, scratch[:n_wk].view(c_out, k, plan.cp)


def temporal_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: x (B, T, S, C), w (k, C, Co), both bf16 contiguous on CUDA ->
    (B, T, S, Co) bf16. Stride 1, zero rows beyond the T edges."""
    k = w.shape[0]
    _check_kernel_args(x, w, 4, (k, x.shape[-1], w.shape[-1]))
    return _k2_launch(x, w, dx=False)[0]


def temporal_conv_dx_cuda(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx of K2's forward with weight w (k, C, Co), on K2: g (B, T, S, Co),
    w, both bf16 contiguous on CUDA -> (B, T, S, C) bf16. The same conv as
    ``temporal_conv_cuda(g, w.flip(0).transpose(1, 2))``, with no flipped
    copy of w."""
    k = w.shape[0]
    _check_kernel_args(g, w, 4, (k, w.shape[1], g.shape[-1]))
    return _k2_launch(g, w, dx=True)[0]


def temporal_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of K2: k shifted (B*T*S, C) @ (C, Co) matmuls into
    an f32 accumulator, cast to x's dtype."""
    k = w.shape[0]
    b, t, s, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    acc = torch.zeros((b, t, s, w.shape[-1]), dtype=_acc_dtype(x), device=x.device)
    for dt in range(k):
        acc += xp[:, dt : dt + t].to(acc.dtype) @ w[dt].to(acc.dtype)
    return acc.to(x.dtype)


def temporal_conv_dx_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of ``temporal_conv_dx_cuda``: the forward's plain
    version on the flipped, channel-transposed weights."""
    return temporal_conv_plain(g, w.flip(0).transpose(1, 2))


# K3's launch plan (csrc/temporal_dw.cu), its one source: the slab depth
# and the loads in flight are compiled in (NVCC_DEFINES, through _build),
# and each launch passes the input tile, the chunks and the shared-memory
# bytes that temporal_dw_plan sized.
_K3_ROWS = 64  # (b, s) rows of a slab: the contraction of one step
_K3_AHEAD = 3  # steps of loads in flight
_K3_TAPS = 3  # taps of a block, one warpgroup (128 threads) each
_K3_BM = 64  # output channels of a block (wgmma's M)
_K3_BNS = (144, 48)  # input-channel tiles (wgmma's N) the kernel is built for
_K3_ST_LD = _K3_BM + 4  # f32 a row of the epilogue's staging tile
_K3_MIN_STEPS = 8  # a chunk walks at least this many slabs
NVCC_DEFINES = (f"-DFVT_K1_STAGES={_K1_STAGES}", f"-DFVT_K3_ROWS={_K3_ROWS}",
                f"-DFVT_K3_AHEAD={_K3_AHEAD}")


class TemporalDwPlan(NamedTuple):
    bn: int  # input channels of a block (wgmma's N; 64 output channels are its M)
    c_tiles: int  # blocks along the input channels (rounded up to 8)
    co_tiles: int  # blocks along the output channels (64 each)
    tap_groups: int  # blocks along the taps (3 each)
    tile_s: int  # (b, s) rows of a slab, taken in order over b * S + s
    columns: int  # slabs along the (b, s) rows: ceil(B * S / tile_s)
    steps: int  # slabs of the contraction, columns x T (t fastest)
    chunks: int  # runs of steps, each a block writing f32 partial sums (1: none)
    steps_per_chunk: int
    ahead: int  # steps of loads in flight
    smem_bytes: int  # dynamic shared memory of one block

    @property
    def tiles(self) -> int:
        return self.tap_groups * self.co_tiles * self.c_tiles

    @property
    def grid(self) -> int:
        return self.tiles * self.chunks

    @property
    def x_slots(self) -> int:  # x slabs in the ring: a step's taps and the loads ahead
        return self.ahead + _K3_TAPS

    @property
    def g_slots(self) -> int:
        return self.ahead + 1

    @property
    def acc_registers(self) -> int:  # f32 accumulators a thread holds (one tap's tile)
        return self.bn // 2

    @property
    def x_reads(self) -> int:  # times each x row is read: once per output and tap tile
        return self.co_tiles * self.tap_groups

    @property
    def g_reads(self) -> int:  # times each g row is read: once per input and tap tile
        return self.c_tiles * self.tap_groups


def _k3_smem(bn: int) -> int:
    ring = ((_K3_AHEAD + _K3_TAPS) * -(-bn // 64) + _K3_AHEAD + 1) * _K3_ROWS * 128
    staging = _K3_TAPS * bn * _K3_ST_LD * 4
    return max(ring, staging) + _K1_ALIGN


@functools.lru_cache(maxsize=256)
def temporal_dw_plan(x_shape, co: int, k: int, sms: int = SMS) -> TemporalDwPlan:
    """K3's launch plan for x (B, T, S, C) and g (B, T, S, Co), k taps.

    A block holds every tap of one output tile (three taps a block, one
    warpgroup each, so a k > 3 conv takes ceil(k / 3) tap groups): 64
    output channels by an input tile that covers C where it fits (the
    narrowest that does) and otherwise divides it (the widest that does):
    C = 45 -> 48 (padded), 144 -> 144, 288 / 576 / 1152 -> 144 x 2 / 4 / 8.
    The register file bounds the tile: 3 x 64 x 144 f32 take 72 registers a
    thread. The contraction is a stream of slabs, tile_s (b, s) rows at one
    t, t fastest; where the tiles cannot fill the card (stage 1 has one)
    the stream is cut into chunks for about ``sms`` blocks (one per SM),
    each of at least 8 slabs. Each chunk writes f32 partial sums, and a
    second kernel adds them in chunk order (no atomics: two launches are
    bitwise equal)."""
    b, t, s, c = x_shape
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {k}")
    cp = _ceil8(c)
    covering = [bn for bn in _K3_BNS if bn >= cp]
    dividing = [bn for bn in _K3_BNS if cp % bn == 0]
    if covering:
        bn = covering[-1]
    elif dividing:
        bn = dividing[0]
    else:
        bn = min(_K3_BNS, key=lambda n: (-(-cp // n) * n - cp, -n))
    c_tiles, co_tiles, tap_groups = -(-cp // bn), -(-_ceil8(co) // _K3_BM), -(-k // _K3_TAPS)
    columns = -(-b * s // _K3_ROWS)
    steps = columns * t
    tiles = c_tiles * co_tiles * tap_groups
    chunks = max(1, min(round(sms / tiles), steps // _K3_MIN_STEPS))
    per_chunk = max(1, -(-steps // chunks))
    return TemporalDwPlan(bn, c_tiles, co_tiles, tap_groups, _K3_ROWS, columns, steps,
                          -(-steps // per_chunk), per_chunk, _K3_AHEAD, _k3_smem(bn))


def temporal_dw_cuda(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """K3: x (B, T, S, C), g (B, T, S, Co), both bf16 contiguous on CUDA ->
    dw (k, C, Co) f32, dw[dt] = sum over rows of x[t+dt-k//2]^T g[t].
    Deterministic: partial sums per chunk, added in chunk order. A tensor
    whose channels are not a multiple of 8, or that is not 16-byte aligned,
    is first copied zero-padded by the kernel's pad pass into a scratch
    tensor allocated here (the stem's C = 45)."""
    _check_kernel_tensors(x=x, g=g)
    if x.ndim != 4 or g.ndim != 4 or g.shape[:3] != x.shape[:3]:
        raise ValueError(
            f"x (B,T,S,C) and g (B,T,S,Co) must share B, T, S; got "
            f"{tuple(x.shape)} and {tuple(g.shape)}")
    if k <= 0 or k % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {k}")
    b, t, s, c = x.shape
    co = g.shape[-1]
    plan = temporal_dw_plan(x.shape, co, k, _sm_count(x.device))

    def scratch(a: torch.Tensor):
        n = a.shape[-1]
        if n % 8 == 0 and a.data_ptr() % 16 == 0:
            return None
        return torch.empty((b * t * s, _ceil8(n)), dtype=a.dtype, device=a.device)

    xp, gp = scratch(x), scratch(g)
    dw = torch.empty((k, c, co), dtype=torch.float32, device=x.device)
    ws = (torch.empty((plan.chunks, k, c, co), dtype=torch.float32, device=x.device)
          if plan.chunks > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _dw_kernels().fvt_temporal_dw_bf16(
        x.data_ptr(), g.data_ptr(), *(a.data_ptr() if a is not None else None
                                      for a in (xp, gp, dw, ws)),
        b, t, s, c, co, k, plan.bn, plan.tile_s, plan.ahead, plan.chunks,
        plan.steps_per_chunk, plan.smem_bytes, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_temporal_dw_bf16 launch failed: CUDA error {rc}")
    launch_counts["temporal_dw"] += 1
    return dw


def temporal_dw_plain(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """The plain version of K3: k shifted (rows, C)^T @ (rows, Co) products
    in f32 over the rows where both x[t+dt-p] and g[t] exist -> (k, C, Co)
    f32."""
    t, c = x.shape[1], x.shape[-1]
    p = k // 2
    acc = _acc_dtype(x)
    taps = []
    with _f32_accumulation():
        for dt in range(k):
            off = dt - p
            rows = t - abs(off)
            if rows <= 0:
                taps.append(torch.zeros((c, g.shape[-1]), dtype=acc, device=x.device))
                continue
            xt = x[:, max(0, off) : max(0, off) + rows].reshape(-1, c).to(acc)
            gt = g[:, max(0, -off) : max(0, -off) + rows].reshape(-1, g.shape[-1]).to(acc)
            taps.append(xt.T @ gt)
    return torch.stack(taps)


class _TemporalOp(torch.autograd.Function):
    """K2 with its gradients (the JAX package's ``_temporal_op``)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        ctx.site = scopes.current_path()
        return torch.ops.fvt.temporal_conv.default(x, w)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # dx: correlate g with flipped, channel-transposed weights.
            with scopes.site("dx", ctx.site):
                dx = _route(temporal_conv_dx_cuda, temporal_conv_dx_plain, g, w)
        if ctx.needs_input_grad[1]:
            with scopes.site("dw", ctx.site):
                dw = _route(temporal_dw_cuda, temporal_dw_plain, x, g, w.shape[0]).to(w.dtype)
        return dx, dw


def temporal_eligible(x_shape, k: int, stride: int) -> bool:
    """Whether the k x 1 x 1 conv goes to K2 (the JAX routing)."""
    _, t, _, _, c = x_shape
    return stride == 1 and c >= MIN_C and t >= 2 and k % 2 == 1


def temporal_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """k x 1 x 1 conv on NTHWC input. x: (B, T, H, W, C); w: (k, C, Co)."""
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    if temporal_eligible(x.shape, k, stride):
        x4 = x.reshape(b, t, h * wd, c).contiguous()
        y = _TemporalOp.apply(x4, w.contiguous())
        return y.reshape(b, t, h, wd, -1)
    p = k // 2
    return conv3d_nthwc(x, w[:, None, None], (stride, 1, 1), (p, 0, 0))


# ---------------------------------------------------------------------------
# Library conv (the 'torch' kernels setting and the ineligible convs)
# ---------------------------------------------------------------------------


def conv3d_nthwc(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """``F.conv3d`` on NTHWC input with a (kt, kh, kw, Cin, Cout) kernel.

    The NTHWC tensor is passed as a channels-last-3d NCDHW view (no copy);
    the result comes back NTHWC and contiguous."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()
