"""The fused (2+1)D inference block: spatial conv + folded-BN affine + ReLU +
temporal conv in one hand-written Hopper kernel (K4, csrc/fused_block.cu).

The counterpart of ``fastvideotagging_tpu/ops/fused_block.py``, whose TPU
kernel ``_kernel`` / ``_fused_pallas`` K4 replaces. The mid tensor between
the two convs (B, T, H, W, M), the widest of the network, stays in the
kernel's shared memory: the folded BatchNorm (``fold_bn``) and ReLU are
applied to the spatial conv's f32 accumulator, rounded to bf16 into a ring of
the last k frames, and the temporal conv reads that ring. Inference only:
BN's running statistics are folded as constants (training needs batch
statistics over the whole mid tensor).

``fused_block_cuda`` takes bf16 contiguous CUDA tensors, launches K4 on the
current stream, raises if the launch fails, and adds one to
``conv2plus1d.launch_counts['fused_block']``. ``fused_block_plain`` is the
same arithmetic in plain PyTorch, in K4's order. ``conv2plus1d_fused`` routes
between them as the other kernels do: a CUDA tensor goes to the kernel, a
CPU tensor to the plain version, and nothing falls back.

Eligibility (``fused_supported``) is the kernel's shared-memory plan
(``fused_plan``), not the JAX package's VMEM tile search: its ``tile_h >=
k - 1`` term belongs to the TPU's halo scheme, which K4 does not have.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

# K4's tile plan, its one source: csrc/fused_block.cu is compiled with these
# as -D flags (NVCC_DEFINES) and takes each launch's shared-memory layout
# (ring width, bytes) from fused_block_cuda, which sizes it here.
_ROWS = (128, 64, 32)  # pixel rows per block, largest first (the kernel's instances)
_NT = 64  # mid / output channels per GEMM pass
_BK = 32  # contraction slice
_PAD = 8  # bf16 columns of padding per shared row (x and weight slices, ring)
_PAD_F32 = 4  # f32 columns of padding per accumulator row
NVCC_DEFINES = tuple(f"-DFVT_{n}={v}" for n, v in
                     (("NT", _NT), ("BK", _BK), ("PAD", _PAD), ("PAD_F32", _PAD_F32)))
_SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use (227 KB)
_SMS = 132  # streaming multiprocessors of an H100 SXM, for plans made off the card

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_block")
        lib.fvt_fused_block_bf16.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [ctypes.c_int] * 12
            + [ctypes.c_void_p])
        lib.fvt_fused_block_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BatchNorm running stats -> (scale, bias) affine, f32:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    bias = beta.float() - mean.float() * scale
    return scale, bias


def _ring_cols(m: int) -> int:
    """Mid channels a ring row holds: M rounded up to the contraction slice."""
    return -(-m // _BK) * _BK


def _smem_bytes(rows: int, k: int, m: int) -> int:
    """Shared memory of one K4 block, in the kernel's order: the per-row
    pixel coordinates, the ring of k mid frames in bf16, and the staging
    area (x and weight slices, or the f32 accumulator tile)."""
    coords = 2 * rows * 4
    ring = k * rows * (_ring_cols(m) + _PAD) * 2
    stage = max(rows * (_BK + _PAD) * 2 + _BK * (_NT + _PAD) * 2, rows * (_NT + _PAD_F32) * 4)
    return coords + ring + stage


def fused_plan(x_shape, k: int, m: int, co: int, sms: int = _SMS) -> tuple[int, int] | None:
    """K4's launch plan: (pixel rows per block, 64-wide Co tiles per block),
    or None when no block fits in shared memory.

    The largest tile that fits and still gives one block per SM (``sms`` of
    them); else the smallest that fits, with Co split over blocks until the
    card is full (each Co group recomputes mid for its pixels)."""
    b, _, h, w, _ = x_shape
    fits = [r for r in _ROWS if _smem_bytes(r, k, m) <= _SMEM_LIMIT]
    if not fits:
        return None
    blocks = {r: -(-h * w // r) * b for r in fits}
    rows = next((r for r in fits if blocks[r] >= sms), fits[-1])
    co_tiles = -(-co // _NT)
    groups = min(co_tiles, max(1, -(-sms // blocks[rows])))
    return rows, -(-co_tiles // groups)


def fused_supported(x_shape, k: int, m: int, co: int) -> bool:
    """True if conv2plus1d_fused can run for these shapes."""
    _, _, h, w, c = x_shape
    return (k % 2 == 1 and c >= ops.MIN_C and h >= k and w >= k
            and fused_plan(x_shape, k, m, co) is not None)


def fused_block_cuda(x: torch.Tensor, w_sp: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, w_tmp: torch.Tensor) -> torch.Tensor:
    """K4: x (B, T, H, W, C), w_sp (k, k, C, M), w_tmp (k, M, Co), all bf16
    contiguous on CUDA; scale, bias (M,) f32 contiguous on the same device
    -> (B, T, H, W, Co) bf16."""
    ops._check_kernel_tensors(x=x, w_sp=w_sp, w_tmp=w_tmp)
    if x.ndim != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got {tuple(x.shape)}")
    b, t, h, wd, c = x.shape
    k, m = w_sp.shape[0], w_sp.shape[-1]
    co = w_tmp.shape[-1]
    if tuple(w_sp.shape) != (k, k, c, m) or tuple(w_tmp.shape) != (k, m, co):
        raise ValueError(
            f"w_sp must be (k, k, C={c}, M) and w_tmp (k, M, Co), got "
            f"{tuple(w_sp.shape)} and {tuple(w_tmp.shape)}")
    for name, v in (("scale", scale), ("bias", bias)):
        if (v.dtype != torch.float32 or v.shape != (m,) or v.device != x.device
                or not v.is_contiguous()):
            raise ValueError(f"{name} must be ({m},) float32 contiguous on {x.device}")
    if k % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {k}")
    plan = fused_plan(x.shape, k, m, co,
                      torch.cuda.get_device_properties(x.device).multi_processor_count)
    if plan is None:
        raise ValueError(f"no K4 block fits shared memory at k={k}, M={m}")
    rows, per_group = plan
    y = torch.empty((b, t, h, wd, co), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernels().fvt_fused_block_bf16(
        x.data_ptr(), w_sp.data_ptr(), scale.data_ptr(), bias.data_ptr(), w_tmp.data_ptr(),
        y.data_ptr(), b, t, h, wd, c, m, co, k, rows, per_group, _ring_cols(m),
        _smem_bytes(rows, k, m), x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_fused_block_bf16 launch failed: CUDA error {rc}")
    ops.launch_counts["fused_block"] += 1
    return y


def fused_block_plain(x: torch.Tensor, w_sp: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, w_tmp: torch.Tensor) -> torch.Tensor:
    """The plain version of K4, in its order: k*k shifted matmuls into an f32
    accumulator -> ``* scale + bias`` -> ReLU -> cast to x's dtype -> k
    T-shifted matmuls of the zero-extended mid into an f32 accumulator ->
    cast (f64 throughout for an f64 input)."""
    k = w_sp.shape[0]
    b, t, h, wd, _ = x.shape
    p = k // 2
    acc_dtype = ops._acc_dtype(x)
    xp = F.pad(x, (0, 0, p, p, p, p))
    acc = torch.zeros((b, t, h, wd, w_sp.shape[-1]), dtype=acc_dtype, device=x.device)
    for dh in range(k):
        for dw in range(k):
            acc += xp[:, :, dh : dh + h, dw : dw + wd].to(acc_dtype) @ w_sp[dh, dw].to(acc_dtype)
    mid = torch.relu(acc * scale.to(acc_dtype) + bias.to(acc_dtype)).to(x.dtype)
    del acc
    mp = F.pad(mid, (0, 0, 0, 0, 0, 0, p, p))
    out = torch.zeros((b, t, h, wd, w_tmp.shape[-1]), dtype=acc_dtype, device=x.device)
    for dt in range(k):
        out += mp[:, dt : dt + t].to(acc_dtype) @ w_tmp[dt].to(acc_dtype)
    return out.to(x.dtype)


def conv2plus1d_fused(x: torch.Tensor, w_sp: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, w_tmp: torch.Tensor) -> torch.Tensor:
    """Fused inference (2+1)D block on NTHWC input.

    x: (B, T, H, W, C); w_sp: (k, k, C, M); scale/bias: (M,) folded BN;
    w_tmp: (k, M, Co). Returns (B, T, H, W, Co) in x's dtype."""
    k = w_sp.shape[0]
    m = w_sp.shape[-1]
    if not (w_tmp.shape[0] == k and fused_supported(x.shape, k, m, w_tmp.shape[-1])):
        raise ValueError(
            "fused block requires odd k, C >= MIN_C, H/W >= k, and a block that "
            "fits shared memory — check fused_supported() first")
    return ops._route(fused_block_cuda, fused_block_plain, x.contiguous(),
                      w_sp.to(x.dtype).contiguous(), scale.float().contiguous(),
                      bias.float().contiguous(), w_tmp.to(x.dtype).contiguous())
