"""The fused (2+1)D inference block: spatial conv + folded-BN affine + ReLU +
temporal conv in one hand-written Hopper kernel (K4, csrc/fused_block.cu).

The counterpart of ``fastvideotagging_tpu/ops/fused_block.py``, whose TPU
kernel ``_kernel`` / ``_fused_pallas`` K4 replaces. The mid tensor between
the two convs (B, T, H, W, M), the widest of the network, stays in the
kernel's shared memory: the folded BatchNorm (``fold_bn``) and ReLU are
applied to the spatial conv's f32 accumulator, rounded to bf16 into a ring of
the last k frames, and the temporal conv reads that ring. A block owns a
tile of the flattened B*H*W rows and one group of mid channels
(``fused_plan``); with several groups, each writes an f32 partial of y that
a second kernel adds in group order. Inference only: BN's running
statistics are folded as constants (training needs batch statistics over
the whole mid tensor).

``fused_block_cuda`` takes bf16 contiguous CUDA tensors, launches K4 (the
weight layouts, the fused kernel and, with several groups, the reduce) on
the current stream, raises if a launch fails, and adds one to
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
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

# K4's tile plan, its one source: csrc/fused_block.cu is compiled with the
# ring's depth as a -D flag (NVCC_DEFINES, through _build), and each launch
# passes the rows, group width, Co tile, depth (which the kernel checks) and
# shared-memory bytes that fused_plan chose.
_K4_STAGES = 3  # slices in the cp.async ring (deeper rings were no faster on the card)
_K4_BK = 64  # contraction slice (128 bytes of bf16 a row)
_K4_BMS = (128, 64)  # rows of the flattened B*H*W plane per block (a warpgroup per 64)
_K4_MGS = (144, 64)  # mid channels of a group: the spatial GEMM's N
_K4_CTS = (64, 128, 256)  # output channels of a temporal pass
_K4_ALIGN = 1024  # slack to align the slices to the 128-byte swizzle's period
_SM_SMEM = 233_472  # shared memory of one SM; each resident block also reserves 1 KB
NVCC_DEFINES = (f"-DFVT_K4_STAGES={_K4_STAGES}",)

# fvt_fused_block_bf16(x, w_sp, scale, bias, w_tmp, wsp_k, wt_k, y, ws, b, t, h, w,
# cp, c, m, co, k, bm, mg, groups, ct, stages, smem_bytes, device, stream)
_K4_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_longlong] + [ctypes.c_int] * 15
                + [ctypes.c_void_p])

_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("fused_block")
        lib.fvt_fused_block_bf16.argtypes = _K4_ARGTYPES
        lib.fvt_fused_block_bf16.restype = ctypes.c_int
        _lib = lib
    return _lib


def fold_bn(gamma, beta, mean, var, eps: float = 1e-5):
    """BatchNorm running stats -> (scale, bias) affine, f32:
    ``scale = gamma * rsqrt(var + eps)``, ``bias = beta - mean * scale``."""
    scale = gamma.float() * torch.rsqrt(var.float() + eps)
    bias = beta.float() - mean.float() * scale
    return scale, bias


class FusedPlan(NamedTuple):
    bm: int  # rows of the flattened B*H*W plane per block
    mg: int  # mid channels of a group (the spatial GEMM's N)
    groups: int  # ceil(M / mg) groups; > 1: f32 partials of y, added in group order
    ct: int  # output channels of a temporal pass (its accumulators: ct / 2 f32 a thread)
    co_passes: int  # temporal passes over the ring per frame, ceil(Co / ct)
    row_tiles: int  # ceil(B*H*W / bm)
    stages: int  # slices in the cp.async ring
    ring_bytes: int  # k mid frames of bm x mg bf16
    smem_bytes: int  # dynamic shared memory of one block
    blocks_per_sm: int  # resident at once, by shared memory and registers
    waves: int  # ceil(grid / (SMs x blocks_per_sm))

    @property
    def grid(self) -> int:
        return self.row_tiles * self.groups

    @property
    def threads(self) -> int:  # a warpgroup per 64 rows
        return 2 * self.bm

    @property
    def acc_registers(self) -> int:
        """f32 accumulators a thread holds: the spatial (mg / 2) and the
        temporal (ct / 2) ones are never live together."""
        return max(self.mg, self.ct) // 2


def _k4_stage(bm: int, mg: int, ct: int) -> int:
    """Bytes of one slice of the cp.async ring: an x and a Wsp slice, or as
    many 64-channel atoms of a Wtmp slice as fit in that room."""
    return max((bm + mg) * _K4_BK * 2, ct * _K4_BK * 2)


def _k4_smem(bm: int, mg: int, ct: int, k: int, stages: int) -> tuple[int, int]:
    """(ring bytes, shared bytes) of one K4 block, in the kernel's order:
    the slices, the ring of k mid frames, the group's scale and bias."""
    ring = k * bm * mg * 2
    return ring, stages * _k4_stage(bm, mg, ct) + ring + 2 * mg * 4 + _K4_ALIGN


def _make_plan(x_shape, k: int, m: int, co: int, sms: int, bm: int, mg: int,
               ct: int) -> FusedPlan | None:
    """The plan of one tiling, or None if it does not fit."""
    b, _, h, w, _ = x_shape
    ring, smem = _k4_smem(bm, mg, ct, k, _K4_STAGES)
    if smem > ops.SMEM_LIMIT:
        return None
    row_tiles, groups = -(-b * h * w // bm), -(-m // mg)
    # registers: __launch_bounds__ lets two 64-row blocks share an SM, one 128-row block
    per_sm = min(_SM_SMEM // (smem + 1024), 2 if bm == 64 else 1)
    waves = -(-row_tiles * groups // (sms * per_sm))
    return FusedPlan(bm, mg, groups, ct, -(-co // ct), row_tiles, _K4_STAGES, ring, smem,
                     per_sm, waves)


def _ring_steps(plan: FusedPlan, x_shape, k: int) -> tuple[int, int]:
    """(spatial, temporal) slices a block's ring walks: T frames of
    ceil(k*k*Cp / 64) spatial slices, and per output frame and Co pass its
    taps inside [0, T) times mg channels, in slices of as many 64-channel
    Wtmp atoms as a stage holds."""
    _, t, _, _, c = x_shape
    tk = _k4_stage(plan.bm, plan.mg, plan.ct) // (plan.ct * _K4_BK * 2) * _K4_BK
    p = k // 2
    temporal = sum(-(-(min(k - 1, t - 1 - to + p) - max(0, p - to) + 1) * plan.mg // tk)
                   for to in range(t))
    return t * -(-k * k * ops._ceil8(c) // _K4_BK), temporal * plan.co_passes


# The cost model's constants, fitted on an NVIDIA H100 80GB HBM3 (700 W
# limit) to a sweep of every tiling at r2plus1d_18's four sites
# (chip_smoke.py phase 3c prints the alternatives): a ring step costs a
# fixed time (its barrier, waits and address arithmetic) plus its bytes at
# the rate one SM draws from L2, and the blocks that share an SM share that
# rate.
_STEP_S = 0.2e-6
_SM_L2_BYTES_S = 26e9
_HBM_BYTES_S = 3.0e12


def _plan_cost(plan: FusedPlan, x_shape, k: int, co: int, sms: int) -> float:
    """Seconds the plan should take on an H100: the busiest SM's ring steps
    (its blocks one after another), plus the f32 partials written and read
    once where there are several groups."""
    b, t, h, w, _ = x_shape
    spatial, temporal = _ring_steps(plan, x_shape, k)
    stage = _k4_stage(plan.bm, plan.mg, plan.ct)
    tm_bytes = stage // (plan.ct * _K4_BK * 2) * plan.ct * _K4_BK * 2
    block = (spatial * (_STEP_S + (plan.bm + plan.mg) * _K4_BK * 2 / _SM_L2_BYTES_S)
             + temporal * (_STEP_S + tm_bytes / _SM_L2_BYTES_S))
    partials = 8.0 * plan.groups * b * t * h * w * co / _HBM_BYTES_S if plan.groups > 1 else 0.0
    return -(-plan.grid // sms) * block + partials


def fused_plan(x_shape, k: int, m: int, co: int, sms: int = ops.SMS) -> FusedPlan | None:
    """K4's launch plan for x (B, T, H, W, C), M mid and Co output channels,
    or None when no block fits in shared memory.

    Rows are the flattened B*H*W plane in tiles of bm (128 or 64); mid
    channels go in groups of mg (144 or 64), a block per (row tile, group)
    that computes its group's mid once (no block recomputes another's);
    the temporal conv runs in passes of ct (the smallest of 64 / 128 / 256
    that covers Co, else 256) output channels. Among the tiles that fit
    the 227 KB a block may use, the plan takes the one with the least
    modelled time (``_plan_cost``): at r2plus1d_18's sites at 8 clips,
    128 x 144 (stage 1, one group), 128 x 144 (stage 2, two groups), 128 x
    64 (stage 3, nine groups), 64 x 64 (stage 4, 18 groups, 126 blocks),
    each the fastest tiling measured on the card."""
    ct = next((n for n in _K4_CTS if n >= co), _K4_CTS[-1])
    plans = [p for bm in _K4_BMS for mg in _K4_MGS
             if (p := _make_plan(x_shape, k, m, co, sms, bm, mg, ct)) is not None]
    if not plans:
        return None
    return min(plans, key=lambda p: _plan_cost(p, x_shape, k, co, sms))


def fused_supported(x_shape, k: int, m: int, co: int) -> bool:
    """True if conv2plus1d_fused can run for these shapes."""
    _, _, h, w, c = x_shape
    return (k % 2 == 1 and c >= ops.MIN_C and h >= k and w >= k
            and fused_plan(x_shape, k, m, co) is not None)


def fused_block_cuda(x: torch.Tensor, w_sp: torch.Tensor, scale: torch.Tensor,
                     bias: torch.Tensor, w_tmp: torch.Tensor,
                     plan: FusedPlan | None = None) -> torch.Tensor:
    """K4: x (B, T, H, W, C), w_sp (k, k, C, M), w_tmp (k, M, Co), all bf16
    contiguous on CUDA; scale, bias (M,) f32 contiguous on the same device
    -> (B, T, H, W, Co) bf16. ``plan`` (default ``fused_plan`` for the
    device's SMs) may be given to run another tiling of the same function."""
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
    if plan is None:
        plan = fused_plan(x.shape, k, m, co, ops._sm_count(x.device))
    if plan is None:
        raise ValueError(f"no K4 block fits shared memory at k={k}, M={m}")
    # the kernel reads x 16 bytes at a time: channels padded to 8, aligned
    x = ops._pad_channels(x)
    x = x.clone() if x.data_ptr() % 16 else x
    cp = x.shape[-1]
    wsp_k = torch.empty((m, k * k, cp), dtype=x.dtype, device=x.device)
    wt_k = torch.empty((co, k, ops._ceil8(m)), dtype=x.dtype, device=x.device)
    y = torch.empty((b, t, h, wd, co), dtype=x.dtype, device=x.device)
    ws = (torch.empty((plan.groups, b * t * h * wd, co), dtype=torch.float32, device=x.device)
          if plan.groups > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernels().fvt_fused_block_bf16(
        x.data_ptr(), w_sp.data_ptr(), scale.data_ptr(), bias.data_ptr(), w_tmp.data_ptr(),
        wsp_k.data_ptr(), wt_k.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, b, t, h, wd, cp, c, m, co, k, plan.bm,
        plan.mg, plan.groups, plan.ct, plan.stages, plan.smem_bytes, x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_fused_block_bf16 launch failed: CUDA error {rc}")
    ops.launch_counts["fused_block"] += 1
    return y


def fused_weight_layout_plain(w_sp: torch.Tensor, w_tmp: torch.Tensor):
    """The plain version of K4's weight layouts (``fused_block_weight_kernel``):
    w_sp (k, k, C, M) -> (M, k*k, Cp) and w_tmp (k, M, Co) -> (Co, k, Mp),
    K-major, the contraction's channels zero-padded to a multiple of 8."""
    k, _, c, m = w_sp.shape
    wsp = ops._pad_channels(w_sp.permute(3, 0, 1, 2).reshape(m, k * k, c))
    return wsp.contiguous(), ops._pad_channels(w_tmp.permute(2, 0, 1)).contiguous()


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
