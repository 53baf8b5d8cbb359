"""Max-pool over (T, H, W) of an NTHWC tensor, with the JAX package's four
lowerings (the counterpart of ``fastvideotagging_tpu/ops/maxpool_grad.py``).

Max over a rectangular k_t x k_h x k_w window separates exactly into three
chained 1D pools, so every mode gives the same forward values; they differ
in their backward:

- 'sas': one 3D ``F.max_pool3d``; its backward sends a window's cotangent
  to the first maximal element in (t, h, w) order, as XLA's
  select_and_scatter does.
- 'sep': 1D pools chained in ``_sep_dims`` order (T, then H, then W), each
  routing its cotangent to the first tied element along its dim; the
  JAX package chains its 1D reduce_windows in the same order, so ties
  resolve to the same element.
- 'mask': one 3D pool whose backward splits each window's cotangent evenly
  over the elements equal to its max (a ``torch.autograd.Function``).
- 'sepmask': 1D pools, each with that even split.

Tie-free inputs give the same gradients in every mode. The lowering is
phase-dependent: 'sep' in train mode, 'sas' in eval, overridden by
``FVT_MAXPOOL_GRAD`` (train) and ``FVT_MAXPOOL_EVAL`` (eval), read at
import, or per call by ``grad=``.

Where a gradient is wanted, each pool of 'sas' and 'sep' is ``_GatherPool``:
its forward is ``_reduce_max``'s values, its backward the gather
``maxpool_grad`` (the kernel ``maxpool_grad_kernel``, csrc/maxpool_grad.cu,
on a CUDA tensor; ``maxpool_grad_plain`` on a CPU tensor; nothing falls
back from one to the other). It adds each window's cotangent to the
window's first maximal element, in a fixed order, with no atomics, so a
training step gives the same gradients every run, as XLA's
select_and_scatter does for the JAX package. ``F.max_pool3d``'s own CUDA
backward scatters with atomic adds: where windows overlap, its sums change
from run to run. Without a gradient (eval, serving, export) the pool is
``_reduce_max`` alone.

Padding: 'VALID', 'SAME' (TF-SAME, the extra element high) or explicit
``((lo, hi),) * 3``. Pads hold -inf (``F.pad``), since ``F.max_pool3d``'s
own padding is symmetric and at most half the window; the backward's pad
is implicit.
"""

from __future__ import annotations

import ctypes
import itertools
import os
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from fastvideotagging_tpu_torch.ops import _build

Triple = Tuple[int, int, int]
Pads = Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]]

MODES = ("sas", "sep", "mask", "sepmask")
DEFAULT_GRAD = os.environ.get("FVT_MAXPOOL_GRAD", "sep")
EVAL_DEFAULT = os.environ.get("FVT_MAXPOOL_EVAL", "sas")


def resolve_pads(shape_sp: Sequence[int], window: Triple, strides: Triple,
                 padding) -> Pads:
    """Flax-style padding (string or explicit) -> (lo, hi) per dim.
    'SAME' is TF-SAME (the extra element on the high side)."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return ((0, 0), (0, 0), (0, 0))
        if p == "SAME":
            out = []
            for i in range(3):
                o = -(-shape_sp[i] // strides[i])
                pad = max((o - 1) * strides[i] + window[i] - shape_sp[i], 0)
                out.append((pad // 2, pad - pad // 2))
            return tuple(out)
        raise ValueError(f"unknown padding {padding!r}")
    pads = tuple((int(lo), int(hi)) for lo, hi in padding)
    if len(pads) != 3:
        raise ValueError("explicit padding must give (lo, hi) for T, H, W")
    return pads


def _sep_dims(window: Triple, strides: Triple, pads: Pads) -> list[int]:
    """Dims that actually pool, in order; a 1-wide unstrided unpadded dim
    is the identity and skipped."""
    return [i for i in range(3)
            if window[i] > 1 or strides[i] > 1 or pads[i] != (0, 0)]


def _axis_spec(i: int, window: Triple, strides: Triple, pads: Pads):
    w, s, p = [1, 1, 1], [1, 1, 1], [(0, 0)] * 3
    w[i], s[i], p[i] = window[i], strides[i], pads[i]
    return tuple(w), tuple(s), tuple(p)


def _pad(x: torch.Tensor, pads: Pads, value: float) -> torch.Tensor:
    if all(p == (0, 0) for p in pads):
        return x
    (t0, t1), (h0, h1), (w0, w1) = pads
    return F.pad(x, (0, 0, w0, w1, h0, h1, t0, t1), value=value)


def _reduce_max(x: torch.Tensor, window: Triple, strides: Triple, pads: Pads) -> torch.Tensor:
    """One 3D max over -inf padded x."""
    xp = _pad(x, pads, float("-inf"))
    y = F.max_pool3d(xp.permute(0, 4, 1, 2, 3), window, strides)
    return y.permute(0, 2, 3, 4, 1).contiguous()


# ---------------------------------------------------------------------------
# The backward as a gather (csrc/maxpool_grad.cu) and its plain version
# ---------------------------------------------------------------------------

# kernel launches since the last reset
launch_counts = {"maxpool_grad": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# fvt_maxpool_grad(x, y, ct, dx, n, t, h, w, c, ot, oh, ow, kt, kh, kw, st, sh,
# sw, pt, ph, pw, dtype, device, stream)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 18 + [ctypes.c_void_p]
# the kernel's type codes
_DTYPES = {torch.bfloat16: 0, torch.float32: 1, torch.float64: 2}
_lib = None


def _kernel():
    global _lib
    if _lib is None:
        lib = _build.load("maxpool_grad")
        lib.fvt_maxpool_grad.argtypes = _ARGTYPES
        lib.fvt_maxpool_grad.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_pool(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, window: Triple,
                strides: Triple, pads: Pads) -> None:
    if x.ndim != 5 or y.shape != ct.shape or y.ndim != 5:
        raise ValueError(f"x, y and ct must be NTHWC; got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}, {tuple(ct.shape)}")
    for i in range(3):
        lo, hi = pads[i]
        out = (x.shape[1 + i] + lo + hi - window[i]) // strides[i] + 1
        if y.shape[1 + i] != out:
            raise ValueError(f"y's dim {i} is {y.shape[1 + i]}, the pool gives {out}")


def maxpool_grad_cuda(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, window: Triple,
                      strides: Triple, pads: Pads) -> torch.Tensor:
    """The kernel: dx of the max pool ``y = _reduce_max(x, window, strides,
    pads)`` for the cotangent ``ct`` of y; x, y and ct contiguous CUDA
    tensors of one type (bf16, f32 or f64). Each window's cotangent goes
    to its first maximal element in (t, h, w) order; the sum at an element is
    taken in f32 (f64) over its windows in output order, rounded once."""
    for name, t in (("x", x), ("y", y), ("ct", ct)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != x.dtype or t.dtype not in _DTYPES:
            raise ValueError(f"{name} is {t.dtype}; x, y and ct must share one of "
                             f"{sorted(map(str, _DTYPES))}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name} must be contiguous on {x.device}")
    _check_pool(x, y, ct, window, strides, pads)
    if any(lo >= k for (lo, _), k in zip(pads, window)):
        raise ValueError(f"a low pad of {pads} is not under the window {window}")
    dx = torch.empty_like(x)
    n, t, h, w, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel().fvt_maxpool_grad(
        x.data_ptr(), y.data_ptr(), ct.data_ptr(), dx.data_ptr(), n, t, h, w, c,
        *y.shape[1:4], *window, *strides, *(lo for lo, _ in pads), _DTYPES[x.dtype],
        x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"fvt_maxpool_grad launch failed: CUDA error {rc}")
    launch_counts["maxpool_grad"] += 1
    return dx


def maxpool_grad_plain(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, window: Triple,
                       strides: Triple, pads: Pads) -> torch.Tensor:
    """The plain version of the kernel, the same adds in the same order: a
    window offset's elements take the window's cotangent where they equal
    y and no offset before it (raster (t, h, w) order) did, the argmax taken
    from x and y; the offsets are added in reverse order, which at each
    element is the windows' output order, into an f32 (f64) sum that is
    rounded once."""
    _check_pool(x, y, ct, window, strides, pads)
    acc = torch.promote_types(ct.dtype, torch.float32)
    xp = _pad(x, pads, float("-inf"))
    ysp = y.shape[1:4]

    def window_slice(off):
        return (slice(None),) + tuple(
            slice(off[i], off[i] + (ysp[i] - 1) * strides[i] + 1, strides[i])
            for i in range(3)) + (slice(None),)

    offsets = list(itertools.product(*(range(k) for k in window)))
    taken = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    firsts = []
    for off in offsets:
        hit = xp[window_slice(off)] == y
        firsts.append(hit & ~taken)
        taken |= hit
    cta = ct.to(acc)
    zero = torch.zeros((), dtype=acc, device=ct.device)
    grad = torch.zeros(xp.shape, dtype=acc, device=x.device)
    for off, first in reversed(list(zip(offsets, firsts))):
        grad[window_slice(off)] += torch.where(first, cta, zero)
    lo = [p[0] for p in pads]
    grad = grad[:, lo[0]:lo[0] + x.shape[1], lo[1]:lo[1] + x.shape[2], lo[2]:lo[2] + x.shape[3]]
    return grad.to(x.dtype).contiguous()


def maxpool_grad(x: torch.Tensor, y: torch.Tensor, ct: torch.Tensor, window: Triple,
                 strides: Triple, pads: Pads) -> torch.Tensor:
    """The kernel for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return maxpool_grad_cuda(x, y, ct, window, strides, pads)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return maxpool_grad_plain(x, y, ct, window, strides, pads)


class _GatherPool(torch.autograd.Function):
    """One max pool: ``_reduce_max``'s values, ``maxpool_grad`` as its
    backward."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        with torch.no_grad():
            y = _reduce_max(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.spec = (window, strides, pads)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        return maxpool_grad(x, y, ct.contiguous(), *ctx.spec), None, None, None


class _MaskPool(torch.autograd.Function):
    """One max pool whose backward splits each window's cotangent evenly
    over its tied maxima (the JAX package's ``_max_pool_mask_grad``)."""

    @staticmethod
    def forward(ctx, x, window, strides, pads):
        with torch.no_grad():
            y = _reduce_max(x, window, strides, pads)
        ctx.save_for_backward(x, y)
        ctx.spec = (window, strides, pads)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, ct):
        x, y = ctx.saved_tensors
        window, strides, pads = ctx.spec
        xp = _pad(x, pads, float("-inf"))
        ysp = y.shape[1:4]

        def window_slice(off):
            return (slice(None),) + tuple(
                slice(off[i], off[i] + (ysp[i] - 1) * strides[i] + 1, strides[i])
                for i in range(3)) + (slice(None),)

        offsets = list(itertools.product(*(range(k) for k in window)))
        ties = sum((xp[window_slice(o)] == y).to(ct.dtype) for o in offsets)
        share = ct / ties
        grad = torch.zeros_like(xp, dtype=ct.dtype)
        for o in offsets:
            sl = window_slice(o)
            grad[sl] += (xp[sl] == y).to(ct.dtype) * share
        lo = [p[0] for p in pads]
        grad = grad[:, lo[0]:lo[0] + x.shape[1], lo[1]:lo[1] + x.shape[2],
                    lo[2]:lo[2] + x.shape[3]]
        return grad.to(x.dtype), None, None, None


def max_pool_nthwc(x: torch.Tensor, window: Triple, strides: Triple | None = None,
                   padding="VALID", grad: str | None = None,
                   train: bool = False) -> torch.Tensor:
    """Max-pool over the (T, H, W) dims of an NTHWC tensor. ``grad``
    selects the lowering (module docstring); None takes 'sep' in train mode
    and 'sas' in eval, or the environment's overrides."""
    window = tuple(window)
    strides = tuple(strides) if strides is not None else window
    pads = resolve_pads(x.shape[1:4], window, strides, padding)
    mode = grad or (DEFAULT_GRAD if train else EVAL_DEFAULT)
    # 'sas' and 'sep' pool through _GatherPool where a gradient is wanted
    pool = (_GatherPool.apply if torch.is_grad_enabled() and x.requires_grad
            else _reduce_max)
    if mode == "sas":
        return pool(x, window, strides, pads)
    if mode == "mask":
        return _MaskPool.apply(x, window, strides, pads)
    if mode in ("sep", "sepmask"):
        for i in _sep_dims(window, strides, pads):
            w, s, p = _axis_spec(i, window, strides, pads)
            x = _MaskPool.apply(x, w, s, p) if mode == "sepmask" else pool(x, w, s, p)
        return x
    raise ValueError(f"unknown maxpool grad mode {mode!r}; expected one of {MODES}")
