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

Padding: 'VALID', 'SAME' (TF-SAME, the extra element high) or explicit
``((lo, hi),) * 3``. Pads hold -inf (``F.pad``), since ``F.max_pool3d``'s
own padding is symmetric and at most half the window.
"""

from __future__ import annotations

import itertools
import os
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

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
    """One 3D max over -inf padded x; autograd's backward is the library's
    (the first maximal element of each window)."""
    xp = _pad(x, pads, float("-inf"))
    y = F.max_pool3d(xp.permute(0, 4, 1, 2, 3), window, strides)
    return y.permute(0, 2, 3, 4, 1).contiguous()


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
    if mode == "sas":
        return _reduce_max(x, window, strides, pads)
    if mode == "mask":
        return _MaskPool.apply(x, window, strides, pads)
    if mode in ("sep", "sepmask"):
        for i in _sep_dims(window, strides, pads):
            w, s, p = _axis_spec(i, window, strides, pads)
            x = _MaskPool.apply(x, w, s, p) if mode == "sepmask" else _reduce_max(x, w, s, p)
        return x
    raise ValueError(f"unknown maxpool grad mode {mode!r}; expected one of {MODES}")
