"""Host-side (numpy) preprocessing reference spec.

A copy of ``fastvideotagging_tpu/data/preprocess.py``: the executable
specification of resize/crop/flip/normalize geometry that the device
preprocess (ops/preprocess.py) is held to.

Resize spec: separable bilinear with half-pixel centers (align_corners=False),

    src_x = (dst_x + 0.5) * (src / dst) - 0.5, clamped to [0, src-1]

expressed as two small dense coefficient matrices, ``out = A_h @ img @ A_w.T``.
Normalization: ``(x / 255 - mean) / std`` with per-channel RGB constants in
[0,1] units. Order: resize -> crop -> (train-only flip) -> normalize; THWC.
"""

from __future__ import annotations

import functools

import numpy as np

__all__ = [
    "resize_coeffs",
    "resize_bilinear_host",
    "preprocess_clip_host",
]


@functools.lru_cache(maxsize=64)
def resize_coeffs(src: int, dst: int) -> np.ndarray:
    """Dense (dst, src) f32 bilinear interpolation matrix, half-pixel centers.

    Each row has at most two non-zeros summing to 1. Cached — only a handful
    of (src, dst) pairs ever occur; callers must not write to the result.
    """
    if src < 1 or dst < 1:
        raise ValueError(f"invalid resize {src} -> {dst}")
    scale = src / dst
    x = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    x = np.clip(x, 0.0, src - 1)
    lo = np.floor(x).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = (x - lo).astype(np.float64)
    mat = np.zeros((dst, src), dtype=np.float64)
    rows = np.arange(dst)
    mat[rows, lo] += 1.0 - frac
    mat[rows, hi] += frac
    return mat.astype(np.float32)


def resize_bilinear_host(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Resize (T, H, W, C) uint8/float frames to (T, out_h, out_w, C) float32."""
    t, h, w, c = frames.shape
    ah = resize_coeffs(h, out_h)  # (out_h, h)
    aw = resize_coeffs(w, out_w)  # (out_w, w)
    x = frames.astype(np.float32)
    # Contraction order is part of the spec: height first, then width.
    x = np.einsum("oh,thwc->towc", ah, x)
    x = np.einsum("pw,towc->topc", aw, x)
    return x


def preprocess_clip_host(
    frames: np.ndarray,
    resize_hw: tuple[int, int],
    crop_offsets: tuple[int, int],
    crop_hw: tuple[int, int],
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    flip: bool = False,
) -> np.ndarray:
    """Full host preprocess: (T,H,W,3) uint8 -> (T,ch,cw,3) float32 THWC."""
    rh, rw = resize_hw
    top, left = crop_offsets
    ch, cw = crop_hw
    x = resize_bilinear_host(frames, rh, rw)
    x = x[:, top : top + ch, left : left + cw, :]
    if flip:
        x = x[:, :, ::-1, :]
    m = np.asarray(mean, dtype=np.float32) * 255.0
    s = np.asarray(std, dtype=np.float32) * 255.0
    return (x - m) / s
