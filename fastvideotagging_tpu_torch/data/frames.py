"""Host frame resize to the ship geometry.

The counterpart of ``fastvideotagging_tpu/data/pipeline.py::_ensure_size``:
frames whose decoded size is not the ship size are resized by the C tier,
``native.resize_batch_u8`` (csrc/framepack.c, built at first use), as the
JAX package's default tier does. ``resize_batch_u8_plain`` is the numpy
version of the same spec (the half-pixel bilinear of data/preprocess.py,
rounded half to even and clamped to uint8); the tests hold the C tier to it,
and nothing on the main path runs it. The two differ by one level at a few
values, where the C tier's fused multiply-adds round otherwise.
"""

from __future__ import annotations

import numpy as np

from fastvideotagging_tpu_torch import native
from fastvideotagging_tpu_torch.data.preprocess import resize_bilinear_host


def resize_batch_u8_plain(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear (half-pixel) resize of (T, H, W, 3) uint8 frames in numpy."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    x = resize_bilinear_host(frames, out_h, out_w)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _ensure_size(frames: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Host-resize (the C tier) only if the decoded size differs from the
    ship size."""
    h, w = hw
    if frames.shape[1] == h and frames.shape[2] == w:
        return frames
    return native.resize_batch_u8(frames, h, w)
