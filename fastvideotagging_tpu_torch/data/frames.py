"""Host frame resize to the ship geometry.

The counterpart of ``fastvideotagging_tpu/data/pipeline.py::_ensure_size``
with the numpy resize of ``fastvideotagging_tpu/native/__init__.py``: the
half-pixel bilinear spec of data/preprocess.py, rounded half to even and
clamped to uint8. The C framepack tier is not part of the port yet.
"""

from __future__ import annotations

import numpy as np

from fastvideotagging_tpu_torch.data.preprocess import resize_bilinear_host


def resize_batch_u8(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear (half-pixel) resize of (T, H, W, 3) uint8 frames."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    x = resize_bilinear_host(frames, out_h, out_w)
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _ensure_size(frames: np.ndarray, hw: tuple[int, int]) -> np.ndarray:
    """Host-resize only if the decoded size differs from the ship size."""
    h, w = hw
    if frames.shape[1] == h and frames.shape[2] == w:
        return frames
    return resize_batch_u8(frames, h, w)
