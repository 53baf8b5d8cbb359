"""The host data plane and the native serving tier (the counterpart of
``fastvideotagging_tpu/native/``).

The host data plane is csrc/framepack.c, the port's copy of the JAX
package's C tier: ``pack_frames`` gathers frames into a clip and
``resize_batch_u8`` resizes frames to the ship geometry (the resize that
``data/frames.py::_ensure_size`` runs). The library is built with the system
C compiler at first use (``ops/_build.py::build_framepack``, the JAX
package's flags) and bound through ctypes. Unlike the JAX package, which
falls back to numpy quietly, the port has no fallback: a missing compiler or
a failed build raises (``available()`` says whether the library loads).

``native.runner`` builds and drives the C++ runner (csrc/native_runner.cpp),
which runs the serving program's AOTInductor package
(``evaluation.serving.export_serving_native``) with no Python in its
process.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from fastvideotagging_tpu_torch.ops import _build

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _load() -> ctypes.CDLL:
    """The framepack library, built and bound at the first call; raises when
    it cannot be built."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                lib = ctypes.CDLL(_build.build_framepack())
                lib.fvt_pack_frames.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                ]
                lib.fvt_pack_frames.restype = None
                lib.fvt_resize_batch_u8.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                    ctypes.c_int64,
                ]
                lib.fvt_resize_batch_u8.restype = ctypes.c_int
                _lib = lib
    return _lib


def available() -> bool:
    """Whether the C tier loads on this machine (building it if needed)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def pack_frames(frames: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Gather frames[i] for i in indices -> (len(indices), H, W, 3) uint8.

    Out-of-range indices clamp: below 0 to the first frame, past the end to
    the last."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    idx = np.ascontiguousarray(indices, dtype=np.int64).reshape(-1)
    if frames.ndim < 1 or len(frames) == 0:
        raise ValueError(f"pack_frames needs at least one frame, got shape {frames.shape}")
    out = np.empty((len(idx),) + frames.shape[1:], np.uint8)
    _load().fvt_pack_frames(
        frames.ctypes.data, frames.shape[0], idx.ctypes.data, len(idx),
        int(np.prod(frames.shape[1:])), out.ctypes.data,
    )
    return out


def resize_batch_u8(frames: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear (half-pixel) resize of (T, H, W, 3) uint8 frames, rounded
    half to even and clamped to uint8 (csrc/framepack.c)."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim != 4 or frames.shape[-1] != 3:
        raise ValueError(f"expected (T, H, W, 3) frames, got {frames.shape}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"the output size must be positive, got {out_h}x{out_w}")
    t, h, w, _ = frames.shape
    out = np.empty((t, out_h, out_w, 3), np.uint8)
    rc = _load().fvt_resize_batch_u8(frames.ctypes.data, t, h, w, out.ctypes.data,
                                     out_h, out_w)
    if rc != 0:
        raise MemoryError("fvt_resize_batch_u8 could not allocate its tables")
    return out
