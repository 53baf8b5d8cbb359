"""Video decode via cv2's bundled FFmpeg.

A copy of the streaming half of ``fastvideotagging_tpu/data/decode.py``
(``probe_video`` and ``SequentialReader``), with the same corrupt-frame fill
policy: an undecodable frame is served as the nearest previously decoded
frame, frames before the first decodable one as the first decodable frame.
cv2 is optional at import time; decoding without it raises.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class DecodeError(RuntimeError):
    """Raised when a video yields no decodable frames."""


def _require_cv2():
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("opencv-python is required for video decode")


def probe_video(path: str) -> tuple[int, float, int, int]:
    """Return (num_frames, fps, height, width) for a video file.

    Some containers report a bogus frame count; treat it as an upper bound.
    """
    _require_cv2()
    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise DecodeError(f"cannot open video: {path}")
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        fps = float(cap.get(cv2.CAP_PROP_FPS))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        return n, fps, h, w
    finally:
        cap.release()


class SequentialReader:
    """Forward-streaming frame reader for long-form video.

    Serves successive ``read(indices)`` calls with mostly-increasing indices
    in ONE decode pass, keeping a small cache of recent frames for the
    bounded backward overlap between dense clip windows (the tail window).
    A request older than the cache triggers a rewind (reopen). Memory:
    O(cache_size) frames.
    """

    def __init__(self, path: str, cache_size: int = 128):
        _require_cv2()
        self.path = path
        self.cache_size = cache_size
        self._cache: dict[int, np.ndarray] = {}
        self._cap = None
        self._pos = 0
        self._last_good: np.ndarray | None = None
        self._pending_leading: list[int] = []  # bad frames before 1st good
        self._open()

    def _open(self):
        if self._cap is not None:
            self._cap.release()
        self._cap = cv2.VideoCapture(self.path)
        if not self._cap.isOpened():
            raise DecodeError(f"cannot open video: {self.path}")
        self._pos = 0
        self._pending_leading = []

    def close(self):
        if self._cap is not None:
            self._cap.release()
            self._cap = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _advance_to(self, target: int) -> np.ndarray | None:
        """Decode forward until frame ``target`` is read; returns it."""
        out = None
        while self._pos <= target:
            ok = self._cap.grab()
            if not ok:
                break
            ok, frame = self._cap.retrieve()
            if ok and frame is not None:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                self._last_good = rgb
                for p in self._pending_leading:
                    self._cache[p] = rgb
                self._pending_leading = []
            else:
                rgb = self._last_good
                if rgb is None:
                    self._pending_leading.append(self._pos)
            if rgb is not None:
                self._cache[self._pos] = rgb
                if len(self._cache) > self.cache_size:
                    self._cache.pop(min(self._cache))
                if self._pos == target:
                    out = rgb
            self._pos += 1
        return out

    def read(self, indices: np.ndarray) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int64).reshape(-1)
        frames: list[np.ndarray | None] = [None] * len(indices)
        order = np.argsort(indices, kind="stable")
        for k in order:
            idx = int(indices[k])
            f = self._cache.get(idx)
            if f is None and idx < self._pos:
                self._open()  # rewind (rare): older than the cache window
                self._cache.clear()
            if f is None and idx >= self._pos:
                f = self._advance_to(idx)
            if f is None:
                f = self._last_good
            frames[k] = f
        if self._last_good is None:
            raise DecodeError(f"no decodable frames in: {self.path}")
        out = np.empty((len(indices),) + self._last_good.shape, np.uint8)
        for i, f in enumerate(frames):
            if f is None:
                # a leading-bad index may have been backfilled into the
                # cache by a later decode within this same read()
                f = self._cache.get(int(indices[i]), self._last_good)
            out[i] = f
        return out
