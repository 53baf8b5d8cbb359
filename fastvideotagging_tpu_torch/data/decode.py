"""Video decode via cv2's bundled FFmpeg.

A copy of ``fastvideotagging_tpu/data/decode.py``'s ``probe_video``,
``read_frames_at``, ``SequentialReader``, ``iter_frame_chunks`` and
``read_all_frames``, with the
same corrupt-frame fill policy: an undecodable frame is served as the nearest
previously decoded frame, frames before the first decodable one as the first
decodable frame, indices past the end of the stream as the last one.
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



def read_frames_at(path: str, indices: np.ndarray) -> np.ndarray:
    """Decode frames at the given indices. Returns RGB uint8 (len(indices), H, W, 3).

    Single sequential pass with ``grab()`` (fast frame skip, no per-frame
    decode) and ``retrieve()`` only at wanted indices — seeking per-index is
    pathologically slow on long-GOP codecs.
    """
    _require_cv2()
    indices = np.asarray(indices, dtype=np.int64).reshape(-1)
    order = np.argsort(indices, kind="stable")
    sorted_idx = indices[order]

    cap = cv2.VideoCapture(path)
    try:
        if not cap.isOpened():
            raise DecodeError(f"cannot open video: {path}")
        # Corrupt-frame fill policy (shared with SequentialReader and
        # iter_frame_chunks so the decode-once pack is bit-identical to
        # streaming): an undecodable frame = the nearest PREVIOUSLY decoded
        # frame; frames before the first decodable one = the FIRST decodable
        # frame; indices past end-of-stream = the last decoded frame.
        wanted = {}
        pos = 0  # next frame number grab() will consume
        last_good = None
        first_good = None
        max_idx = int(sorted_idx[-1])
        k = 0
        while pos <= max_idx and k < len(sorted_idx):
            ok = cap.grab()
            if not ok:
                if k < len(sorted_idx):
                    # stream shorter than the wanted indices (lying
                    # container): the last successfully GRABBED frame is
                    # still retrievable — use the stream's true last frame
                    # as the past-end fill, matching SequentialReader and
                    # the pack's clamp-to-last-stored semantics
                    ok2, frame = cap.retrieve()
                    if ok2 and frame is not None:
                        last_good = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                        if first_good is None:
                            first_good = last_good
                break
            if pos == sorted_idx[k]:
                ok, frame = cap.retrieve()
                if ok and frame is not None:
                    rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                    last_good = rgb
                    if first_good is None:
                        first_good = rgb
                else:
                    rgb = last_good  # None for leading-bad: backfilled below
                while k < len(sorted_idx) and sorted_idx[k] == pos:
                    wanted[k] = rgb
                    k += 1
            pos += 1
        if last_good is None:
            # The wanted indices all failed retrieve (or stream empty); a
            # later frame may still decode — scan forward for the backfill
            # source before declaring the video dead.
            while first_good is None:
                ok = cap.grab()
                if not ok:
                    break
                ok, frame = cap.retrieve()
                if ok and frame is not None:
                    first_good = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            if first_good is None:
                raise DecodeError(f"no decodable frames in: {path}")
            last_good = first_good
        # Leading-bad indices (key present, value None) -> first decodable
        # frame; past-end (key absent) -> last decoded frame.
        frames_sorted = []
        for i in range(len(sorted_idx)):
            v = wanted.get(i, last_good)
            if v is None:
                v = first_good
            frames_sorted.append(v)
        out = np.empty((len(indices),) + last_good.shape, dtype=np.uint8)
        for dst, src in enumerate(order):
            out[src] = frames_sorted[dst]
        return out
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


def iter_frame_chunks(path: str, chunk_size: int = 256):
    """Yield successive (K, H, W, 3) uint8 RGB chunks in ONE forward pass.

    The decode-once writer's memory-bounded read path (data/packed.py):
    a long-form video never needs more than ``chunk_size`` frames resident.
    Stops at end of stream (same boundary semantics as ``read_all_frames``);
    raises DecodeError if not a single frame decodes.
    """
    _require_cv2()
    cap = cv2.VideoCapture(path)
    got_any = False
    try:
        if not cap.isOpened():
            raise DecodeError(f"cannot open video: {path}")
        # Same corrupt-frame fill policy as read_frames_at/SequentialReader
        # (grab ok + retrieve fail -> nearest previous good frame; before
        # the first good frame -> the first good frame) so the decode-once
        # pack stores exactly what the streaming readers would serve.
        buf: list[np.ndarray] = []
        last_good: np.ndarray | None = None
        pending_leading = 0
        while True:
            if not cap.grab():
                break
            ok, frame = cap.retrieve()
            if ok and frame is not None:
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                if last_good is None and pending_leading:
                    buf.extend([rgb] * pending_leading)
                    pending_leading = 0
                last_good = rgb
                buf.append(rgb)
            elif last_good is not None:
                buf.append(last_good)
            else:
                pending_leading += 1
            while len(buf) >= chunk_size:
                got_any = True
                yield np.stack(buf[:chunk_size])
                buf = buf[chunk_size:]
        if buf:
            got_any = True
            yield np.stack(buf)
        if not got_any:
            raise DecodeError(f"no decodable frames in: {path}")
    finally:
        cap.release()


def read_all_frames(path: str, max_frames: int | None = None) -> np.ndarray:
    """Decode every frame (up to max_frames). Returns RGB uint8 (N, H, W, 3)."""
    _require_cv2()
    cap = cv2.VideoCapture(path)
    frames = []
    try:
        if not cap.isOpened():
            raise DecodeError(f"cannot open video: {path}")
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok or frame is None:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
    finally:
        cap.release()
    if not frames:
        raise DecodeError(f"no decodable frames in: {path}")
    return np.stack(frames)
