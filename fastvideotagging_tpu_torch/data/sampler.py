"""Clip-index and crop-geometry math — the executable golden spec.

A copy of ``fastvideotagging_tpu/data/sampler.py``; the integer arithmetic
is identical (tests hold the two equal), so both packages score the same
frames of a video.

* A clip of length T with stride s spans ``span = (T - 1) * s + 1`` frames.
* Videos shorter than the span wrap cyclically (``% num_frames``).
* train 'random':  start uniform in [0, num_frames - span]  (inclusive).
* eval  'center':  start = (num_frames - span) // 2.
* eval  'uniform': K starts = round(linspace(0, num_frames - span, K)).
* eval  'dense':   consecutive non-overlapping windows, hop = T * s,
                   at least one window; used for long-form tagging.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "clip_span",
    "sample_train_indices",
    "sample_eval_indices",
    "center_crop_offsets",
    "random_crop_offsets",
    "train_rng",
]


def clip_span(clip_len: int, stride: int) -> int:
    """Number of source frames a (clip_len, stride) clip spans."""
    if clip_len < 1 or stride < 1:
        raise ValueError(f"clip_len and stride must be >= 1, got {clip_len}, {stride}")
    return (clip_len - 1) * stride + 1


def _base_indices(clip_len: int, stride: int) -> np.ndarray:
    return np.arange(clip_len, dtype=np.int64) * stride


def _wrap(indices: np.ndarray, num_frames: int) -> np.ndarray:
    return np.mod(indices, num_frames)


def train_rng(seed: int, epoch: int, sample_index: int) -> np.random.Generator:
    """Deterministic per-(epoch, sample) RNG stream for train-time sampling."""
    return np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, epoch, sample_index])
    )


def sample_train_indices(
    num_frames: int, clip_len: int, stride: int, rng: np.random.Generator
) -> np.ndarray:
    """Random-start training clip. Returns int64 indices of shape (clip_len,)."""
    if num_frames < 1:
        raise ValueError(f"num_frames must be >= 1, got {num_frames}")
    span = clip_span(clip_len, stride)
    base = _base_indices(clip_len, stride)
    if num_frames < span:
        return _wrap(base, num_frames)
    start = int(rng.integers(0, num_frames - span + 1))
    return base + start


def sample_eval_indices(
    num_frames: int,
    clip_len: int,
    stride: int,
    mode: str = "center",
    num_clips: int = 10,
) -> np.ndarray:
    """Deterministic eval clips. Returns int64 indices of shape (K, clip_len).

    K = 1 for 'center', num_clips for 'uniform', and ceil coverage for 'dense'.
    """
    if num_frames < 1:
        raise ValueError(f"num_frames must be >= 1, got {num_frames}")
    span = clip_span(clip_len, stride)
    base = _base_indices(clip_len, stride)

    if num_frames < span:
        return _wrap(base, num_frames)[None, :]

    last_start = num_frames - span  # inclusive
    if mode == "center":
        starts = np.array([last_start // 2], dtype=np.int64)
    elif mode == "uniform":
        if num_clips < 1:
            raise ValueError(f"num_clips must be >= 1, got {num_clips}")
        starts = np.rint(np.linspace(0.0, float(last_start), num_clips)).astype(np.int64)
    elif mode == "dense":
        hop = clip_len * stride
        starts = np.arange(0, last_start + 1, hop, dtype=np.int64)
        # If the final window does not land exactly, add a tail window flush
        # with the end so the last frames are covered exactly once more.
        if starts[-1] != last_start:
            starts = np.concatenate([starts, np.array([last_start], dtype=np.int64)])
    else:
        raise ValueError(f"unknown eval mode: {mode!r}")
    return starts[:, None] + base[None, :]


def center_crop_offsets(h: int, w: int, crop_h: int, crop_w: int) -> tuple[int, int]:
    """(top, left) of a centered crop; floor-division semantics."""
    if crop_h > h or crop_w > w:
        raise ValueError(f"crop ({crop_h},{crop_w}) larger than frame ({h},{w})")
    return (h - crop_h) // 2, (w - crop_w) // 2


def random_crop_offsets(
    h: int, w: int, crop_h: int, crop_w: int, rng: np.random.Generator
) -> tuple[int, int]:
    """(top, left) of a uniform random crop (train-time)."""
    if crop_h > h or crop_w > w:
        raise ValueError(f"crop ({crop_h},{crop_w}) larger than frame ({h},{w})")
    top = int(rng.integers(0, h - crop_h + 1))
    left = int(rng.integers(0, w - crop_w + 1))
    return top, left
