"""Clip datasets: per-(epoch, index) training clips and per-video eval clips.

The counterpart of ``ClipSample`` and ``ClipDataset`` in
``fastvideotagging_tpu/data/pipeline.py``, with the same semantics:

* Host code decodes and samples frame indices only, shipping raw uint8
  THWC stacks; resize/crop/flip/normalize run on the device
  (ops/preprocess.py).
* Determinism: every random draw (clip start, crop offsets, flip) comes from
  ``sampler.train_rng(seed, epoch, sample_index)`` in a fixed draw order —
  (clip start, crop top, crop left, flip) — so any clip is reproducible from
  (seed, epoch, index) alone, whatever the worker scheduling.
* Fault policy: a video that fails to decode is skipped with a log line and
  deterministically replaced by the next record.
* An optional decode-once frame cache (``DataConfig.cache_mb``).

Host resizing to the ship geometry is data/frames.py's numpy spec. The
batching loader (``train_batches``) and the device prefetch come with the
``fit`` slice.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np

from fastvideotagging_tpu_torch.config import DataConfig
from fastvideotagging_tpu_torch.data import decode, sampler
from fastvideotagging_tpu_torch.data.frames import _ensure_size
from fastvideotagging_tpu_torch.data.ucf101 import VideoRecord
from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.data")


@dataclasses.dataclass
class ClipSample:
    frames: np.ndarray  # (T, H, W, 3) uint8, at ship resolution
    label: int
    multihot: np.ndarray | None
    crop_top: int
    crop_left: int
    flip: bool


class ClipDataset:
    """Indexable clip source over a list of VideoRecords.

    mode 'train': random clip + random crop/flip per (epoch, index).
    mode 'eval' : deterministic center/uniform/dense clips, center crop.
    """

    def __init__(
        self,
        records: list[VideoRecord],
        data_cfg: DataConfig,
        mode: str = "train",
        num_tags: int | None = None,
        seed: int = 0,
    ):
        if mode not in ("train", "eval"):
            raise ValueError(f"mode must be train|eval, got {mode!r}")
        if num_tags is not None and records and not any(
                r.tags for r in records):
            # Silent failure mode otherwise: every multihot target is
            # all-zero and multilabel training converges to predicting no
            # tags (same guard as PackedDataset for tag-less packs).
            raise ValueError(
                "multilabel (num_tags set) needs records with tag sets, "
                "but no record carries any — parse the lists with "
                "load_tag_list (cli.train --tag-lists), not as class lists")
        self.records = records
        self.cfg = data_cfg
        self.mode = mode
        self.num_tags = num_tags
        self.seed = seed
        self._nframes_cache: dict[str, int] = {}
        # Optional decode-once frame cache (DataConfig.cache_mb).
        self._frame_cache: dict[str, np.ndarray] = {}
        self._cache_budget = int(getattr(data_cfg, "cache_mb", 0)) * 2 ** 20
        self._cache_bytes = 0
        self._cache_full_logged = False
        self._cache_lock = threading.Lock()
        # Ship resolution: what the host sends to the device. If the config
        # pins a source size, decode ships raw frames and the device does the
        # resize (the spec-exact fast path); otherwise host pre-resizes to
        # resize_hw and the device resize is an identity matmul.
        self.ship_hw = getattr(data_cfg, "source_hw", None) or data_cfg.resize_hw
        if getattr(data_cfg, "host_crop", False) and tuple(
                self.ship_hw) != tuple(data_cfg.resize_hw):
            raise ValueError(
                "host_crop slices the shipped frames directly, which is only "
                "pixel-exact when they are already at resize_hw (the device "
                "resize is then an identity); it cannot combine with "
                f"source_hw={data_cfg.source_hw} device-side resize")

    def __len__(self) -> int:
        return len(self.records)

    def _num_frames(self, rec: VideoRecord) -> int:
        n = self._nframes_cache.get(rec.path)
        if n is None:
            n, _, _, _ = decode.probe_video(rec.path)
            n = max(int(n), 1)
            self._nframes_cache[rec.path] = n
        return n

    def _cached_video(self, rec: VideoRecord) -> np.ndarray | None:
        """Whole decoded video at ship resolution, or None when caching is
        off / over budget. Decode happens outside the lock (cv2 releases the
        GIL); a rare duplicate decode on a race is benign."""
        if self._cache_budget <= 0:
            return None
        with self._cache_lock:
            hit = self._frame_cache.get(rec.path)
        if hit is not None:
            return hit
        n = self._num_frames(rec)
        frames = decode.read_frames_at(rec.path, np.arange(n))
        frames = _ensure_size(frames, self.ship_hw)
        with self._cache_lock:
            if rec.path in self._frame_cache:
                # another worker inserted while we decoded — don't bill the
                # budget twice for one key
                pass
            elif self._cache_bytes + frames.nbytes <= self._cache_budget:
                self._frame_cache[rec.path] = frames
                self._cache_bytes += frames.nbytes
            elif not self._cache_full_logged:
                self._cache_full_logged = True
                log.warning(
                    "frame cache budget (%d MiB) full after %d videos; "
                    "remaining videos stream-decode every epoch",
                    self._cache_budget >> 20, len(self._frame_cache))
        return frames

    def _clip_frames(self, rec: VideoRecord, frame_idx: np.ndarray) -> np.ndarray:
        """Frames of ``rec`` at the given indices, at ship resolution.

        The single frame-access point shared by train and eval sampling —
        PackedDataset (data/packed.py) overrides exactly this (plus
        ``_num_frames``) to serve the decode-once mmap tier with identical
        sampling semantics. Indices past the end clamp to the last frame
        (``read_frames_at``'s fill policy)."""
        video = self._cached_video(rec)
        if video is not None:
            frames = video[np.minimum(frame_idx, len(video) - 1)]
        else:
            frames = decode.read_frames_at(rec.path, frame_idx)
        return _ensure_size(frames, self.ship_hw)

    def _sample_train(self, index: int, epoch: int, fetch: bool = True):
        """Shared draw path of the train sampling: (record index, frame
        indices, frames | None, top, left, flip), deterministic in
        (seed, epoch, index) with the frozen draw order (clip start, crop
        top, crop left, flip). ``fetch=False`` skips the pixel IO — the
        index-only spec the JAX package's HBM-resident device-cache tier
        consumes (not ported yet); on mmap-backed PackedDatasets the fault
        policy is identical either way (pack reads cannot raise)."""
        s = self.cfg.sampler
        attempts = 0
        idx = index
        while True:
            rec_i = idx % len(self.records)
            rec = self.records[rec_i]
            rng = sampler.train_rng(self.seed, epoch, index)
            try:
                n = self._num_frames(rec)
                frame_idx = sampler.sample_train_indices(n, s.clip_len, s.stride, rng)
                frames = self._clip_frames(rec, frame_idx) if fetch else None
                break
            except decode.DecodeError as e:
                log.warning("skipping undecodable %s (%s)", rec.path, e)
                attempts += 1
                idx += 1
                if attempts >= min(len(self.records), 16):
                    raise
        rh, rw = self.cfg.resize_hw
        ch, cw = self.cfg.crop_hw
        top, left = sampler.random_crop_offsets(rh, rw, ch, cw, rng)
        flip = bool(self.cfg.random_flip and rng.integers(0, 2))
        return rec_i, frame_idx, frames, top, left, flip

    def get_train_spec(self, index: int, epoch: int):
        """Sampling decisions only, no pixel IO: (record index, frame
        indices (T,), crop top, crop left, flip) — exactly the draws
        ``get_train`` would make for the same (seed, epoch, index)."""
        rec_i, frame_idx, _frames, top, left, flip = self._sample_train(
            index, epoch, fetch=False)
        return rec_i, frame_idx, top, left, flip

    def get_train(self, index: int, epoch: int) -> ClipSample:
        """One training clip; deterministic in (seed, epoch, index)."""
        _rec_i, _frame_idx, frames, top, left, flip = self._sample_train(
            index, epoch, fetch=True)
        rec = self.records[_rec_i]
        ch, cw = self.cfg.crop_hw
        if getattr(self.cfg, "host_crop", False):
            # Same draw, applied here: ship only the (ch, cw) window. The
            # device preprocess then crops at (0, 0) from an identity
            # resize — bit-identical to device-side cropping.
            # Flip stays on device (a row-reversal of the coefficient
            # matrix; zero H2D savings from doing it here).
            frames = frames[:, top:top + ch, left:left + cw]
            top = left = 0
        return ClipSample(frames, rec.label if rec.label is not None else -1,
                          self._multihot(rec), top, left, flip)

    def get_eval_clips(self, index: int) -> tuple[np.ndarray, VideoRecord]:
        """All eval clips of one video: (K, T, H, W, 3) uint8."""
        rec = self.records[index]
        s = self.cfg.sampler
        n = self._num_frames(rec)
        idx = sampler.sample_eval_indices(
            n, s.clip_len, s.stride, mode=s.eval_mode, num_clips=s.num_eval_clips
        )  # (K, T)
        flat = self._clip_frames(rec, idx.reshape(-1))
        k, t = idx.shape
        return flat.reshape((k, t) + flat.shape[1:]), rec

    def _multihot(self, rec: VideoRecord) -> np.ndarray | None:
        if self.num_tags is None:
            return None
        return rec.multihot(self.num_tags)
