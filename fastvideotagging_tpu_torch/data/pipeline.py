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

Host resizing to the ship geometry is data/frames.py's (the C tier,
csrc/framepack.c).

``train_batches`` collates shuffled, worker-decoded clips into uint8 numpy
batches for one epoch (the same Philox permutation per (seed, epoch) and the
same bounded thread-pool window as the JAX package, so the two yield equal
batches); ``device_prefetch`` keeps ``depth`` of them in flight to the card.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
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
        index-only spec the device-cache tier consumes
        (data/device_cache.py); on mmap-backed PackedDatasets the fault
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


def _collate(samples: list[ClipSample]) -> dict[str, np.ndarray]:
    batch = {
        "frames": np.stack([s.frames for s in samples]),
        "labels": np.asarray([s.label for s in samples], np.int32),
        "crop_tops": np.asarray([s.crop_top for s in samples], np.int32),
        "crop_lefts": np.asarray([s.crop_left for s in samples], np.int32),
        "flips": np.asarray([s.flip for s in samples], bool),
        "weights": np.ones((len(samples),), np.float32),
    }
    if samples[0].multihot is not None:
        batch["multihot"] = np.stack([s.multihot for s in samples])
    return batch


def epoch_order(dataset: ClipDataset, batch_size: int, epoch: int, drop_last: bool = True,
                rows: list[int] | None = None) -> tuple[np.ndarray, int]:
    """The dataset indices of one epoch's batches, in order, and the batch
    size (``len(rows)`` when ``rows`` is given): the Philox (seed, epoch)
    permutation, cut to whole batches when ``drop_last``, and with ``rows``
    only those positions of each batch."""
    order = np.random.Generator(
        np.random.Philox(key=np.uint64(dataset.seed), counter=[0, 0, 0, epoch])
    ).permutation(len(dataset))
    usable = len(order) - (len(order) % batch_size) if drop_last else len(order)
    indices = order[:usable]
    if rows is not None and usable:
        if not drop_last:
            raise ValueError("rows= requires drop_last")
        if not rows or any(r < 0 or r >= batch_size for r in rows):
            raise ValueError(f"rows must be within [0, {batch_size}): {rows}")
        sel = np.concatenate([
            np.asarray(rows, np.int64) + b * batch_size
            for b in range(usable // batch_size)
        ])
        indices = indices[sel]
        batch_size = len(rows)
    return indices, batch_size


def train_batches(
    dataset: ClipDataset,
    batch_size: int,
    epoch: int,
    num_workers: int = 8,
    drop_last: bool = True,
    rows: list[int] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Shuffled, worker-decoded training batches for one epoch.

    The shuffle permutation is seeded by (seed, epoch); decode runs in a
    thread pool with a bounded window so at most ~2 batches of futures are in
    flight (backpressure), and results are consumed in deterministic order.

    ``rows``: positions within each global batch to materialize. Every
    sample's content is a pure function of (seed, epoch, dataset index), so
    a subset of rows reproduces exactly those rows of the full batch;
    yielded batches then have len(rows) samples, in global row order.
    """
    indices, batch_size = epoch_order(dataset, batch_size, epoch, drop_last, rows)
    if not len(indices):
        # drop_last with len(dataset) < batch_size: no full batch can ever be
        # formed — yield nothing rather than decoding the whole set for free.
        return

    with cf.ThreadPoolExecutor(max_workers=max(1, num_workers)) as pool:
        window = max(2 * batch_size, num_workers * 2)
        futures: dict[int, cf.Future] = {}
        submitted = 0

        def submit_upto(k):
            nonlocal submitted
            while submitted < min(k, len(indices)):
                i = int(indices[submitted])
                futures[submitted] = pool.submit(dataset.get_train, i, epoch)
                submitted += 1

        submit_upto(window)
        buf: list[ClipSample] = []
        for pos in range(len(indices)):
            sample = futures.pop(pos).result()
            submit_upto(pos + 1 + window)
            buf.append(sample)
            if len(buf) == batch_size:
                yield _collate(buf)
                buf = []
        if buf and not drop_last:
            yield _collate(buf)


_END = object()


def device_prefetch(batches, device: str | torch.device = "cuda",
                    depth: int = 2) -> Iterator[dict[str, torch.Tensor]]:
    """Keep ``depth`` batches in flight to ``device`` ahead of the consumer.

    A producer thread pulls each batch from ``batches`` (on the train path
    that is where the loader gathers and collates it) and, on the card,
    copies it into freshly pinned host memory and sends it with
    ``non_blocking=True`` on a side stream, so the host work and the copies
    of the next batches overlap the steps on the current one, even when
    the consumer syncs every step. A batch is yielded only after the
    consumer's stream has been made to wait for its copy, and each tensor
    is recorded on that stream, so the caching allocator does not hand its
    memory to a later copy while a step still reads it. The pinned blocks
    are allocated per batch (the pinned allocator keeps each one until its
    copy has finished), so no copy in flight shares a buffer with a newer
    batch.

    On ``device='cpu'`` (the caller's choice) the same thread yields host
    tensors, in order. The card is the default; without one this raises
    unless the caller passes ``device='cpu'``. An error in ``batches`` is
    raised to the consumer. Closing this generator stops the thread and
    waits for it; ``batches`` itself is left for its owner to close.
    """
    dev = resolve_device(device)
    ready: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                ready.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            for b in batches:
                if copy_stream is None:
                    item = ({k: torch.as_tensor(v) for k, v in b.items()}, None)
                else:
                    with torch.cuda.stream(copy_stream):
                        out = {k: torch.as_tensor(v).pin_memory().to(dev, non_blocking=True)
                               for k, v in b.items()}
                        done = torch.cuda.Event()
                        done.record(copy_stream)
                    item = (out, done)
                if not put(item):
                    return
            put(_END)
        except BaseException as e:  # raised again on the consumer's thread
            put(e)

    producer = threading.Thread(target=produce, name="device_prefetch", daemon=True)
    producer.start()
    try:
        while True:
            item = ready.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            out, done = item
            if done is not None:
                consumer = torch.cuda.current_stream(dev)
                consumer.wait_event(done)
                for t in out.values():
                    t.record_stream(consumer)
            yield out
    finally:
        stop.set()
        producer.join()
