"""Device-resident pack cache: pay the host-to-device copy once per job, not
once per step (the counterpart of
``fastvideotagging_tpu/data/device_cache.py``).

* ``DeviceFrameCache`` copies the whole ship-geometry pack onto the device
  once, as one flat ``(total_frames, H, W, 3)`` uint8 tensor. A pack that
  does not fit raises before the copy: on the card the budget is a share of
  the free device memory (``torch.cuda.mem_get_info``), so a UCF101 pack at
  128x171 (about 160 GB) raises instead of failing inside the allocator.
* ``train_index_batches`` yields per-step batches that carry only the
  sampling decisions: global frame-row indices (B, T) int32, labels and the
  crop and flip draws. They come from ``ClipDataset.get_train_spec``, the
  draw path of the streaming loader, under the same Philox (seed, epoch)
  permutation as ``pipeline.train_batches``, so the gathered batch is
  bitwise the streaming loader's.
* The train step gathers ``cache[rows]`` on the device (one gather over the
  leading axis; train/loop.py ``make_train_step(device_cache=True)``) and
  runs the usual preprocess. The host does index arithmetic only.

In a data-parallel job (``build_cache(mesh=...)``) each rank holds the
whole pack on its own card and gathers its own rows of every batch
(``train_index_batches(rows=...)``).
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.data.packed import _HEADER, Pack, PackedDataset
from fastvideotagging_tpu_torch.data.pipeline import epoch_order
from fastvideotagging_tpu_torch.parallel.mesh import check_mesh
from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.data")

# Host-side budget (the device is the CPU): the JAX package's default.
DEFAULT_HBM_BUDGET_BYTES = 12 << 30
# On the card: at most this share of the device memory free when the cache
# is built; the rest stays for the train step (about 21 GB for
# r2plus1d_18 at B = 32, 16x112x112).
DEVICE_FREE_SHARE = 0.5
# Frames copied to the device per host-to-device copy while the cache is built.
_COPY_CHUNK_BYTES = 256 << 20


def _default_budget(device: torch.device) -> int:
    """The default cache budget on ``device``."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return int(free * DEVICE_FREE_SHARE)
    return DEFAULT_HBM_BUDGET_BYTES


class DeviceFrameCache:
    """One flat uint8 frame tensor on the device, with host-side row index
    arithmetic."""

    def __init__(self, pack: Pack, device: str | torch.device = "cuda",
                 budget_bytes: int | None = None):
        dev = resolve_device(device)
        self.pack = pack
        fb = pack._frame_bytes
        counts = np.asarray([e["frames"] for e in pack.entries], np.int64)
        offsets = np.asarray([e["offset"] for e in pack.entries], np.int64)
        if np.any(offsets % fb):
            raise ValueError("pack offsets are not frame-aligned")
        self.row_offset = offsets // fb  # first global row of each video
        self.frames_count = counts
        total_rows = int((offsets[-1] + counts[-1] * fb) // fb) if len(counts) else 0
        nbytes = total_rows * fb
        budget = _default_budget(dev) if budget_bytes is None else budget_bytes
        if nbytes > budget:
            raise ValueError(
                f"pack holds {nbytes / 2**30:.1f} GiB of frames > device "
                f"cache budget {budget / 2**30:.1f} GiB; use the "
                f"streaming packed loader (cache_on_device=False)")
        flat = pack._mm[_HEADER:_HEADER + nbytes].reshape(
            total_rows, pack.height, pack.width, 3)
        self.frames = torch.empty(tuple(flat.shape), dtype=torch.uint8, device=dev)
        step = max(1, _COPY_CHUNK_BYTES // fb)
        for r in range(0, total_rows, step):
            # a host copy of one chunk of the mmap (the map is read-only)
            self.frames[r:r + step].copy_(torch.from_numpy(np.array(flat[r:r + step])))
        self.nbytes = nbytes
        log.info("device cache: staged %d frames (%.1f MiB) on %s",
                 total_rows, nbytes / 2**20, dev)

    def global_rows(self, rec_i: int, frame_idx: np.ndarray) -> np.ndarray:
        """Video-local frame indices -> global cache rows, with the pack
        reader's clamp-to-last-stored-frame fill policy."""
        last = self.frames_count[rec_i] - 1
        return (self.row_offset[rec_i]
                + np.minimum(np.asarray(frame_idx, np.int64), last))


def train_index_batches(
    dataset: PackedDataset,
    cache: DeviceFrameCache,
    batch_size: int,
    epoch: int,
    drop_last: bool = True,
    rows: list[int] | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Index-only training batches for one epoch (no pixel IO at all).

    The shuffle permutation, drop-last and ``rows`` semantics are
    ``pipeline.train_batches``'; each yielded dict carries ``rows`` (B, T)
    int32 global cache rows in place of ``frames``. No worker pool: a
    sample is a handful of Philox draws.
    """
    if not isinstance(dataset, PackedDataset):
        raise TypeError(
            "device cache requires a PackedDataset (run cli.prepare --pack); "
            "streaming datasets re-decode per epoch and cannot be staged")
    if dataset.cfg.host_crop:
        raise ValueError(
            "host_crop only exists to cut per-step host-to-device bytes; the "
            "device cache ships no frames at all — disable one of the two")
    indices, batch_size = epoch_order(dataset, batch_size, epoch, drop_last, rows)
    multihot = dataset.num_tags is not None
    buf: list[tuple] = []
    for pos in range(len(indices)):
        i = int(indices[pos])
        rec_i, frame_idx, top, left, flip = dataset.get_train_spec(i, epoch)
        rec = dataset.records[rec_i]
        buf.append((cache.global_rows(rec_i, frame_idx),
                    rec.label if rec.label is not None else -1,
                    rec.multihot(dataset.num_tags) if multihot else None,
                    top, left, flip))
        if len(buf) == batch_size:
            yield _collate_index(buf)
            buf = []
    if buf and not drop_last:
        yield _collate_index(buf)


def _collate_index(samples: list[tuple]) -> dict[str, np.ndarray]:
    rows, labels, hots, tops, lefts, flips = zip(*samples)
    batch = {
        "rows": np.stack(rows).astype(np.int32),
        "labels": np.asarray(labels, np.int32),
        "crop_tops": np.asarray(tops, np.int32),
        "crop_lefts": np.asarray(lefts, np.int32),
        "flips": np.asarray(flips, bool),
        "weights": np.ones((len(samples),), np.float32),
    }
    if hots[0] is not None:
        batch["multihot"] = np.stack(hots)
    return batch


def replicated_sharding(mesh=None):
    """Where a replicated cache lives: None (the caller's device) for
    ``mesh=None``; on a data-parallel mesh, this rank's device (each rank
    holds the whole pack on its own card, the reference's replicated
    sharding, and gathers its own rows there)."""
    return None if check_mesh(mesh) is None else mesh.device


def build_cache(dataset: PackedDataset, mesh=None, budget_bytes: int | None = None,
                device: str | torch.device = "cuda") -> DeviceFrameCache:
    """The dataset's pack on ``device`` (the card unless the caller asks for
    the CPU), or with ``mesh`` on this rank's device."""
    return DeviceFrameCache(dataset.pack, device=replicated_sharding(mesh) or device,
                            budget_bytes=budget_bytes)
