"""Packed pre-decoded clip dataset — the decode-once tier.

The counterpart of ``fastvideotagging_tpu/data/packed.py``; the file format
is byte-identical, so a pack written by either package reads in the other.

* ``write_pack`` decodes each video ONCE, resizes every frame to the SHIP
  geometry (``DataConfig.source_hw`` if the config pins one, else
  ``resize_hw``) with the same half-pixel bilinear the streaming loader
  uses (data/frames.py), and streams the uint8 stacks into one flat
  mmap-able file with a JSON footer index. Memory is O(chunk) even for
  long-form videos (``decode.iter_frame_chunks``).
* ``PackedDataset`` subclasses ``pipeline.ClipDataset`` and overrides only
  the two frame-access points (``_num_frames``, ``_clip_frames``), so clip
  sampling, crop/flip draws and the fault policy are by construction
  identical to the streaming loader: same (seed, epoch, index) -> same clip.

File layout (version 1, little-endian)::

    [0:8)    magic  b"FVTPACK1"
    [8:16)   uint64 absolute byte offset of the JSON index
    [16:...) frame data: per video, C-order uint8 (frames, H, W, 3)
    [index_offset:EOF) JSON index {height, width, num_tags?, videos: [
        {path, label, tags, frames, probe_frames, offset}]}

``probe_frames`` preserves the container-reported frame count the streaming
sampler draws indices from (``decode.probe_video`` — an upper bound on some
containers); ``frames`` is what actually decoded. Reads clamp to the last
stored frame, mirroring ``read_frames_at``'s fill policy.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from fastvideotagging_tpu_torch.config import DataConfig
from fastvideotagging_tpu_torch.data import decode
from fastvideotagging_tpu_torch.data.frames import _ensure_size
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.data.ucf101 import VideoRecord
from fastvideotagging_tpu_torch.utils.logging import get_logger

log = get_logger("fvt.data")

MAGIC = b"FVTPACK1"
PACK_EXT = ".fvtpack"
_HEADER = 16  # magic + uint64 index offset


def is_pack(path) -> bool:
    return isinstance(path, (str, os.PathLike)) and str(path).endswith(PACK_EXT)


class _PackWriter:
    """Low-level writer of the pack layout (one place owns the format:
    header patching, per-video index entries, JSON footer)."""

    def __init__(self, f, resize_hw, num_tags=None):
        self.f = f
        self.h, self.w = resize_hw
        self.num_tags = num_tags
        self.entries: list[dict] = []
        f.write(MAGIC)
        f.write(struct.pack("<Q", 0))  # index offset, patched by finish()

    def begin_video(self) -> int:
        """Start a video; returns the rollback position for abort_video."""
        return self.f.tell()

    def write_frames(self, frames: np.ndarray) -> None:
        if frames.shape[1:3] != (self.h, self.w):
            raise ValueError(
                f"frames {frames.shape[1:3]} != pack geometry "
                f"({self.h}, {self.w})")
        self.f.write(np.ascontiguousarray(frames, dtype=np.uint8))

    def end_video(self, start: int, path: str, label, tags,
                  frames: int, probe_frames: int) -> None:
        self.entries.append({
            "path": path, "label": label, "tags": list(tags),
            "frames": frames, "probe_frames": probe_frames,
            "offset": start - _HEADER,
        })

    def abort_video(self, start: int) -> None:
        self.f.seek(start)
        self.f.truncate()

    def finish(self) -> None:
        index_offset = self.f.tell()
        index = {"height": self.h, "width": self.w, "videos": self.entries}
        if self.num_tags is not None:
            index["num_tags"] = self.num_tags
        self.f.write(json.dumps(index).encode())
        self.f.seek(len(MAGIC))
        self.f.write(struct.pack("<Q", index_offset))


def write_pack_from_arrays(items, out_path: str, resize_hw,
                           num_tags: int | None = None) -> dict:
    """Write a pack directly from in-memory frame stacks — the prep path
    for synthetic/benchmark datasets (no codec round-trip; the production
    reader consumes it unmodified). ``items`` yields
    ``(path, label, tags, frames)`` with frames uint8 (T, H, W, 3) already
    at the pack geometry. Atomic like write_pack."""
    tmp = str(out_path) + ".tmp"
    with open(tmp, "wb") as f:
        w = _PackWriter(f, resize_hw, num_tags)
        for path, label, tags, frames in items:
            if len(frames) == 0:
                # a frames=0 entry would crash every reader (samplers need
                # >=1 frame; gather on an empty view) — same guard as
                # write_pack's max(probe, 1)
                raise ValueError(f"empty frame stack for {path!r}")
            start = w.begin_video()
            w.write_frames(frames)
            w.end_video(start, path, label, tags, len(frames), len(frames))
        w.finish()
    os.replace(tmp, out_path)
    h, wid = resize_hw
    return {"videos": len(w.entries), "skipped": 0,
            "frames": sum(e["frames"] for e in w.entries),
            "bytes": _HEADER + sum(e["frames"] for e in w.entries)
            * h * wid * 3,
            "path": str(out_path)}


def write_pack(records, out_path: str, resize_hw, root: str = "",
               chunk_size: int = 256, num_tags: int | None = None) -> dict:
    """Decode each record once -> ship-geometry uint8 stacks in a flat file.

    ``resize_hw`` must be the config's SHIP geometry (``source_hw`` if set,
    else ``resize_hw`` — see module docstring). Atomic (tmp + rename).
    Undecodable videos are skipped with a log line (the loader fault
    policy, applied once at prepare time instead of every epoch).
    ``root``: stored paths are relative to it when given, keeping packs
    relocatable. ``num_tags``: record it in the index when packing
    multi-label tag lists (enables multilabel training from the pack).
    Returns a summary dict.
    """
    h, w = resize_hw
    skipped = 0
    tmp = str(out_path) + ".tmp"
    with open(tmp, "wb") as f:
        writer = _PackWriter(f, resize_hw, num_tags)
        for rec in records:
            start = writer.begin_video()
            try:
                probe_n = max(int(decode.probe_video(rec.path)[0]), 1)
                stored = 0
                for chunk in decode.iter_frame_chunks(rec.path, chunk_size):
                    if chunk.shape[1:3] != (h, w):
                        chunk = _ensure_size(chunk, (h, w))
                    writer.write_frames(chunk)
                    stored += len(chunk)
            except decode.DecodeError as e:
                log.warning("pack: skipping undecodable %s (%s)", rec.path, e)
                writer.abort_video(start)
                skipped += 1
                continue
            rel = os.path.relpath(rec.path, root) if root else rec.path
            writer.end_video(start, rel, rec.label, rec.tags, stored, probe_n)
        writer.finish()
    os.replace(tmp, out_path)
    data_bytes = sum(e["frames"] for e in writer.entries) * h * w * 3
    return {"videos": len(writer.entries), "skipped": skipped,
            "frames": sum(e["frames"] for e in writer.entries),
            "bytes": _HEADER + data_bytes, "path": str(out_path)}


class Pack:
    """mmap-backed reader of one pack file. Thread-safe (read-only views)."""

    def __init__(self, path):
        self.path = str(path)
        with open(self.path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"not a {PACK_EXT} file: {self.path}")
            (index_offset,) = struct.unpack("<Q", f.read(8))
            f.seek(index_offset)
            index = json.loads(f.read().decode())
        self.height = int(index["height"])
        self.width = int(index["width"])
        self.num_tags = index.get("num_tags")
        self.entries = index["videos"]
        self._frame_bytes = self.height * self.width * 3
        # One flat uint8 memmap; the page cache is the only "cache" needed.
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")

    def __len__(self) -> int:
        return len(self.entries)

    def records(self, root: str = "") -> list[VideoRecord]:
        return [
            VideoRecord(path=os.path.join(root, e["path"]) if root else e["path"],
                        label=e["label"], tags=tuple(e["tags"]))
            for e in self.entries
        ]

    def video_view(self, i: int) -> np.ndarray:
        """Zero-copy (frames, H, W, 3) view of video ``i``."""
        e = self.entries[i]
        start = _HEADER + e["offset"]
        flat = self._mm[start : start + e["frames"] * self._frame_bytes]
        return flat.reshape(e["frames"], self.height, self.width, 3)

    def gather(self, i: int, frame_idx: np.ndarray) -> np.ndarray:
        """Copy out frames at ``frame_idx`` (clamped to the stored range)."""
        v = self.video_view(i)
        return np.asarray(v[np.minimum(np.asarray(frame_idx), len(v) - 1)])


class PackedDataset(ClipDataset):
    """ClipDataset over a pack file: zero FFmpeg in the train loop.

    Drop-in for ClipDataset everywhere (``evaluate``, and the loader):
    only the frame-access points differ, so sampling semantics are shared
    with the streaming loader by construction.
    """

    def __init__(self, pack, data_cfg: DataConfig, mode: str = "train",
                 num_tags: int | None = None, seed: int = 0, root: str = ""):
        self.pack = pack if isinstance(pack, Pack) else Pack(pack)
        ship = tuple(getattr(data_cfg, "source_hw", None)
                     or data_cfg.resize_hw)
        if (self.pack.height, self.pack.width) != ship:
            raise ValueError(
                f"pack geometry {self.pack.height}x{self.pack.width} != "
                f"config ship geometry {ship} (source_hw if set, else "
                f"resize_hw); re-run the prepare step (cli.prepare --pack) "
                f"at the ship geometry so packed batches stay bit-identical "
                f"to the streaming loader")
        if num_tags is None:
            num_tags = self.pack.num_tags
        elif self.pack.num_tags is None:
            raise ValueError(
                "multilabel training needs a pack written from tag lists "
                "(cli.prepare --pack-lists ... --tag-lists); this pack was "
                "written from class lists and carries no tag sets, so "
                "multihot targets would be all-zero")
        super().__init__(self.pack.records(root), data_cfg, mode=mode,
                         num_tags=num_tags, seed=seed)
        # The geometry check above makes the parent's ship_hw == the pack
        # geometry, so _clip_frames can return stored bytes unmodified.
        self._index_of = {r.path: i for i, r in enumerate(self.records)}

    def _num_frames(self, rec: VideoRecord) -> int:
        return self.pack.entries[self._index_of[rec.path]]["probe_frames"]

    def _clip_frames(self, rec: VideoRecord, frame_idx: np.ndarray) -> np.ndarray:
        return self.pack.gather(self._index_of[rec.path], frame_idx)


def open_dataset(records_or_pack, data_cfg: DataConfig, mode: str = "train",
                 num_tags: int | None = None, seed: int = 0):
    """Dataset factory: a ``.fvtpack`` path -> PackedDataset (decode-once
    tier); a list of VideoRecords -> streaming ClipDataset."""
    if is_pack(records_or_pack):
        return PackedDataset(records_or_pack, data_cfg, mode=mode,
                             num_tags=num_tags, seed=seed)
    return ClipDataset(records_or_pack, data_cfg, mode=mode,
                       num_tags=num_tags, seed=seed)
