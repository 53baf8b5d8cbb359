"""Dataset catalog / split-list parsing (a copy of
``fastvideotagging_tpu/data/ucf101.py``).

Supports the three list formats the reference family uses:

* UCF101 official ``trainlist0X.txt``:  ``ApplyEyeMakeup/v_xxx.avi 1`` —
  path + 1-based class id (test lists omit the id; then ``classInd.txt``
  provides the name->id map and the class name is the path's directory).
* Generic single-label: ``relative/path.mp4 <int label>`` (0-based).
* Multi-label tag lists: ``relative/path.mp4 tag_a,tag_b,tag_c`` [B:10].
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass(frozen=True)
class VideoRecord:
    path: str  # absolute path
    label: int | None  # single-label class id (0-based), or None
    tags: tuple[int, ...] = ()  # multi-label tag ids

    def multihot(self, num_tags: int) -> np.ndarray:
        y = np.zeros((num_tags,), dtype=np.float32)
        for t in self.tags:
            y[t] = 1.0
        return y


def load_class_index(class_ind_file: str) -> dict[str, int]:
    """Parse UCF101 ``classInd.txt`` (``1 ApplyEyeMakeup``) -> {name: 0-based id}."""
    mapping: dict[str, int] = {}
    with open(class_ind_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            idx, name = line.split()
            mapping[name] = int(idx) - 1
    return mapping


def load_video_list(
    list_file: str,
    root: str = "",
    class_index: dict[str, int] | None = None,
    ucf_style_ids: bool | None = None,
) -> list[VideoRecord]:
    """Parse a single-label split list into VideoRecords.

    ucf_style_ids: labels in the file are 1-based (UCF101 official lists).
    None -> auto: 1-based iff a class_index is given (UCF101 mode).
    """
    if ucf_style_ids is None:
        ucf_style_ids = class_index is not None
    records: list[VideoRecord] = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            rel = parts[0]
            if len(parts) >= 2:
                label = int(parts[1]) - (1 if ucf_style_ids else 0)
            elif class_index is not None:
                label = class_index[rel.split("/")[0]]
            else:
                raise ValueError(f"no label for {rel} and no class index given")
            records.append(VideoRecord(path=os.path.join(root, rel), label=label))
    return records


def load_tag_list(
    list_file: str, root: str = "", tag_index: dict[str, int] | None = None
) -> tuple[list[VideoRecord], dict[str, int]]:
    """Parse a multi-label list (``path tag_a,tag_b``) -> (records, tag_index).

    If tag_index is None it is built in first-appearance order (deterministic).
    """
    rows: list[tuple[str, list[str]]] = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tags = parts[1].split(",") if len(parts) >= 2 and parts[1] else []
            rows.append((parts[0], tags))
    if tag_index is None:
        tag_index = {}
        for _, tags in rows:
            for t in tags:
                if t not in tag_index:
                    tag_index[t] = len(tag_index)
    records = [
        VideoRecord(
            path=os.path.join(root, rel),
            label=None,
            tags=tuple(tag_index[t] for t in tags),
        )
        for rel, tags in rows
    ]
    return records, tag_index
