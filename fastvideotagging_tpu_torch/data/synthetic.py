"""Synthetic video for tests and the chip smoke run.

A copy of ``fastvideotagging_tpu/data/synthetic.py`` (``make_frames``,
``write_video``, ``make_dataset``): deterministic frames whose content
encodes a class id (a square moving with a class-derived direction and
speed over a class-colored background), made from a seed with numpy's
Philox. cv2 is needed only to write ``.mp4`` files; without it,
``write_video`` and ``make_dataset`` raise, and frames go into packs
(data/packed.py::write_pack_from_arrays) instead.
"""

from __future__ import annotations

import os

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def make_frames(
    label: int, num_frames: int = 32, height: int = 64, width: int = 64, seed: int = 0
) -> np.ndarray:
    """Deterministic RGB uint8 frames (num_frames, H, W, 3) for a class id."""
    rng = np.random.Generator(np.random.Philox(key=np.uint64(seed + 7919 * label)))
    bg = rng.integers(0, 80, size=(3,), dtype=np.int64)
    fg = 255 - bg
    angle = (label % 8) * (2 * np.pi / 8)
    speed = 1.0 + (label % 4)
    size = max(height // 8, 4)
    cx, cy = width / 2.0, height / 2.0
    frames = np.empty((num_frames, height, width, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:height, 0:width]
    for t in range(num_frames):
        px = cx + np.cos(angle) * speed * (t - num_frames / 2)
        py = cy + np.sin(angle) * speed * (t - num_frames / 2)
        px = px % width
        py = py % height
        mask = (np.abs(xx - px) < size) & (np.abs(yy - py) < size)
        frame = np.broadcast_to(bg, (height, width, 3)).copy()
        frame[mask] = fg
        noise = rng.integers(-10, 11, size=frame.shape)
        frames[t] = np.clip(frame + noise, 0, 255).astype(np.uint8)
    return frames


def write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> None:
    """Write RGB uint8 (T, H, W, 3) frames to an mp4 via cv2.VideoWriter."""
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("opencv-python is required to write videos")
    t, h, w, _ = frames.shape
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not writer.isOpened():
        raise RuntimeError(f"cv2.VideoWriter failed to open {path}")
    try:
        for i in range(t):
            writer.write(cv2.cvtColor(frames[i], cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def make_dataset(
    root: str,
    num_classes: int = 4,
    videos_per_class: int = 2,
    num_frames: int = 32,
    height: int = 64,
    width: int = 64,
    seed: int = 0,
) -> str:
    """Generate a tiny single-label dataset on disk. Returns the list-file path.

    Layout mirrors UCF101: ``root/class_k/v_k_i.mp4`` plus ``list.txt`` with
    ``relative/path label`` rows (0-based labels).
    """
    os.makedirs(root, exist_ok=True)
    lines = []
    for k in range(num_classes):
        cls_dir = os.path.join(root, f"class_{k}")
        os.makedirs(cls_dir, exist_ok=True)
        for i in range(videos_per_class):
            frames = make_frames(k, num_frames, height, width, seed=seed + i)
            rel = f"class_{k}/v_{k}_{i}.mp4"
            write_video(os.path.join(root, rel), frames)
            lines.append(f"{rel} {k}")
    list_path = os.path.join(root, "list.txt")
    with open(list_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return list_path
