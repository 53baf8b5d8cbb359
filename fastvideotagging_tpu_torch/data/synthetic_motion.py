"""Hard synthetic MOTION-classification dataset (a copy of
``fastvideotagging_tpu/data/synthetic_motion.py``).

The easy synthetic set (data/synthetic.py) leaks class identity through
appearance (class-colored background), so any per-frame classifier solves
it. This generator makes class identity a pure function of MOTION:

  class = (direction theta in 16 compass angles,
           speed in {1.0, 2.2} px/frame,
           trajectory in {straight, sine})           -> up to 64 classes

Every video shows the SAME white square on a per-video random textured
background, starting at a per-video random position. A single frame is
therefore class-uninformative by construction (tests assert frame-0 of two
different classes is pixel-identical given the same video seed); separating
22.5-degree-apart directions and 2.2x speeds requires integrating motion
across frames — the capability UCF101 top-1 actually exercises, stood in
for offline (BASELINE.json "UCF101 top-1 parity" needs the real data).

Determinism: every pixel derives from Philox(seed, class, instance) — the
same draw-order discipline as the rest of the data layer.
"""

from __future__ import annotations

import os

import numpy as np

from fastvideotagging_tpu_torch.data.synthetic import write_video

N_ANGLES = 16
SPEEDS = (1.0, 2.2)
PATTERNS = ("straight", "sine")
MAX_CLASSES = N_ANGLES * len(SPEEDS) * len(PATTERNS)  # 64


def class_params(label: int) -> dict:
    """label -> motion parameters (the ONLY class-dependent quantities)."""
    if not 0 <= label < MAX_CLASSES:
        raise ValueError(f"label {label} out of range [0, {MAX_CLASSES})")
    angle_i = label % N_ANGLES
    speed_i = (label // N_ANGLES) % len(SPEEDS)
    pattern_i = label // (N_ANGLES * len(SPEEDS))
    return {
        "angle": 2.0 * np.pi * angle_i / N_ANGLES,
        "speed": SPEEDS[speed_i],
        "pattern": PATTERNS[pattern_i],
    }


def make_motion_frames(
    label: int,
    instance: int,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
    square: int = 7,
) -> np.ndarray:
    """RGB uint8 (T, H, W, 3). Appearance is label-independent: the
    background texture and start position are drawn from a generator keyed
    ONLY by (seed, instance) — two labels with the same (seed, instance)
    share frame 0 exactly (when their trajectories coincide at t=0)."""
    p = class_params(label)
    rng = np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, 0, instance]))
    # static textured background, label-independent
    bg = rng.integers(20, 90, size=(height, width, 3), dtype=np.int64)
    x0 = float(rng.uniform(0, width))
    y0 = float(rng.uniform(0, height))

    vx = np.cos(p["angle"]) * p["speed"]
    vy = np.sin(p["angle"]) * p["speed"]
    # unit vector perpendicular to the motion, for the sine trajectory
    nx, ny = -np.sin(p["angle"]), np.cos(p["angle"])
    amp = 3.0 if p["pattern"] == "sine" else 0.0
    omega = 2.0 * np.pi / 12.0  # one oscillation per 12 frames

    yy, xx = np.mgrid[0:height, 0:width]
    frames = np.empty((num_frames, height, width, 3), dtype=np.uint8)
    half = square / 2.0
    for t in range(num_frames):
        off = amp * np.sin(omega * t)
        px = (x0 + vx * t + nx * off) % width
        py = (y0 + vy * t + ny * off) % height
        # toroidal distance so the square wraps cleanly at the borders
        dx = np.minimum(np.abs(xx - px), width - np.abs(xx - px))
        dy = np.minimum(np.abs(yy - py), height - np.abs(yy - py))
        mask = (dx < half) & (dy < half)
        frame = bg.copy()
        frame[mask] = 235
        frames[t] = np.clip(frame, 0, 255).astype(np.uint8)
    return frames


def make_multi_motion_frames(
    labels: list[int],
    instance: int,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
    square: int = 7,
) -> np.ndarray:
    """Multi-object variant: one square per label, independent trajectories.

    The multi-LABEL analog (tagging): a video carries the set of motion
    classes present. Appearance stays label-blind — each object's start
    position and brightness come from the (seed, instance)-keyed generator,
    in a fixed draw order independent of the label values.
    """
    rng = np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, 1, instance]))
    bg = rng.integers(20, 90, size=(height, width, 3), dtype=np.int64)
    starts = [(float(rng.uniform(0, width)), float(rng.uniform(0, height)))
              for _ in labels]
    brightness = [int(rng.integers(170, 250)) for _ in labels]

    params = [class_params(lb) for lb in labels]
    yy, xx = np.mgrid[0:height, 0:width]
    frames = np.empty((num_frames, height, width, 3), dtype=np.uint8)
    half = square / 2.0
    omega = 2.0 * np.pi / 12.0
    for t in range(num_frames):
        frame = bg.copy()
        for (x0, y0), b, p in zip(starts, brightness, params):
            vx = np.cos(p["angle"]) * p["speed"]
            vy = np.sin(p["angle"]) * p["speed"]
            nx, ny = -np.sin(p["angle"]), np.cos(p["angle"])
            off = (3.0 if p["pattern"] == "sine" else 0.0) * np.sin(omega * t)
            px = (x0 + vx * t + nx * off) % width
            py = (y0 + vy * t + ny * off) % height
            dx = np.minimum(np.abs(xx - px), width - np.abs(xx - px))
            dy = np.minimum(np.abs(yy - py), height - np.abs(yy - py))
            frame[(dx < half) & (dy < half)] = b
        frames[t] = np.clip(frame, 0, 255).astype(np.uint8)
    return frames


def iter_tagging_videos(
    num_classes: int = 24,
    objects_per_video: int = 2,
    train_videos: int = 600,
    eval_videos: int = 150,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
):
    """The videos of ``make_tagging_dataset`` in its order, in memory:
    yields ``(split, relative path, tag ids, frames)``, split 'train' or
    'eval'."""
    if num_classes > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes")
    pick = np.random.Generator(
        np.random.Philox(key=np.uint64(seed), counter=[0, 0, 2, 0]))
    for i in range(train_videos + eval_videos):
        labels = sorted(pick.choice(num_classes, size=objects_per_video,
                                    replace=False).tolist())
        frames = make_multi_motion_frames(
            labels, instance=i, num_frames=num_frames, height=height,
            width=width, seed=seed)
        yield ("train" if i < train_videos else "eval"), f"tagged/v_{i:04d}.mp4", labels, frames


def make_tagging_dataset(
    root: str,
    num_classes: int = 24,
    objects_per_video: int = 2,
    train_videos: int = 600,
    eval_videos: int = 150,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
) -> tuple[str, str]:
    """Multi-label tagging dataset: each video shows `objects_per_video`
    distinct motion classes; the label set is its tags. List format matches
    data/ucf101.load_tag_list (``path tag_a,tag_b``). Returns
    (train_list, eval_list)."""
    if num_classes > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes")
    os.makedirs(root, exist_ok=True)
    lines = {"train": [], "eval": []}
    os.makedirs(os.path.join(root, "tagged"), exist_ok=True)
    for split, rel, labels, frames in iter_tagging_videos(
            num_classes, objects_per_video, train_videos, eval_videos,
            num_frames, height, width, seed):
        write_video(os.path.join(root, rel), frames)
        tags = ",".join(f"motion_{k:02d}" for k in labels)
        lines[split].append(f"{rel} {tags}")
    train_list = os.path.join(root, "tag_train_list.txt")
    eval_list = os.path.join(root, "tag_eval_list.txt")
    # Consumers should pass tag_index() to load_tag_list so the class->id
    # mapping is fixed regardless of tag appearance order in the lists.
    with open(train_list, "w") as f:
        f.write("\n".join(lines["train"]) + "\n")
    with open(eval_list, "w") as f:
        f.write("\n".join(lines["eval"]) + "\n")
    return train_list, eval_list


def tag_index(num_classes: int = 24) -> dict[str, int]:
    """Canonical tag-name -> id mapping for make_tagging_dataset lists."""
    return {f"motion_{k:02d}": k for k in range(num_classes)}


def iter_motion_videos(
    num_classes: int = 50,
    train_per_class: int = 16,
    eval_per_class: int = 4,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
):
    """The videos of ``make_motion_dataset`` in its order, in memory: yields
    ``(split, relative path, label, frames)``, split 'train' or 'eval'."""
    if num_classes > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes ({num_classes} asked)")
    for k in range(num_classes):
        for i in range(train_per_class + eval_per_class):
            frames = make_motion_frames(
                k, instance=i, num_frames=num_frames, height=height,
                width=width, seed=seed)
            yield (("train" if i < train_per_class else "eval"),
                   f"motion_{k:02d}/v_{k:02d}_{i:03d}.mp4", k, frames)


def make_motion_dataset(
    root: str,
    num_classes: int = 50,
    train_per_class: int = 16,
    eval_per_class: int = 4,
    num_frames: int = 48,
    height: int = 48,
    width: int = 48,
    seed: int = 0,
) -> tuple[str, str]:
    """Write the dataset to disk; returns (train_list, eval_list) paths.

    Eval instances use a disjoint instance-id range, so eval videos have
    start positions / backgrounds never seen in training.
    """
    if num_classes > MAX_CLASSES:
        raise ValueError(f"at most {MAX_CLASSES} classes ({num_classes} asked)")
    os.makedirs(root, exist_ok=True)
    lines = {"train": [], "eval": []}
    for k in range(num_classes):
        os.makedirs(os.path.join(root, f"motion_{k:02d}"), exist_ok=True)
    for split, rel, k, frames in iter_motion_videos(
            num_classes, train_per_class, eval_per_class, num_frames, height,
            width, seed):
        write_video(os.path.join(root, rel), frames)
        lines[split].append(f"{rel} {k}")
    train_list = os.path.join(root, "train_list.txt")
    eval_list = os.path.join(root, "eval_list.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(lines["train"]) + "\n")
    with open(eval_list, "w") as f:
        f.write("\n".join(lines["eval"]) + "\n")
    return train_list, eval_list
