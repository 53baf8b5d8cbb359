"""Hard accuracy benchmark: a zoo backbone (r2plus1d_18 by default) trained
from scratch on 50 confusable motion classes (the port of the JAX package's
``benchmarks/accuracy_hard.py``, with its configs field for field).

Class identity is pure motion (direction x speed x trajectory; appearance is
class-blind by construction, data/synthetic_motion.py), so a per-frame model
scores at chance and a spatiotemporal backbone is needed. Dataset, sampler
draws and init all come from the seed.

    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard --source pack \
        --epochs 60 --out fastvideotagging_tpu_torch/benchmarks/ACCURACY_HARD.json
    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard --source pack \
        --multilabel --out fastvideotagging_tpu_torch/benchmarks/ACCURACY_TAGGING.json

Each other family's record (``ACCURACY_HARD_<FAMILY>.json``) takes the JAX
record's recipe, e.g. ``--model s3d --epochs 120 --clip-grad-norm 1.0`` or
``--model c3d --clip-len 16 --stride 1 --clip-grad-norm 1.0 --lr 0.03
--epochs 120`` (tests/test_torch_port_accuracy_families.py lists them all).
A record counts the launches of K1-K3 over training and evaluation: the
families built on SpatialConv / TemporalConv (R(2+1)D, P3D, S3D) launch
them; C3D, I3D, R3D, MC3 and SlowFast, whose convs are all layers.Conv3D,
do not.

``--source`` picks how the videos reach the loader, the caller's choice:
``mp4`` (the default) writes and decodes ``.mp4`` files as the JAX file
does (needs cv2); ``mp4pack`` takes the same decoded pixels from packs:
the set written as ``.mp4`` (cv2's mp4v codec, ``make_motion_dataset``)
and each video decoded once into ``train.fvtpack`` / ``eval.fvtpack``
(``write_pack``; the resize at the 48x48 ship size is the identity), the
pixels the JAX package's ``ClipDataset`` reads; ``pack`` writes the
generator's raw frames straight into packs (``write_pack_from_arrays``),
with no codec round trip, so its pixels are not the reference's: over the
50-class set the codec (4:2:0 chroma, block artifacts) moves a value by
12.83 levels on average (``--pixel-gap``; PERF.md, "pixels").

``mp4pack`` with ``--pack-dir DIR`` reads the two packs from DIR, which is
how a machine without cv2 (the card's) gets them; each pack's index names
the set (classes, seed, geometry) and the cv2 version that wrote it, and a
pack that is missing or names another set raises. Without ``--pack-dir``
the packs are written under the run's root (needs cv2). To write them once
on a machine with cv2:

    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard --write-packs DIR

The result JSON records the route and the card's name and power limit.
Trains and evaluates on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.config import (
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from fastvideotagging_tpu_torch.data import synthetic_motion
from fastvideotagging_tpu_torch.data.packed import (
    Pack,
    PackedDataset,
    write_pack,
    write_pack_from_arrays,
)
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.data.ucf101 import load_tag_list, load_video_list
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.ops import conv2plus1d
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.metrics import (
    mean_average_precision,
    per_tag_precision_recall,
    topk_accuracy,
)

SOURCES = ("mp4", "pack", "mp4pack")
# mp4pack's two packs in a pack directory
MP4PACK_FILES = {"train": "train.fvtpack", "eval": "eval.fvtpack"}
# the videos' frame size (data/synthetic_motion.py's default): the packs'
# geometry and the configs' source_hw
VIDEO_HW = (48, 48)
# the training kernels whose launches a record counts: K1, K2 (forward and
# dx) and K3 (the temporal weight gradient)
TRAIN_KERNELS = ("spatial_conv", "temporal_conv", "temporal_dw")
NO_KERNEL_SITES = ("no SpatialConv / TemporalConv on this family's path: every conv is "
                   "layers.Conv3D (F.conv3d), so K1-K3 have no site")


class LaunchCounter:
    """K1-K3 launches of the phases of one run: ``with counter("fit"):``
    keeps the launches made inside the block under that name. It reads the
    process-wide counts before and after and resets nothing, so a count
    taken around it still sees every launch."""

    def __init__(self):
        self.counts: dict[str, dict[str, int]] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        before = {k: conv2plus1d.launch_counts[k] for k in TRAIN_KERNELS}
        try:
            yield
        finally:
            self.counts[phase] = {k: conv2plus1d.launch_counts[k] - before[k]
                                  for k in TRAIN_KERNELS}

    def record(self, dev: torch.device) -> dict:
        """The record's launch fields: the counts by phase, and what zero
        counts on the card mean (a family with no SpatialConv /
        TemporalConv runs every conv on F.conv3d, SlowFast's (2+1)D blocks
        too; the CPU launches no kernel at all)."""
        out = {"launches": self.counts}
        if not any(n for c in self.counts.values() for n in c.values()):
            out["launches_note"] = (
                NO_KERNEL_SITES if dev.type == "cuda" else "the CPU route launches no kernel")
        return out


def hard_config(num_classes: int = 50, epochs: int = 40, batch_size: int = 64,
                base_lr: float = 0.05, seed: int = 0, model_name: str = "r2plus1d_18",
                clip_grad_norm: float = 0.0, norm: str = "batch", clip_len: int = 8,
                stride: int = 2, dropout: float = 0.0, kernels: str = "cuda") -> ExperimentConfig:
    """The single-label run's config: the JAX file's ``run``, field for field
    (``kernels`` is the port's own: 'torch' runs the same recipe off the hand
    kernels)."""
    return ExperimentConfig(
        # the real backbone at a reduced input resolution (8x32x32)
        model=ModelConfig(name=model_name, num_classes=num_classes,
                          dropout=dropout, norm=norm, kernels=kernels),
        data=DataConfig(source_hw=VIDEO_HW, resize_hw=(40, 40),
                        crop_hw=(32, 32), random_flip=False,
                        num_workers=8, cache_mb=1024,  # the whole set, ~300 MiB
                        sampler=ClipSamplerConfig(clip_len=clip_len,
                                                  stride=stride,
                                                  eval_mode="uniform",
                                                  num_eval_clips=4)),
        train=TrainConfig(batch_size=batch_size, num_epochs=epochs,
                          base_lr=base_lr, weight_decay=1e-4,
                          lr_steps=(int(epochs * 0.6), int(epochs * 0.85)),
                          warmup_epochs=2, seed=seed, log_every=10,
                          clip_grad_norm=clip_grad_norm,
                          checkpoint_dir=""),  # saves would dominate tiny epochs
        parallel=ParallelConfig(data_parallel=1, model_parallel=1),
    )


def tagging_config(num_classes: int = 24, epochs: int = 90, batch_size: int = 64,
                   base_lr: float = 0.08, seed: int = 0) -> ExperimentConfig:
    """The multi-label run's config: the JAX file's ``run_multilabel``, field
    for field (``kernels`` takes the port's default)."""
    return ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=num_classes,
                          multilabel=True, dropout=0.0),
        data=DataConfig(source_hw=VIDEO_HW, resize_hw=(40, 40),
                        crop_hw=(32, 32), random_flip=False,
                        num_workers=8, cache_mb=1024,
                        sampler=ClipSamplerConfig(clip_len=8, stride=2,
                                                  eval_mode="uniform",
                                                  num_eval_clips=4)),
        train=TrainConfig(batch_size=batch_size, num_epochs=epochs,
                          base_lr=base_lr, weight_decay=1e-4,
                          lr_steps=(int(epochs * 0.6), int(epochs * 0.85)),
                          warmup_epochs=2, seed=seed, log_every=10,
                          checkpoint_dir=""),
        parallel=ParallelConfig(data_parallel=1, model_parallel=1),
    )


def _packs(root: str, videos, num_tags: int | None,
           hw: tuple[int, int] = VIDEO_HW) -> tuple[str, str]:
    """Write ``videos`` ((split, path, label or tag ids, frames), frames of
    size ``hw``) into a train and an eval pack under ``root``; returns their
    paths."""
    paths = {split: os.path.join(root, f"{split}.fvtpack") for split in ("train", "eval")}
    split_items = {"train": [], "eval": []}
    for split, rel, target, frames in videos:
        if num_tags is None:
            split_items[split].append((rel, int(target), (), frames))
        else:
            split_items[split].append((rel, None, tuple(int(t) for t in target), frames))
    for split, items in split_items.items():
        write_pack_from_arrays(items, paths[split], hw, num_tags=num_tags)
    return paths["train"], paths["eval"]


def add_pack_dir(p: argparse.ArgumentParser) -> None:
    p.add_argument("--pack-dir", default=None,
                   help="--source mp4pack: the directory of train.fvtpack / eval.fvtpack "
                        "(--write-packs); without it they are written (needs cv2)")


def _check_source(source: str) -> None:
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")


def motion_set(num_classes: int, seed: int, **geometry) -> dict:
    """What names a motion set: the class count, the seed and
    ``make_motion_dataset``'s geometry (its defaults where not given)."""
    params = inspect.signature(synthetic_motion.make_motion_dataset).parameters
    full = {k: p.default for k, p in params.items() if k not in ("root", "num_classes", "seed")}
    unknown = set(geometry) - set(full)
    if unknown:
        raise ValueError(f"unknown geometry {sorted(unknown)}")
    return {"set": "synthetic_motion", "num_classes": num_classes, "seed": seed,
            **full, **geometry, "codec": "mp4v"}


def write_mp4_packs(pack_dir: str, num_classes: int, seed: int, **geometry) -> dict:
    """Write the motion set as ``.mp4`` (mp4v, ``make_motion_dataset``) in a
    temporary directory and decode each video once into ``pack_dir``'s
    ``train.fvtpack`` / ``eval.fvtpack`` (``write_pack``, the ship size the
    set's frame size); each index names the set and the cv2 version. Needs
    cv2. -> {split: path}."""
    import cv2

    meta = {**motion_set(num_classes, seed, **geometry), "cv2": cv2.__version__}
    hw = (meta["height"], meta["width"])
    os.makedirs(pack_dir, exist_ok=True)
    paths = {split: os.path.join(pack_dir, name) for split, name in MP4PACK_FILES.items()}
    with tempfile.TemporaryDirectory(prefix="fvt_mp4pack_") as root:
        lists = synthetic_motion.make_motion_dataset(root, num_classes=num_classes, seed=seed,
                                                     **geometry)
        for path, lst in zip(paths.values(), lists):
            write_pack(load_video_list(lst, root=root), path, hw, root=root, meta=meta)
    return paths


def mp4pack_paths(pack_dir: str, num_classes: int, seed: int, **geometry) -> tuple[str, str]:
    """The (train, eval) packs of ``pack_dir``, after checking that each
    holds the set asked for, decoded from mp4v by a cv2 that names itself:
    raises ``FileNotFoundError`` for a missing pack, ``ValueError`` for one
    of another set (nothing falls back to raw frames)."""
    want = motion_set(num_classes, seed, **geometry)
    paths = {split: os.path.join(pack_dir, name) for split, name in MP4PACK_FILES.items()}
    for split, path in paths.items():
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no mp4pack {split} pack at {path}; write the pair on a machine with cv2 "
                f"(accuracy_hard --write-packs DIR) and pass DIR as --pack-dir")
        meta = Pack(path).meta or {}
        got = {k: meta.get(k) for k in want}
        if got != want or not meta.get("cv2"):
            raise ValueError(f"{path} holds another set: {meta} (wanted {want} and the "
                             f"cv2 version that wrote it)")
    return paths["train"], paths["eval"]


def pixel_gap(pack_dir: str, num_classes: int = 50, seed: int = 0, **geometry) -> dict:
    """What the mp4v round trip does to the motion set's pixels: the decoded
    frames of ``pack_dir``'s mp4pack pair against the generator's raw frames,
    over every video: the mean |difference| a value, its 99th percentile and
    largest value, the values' std before and after, and the mean |change|
    between consecutive frames before and after."""
    train, ev = mp4pack_paths(pack_dir, num_classes, seed, **geometry)
    packs, seen = {"train": Pack(train), "eval": Pack(ev)}, {"train": 0, "eval": 0}
    hist = np.zeros(256, np.int64)
    acc = dict.fromkeys(("raw", "raw2", "dec", "dec2", "raw_tt", "dec_tt"), 0.0)
    n = n_tt = 0
    for split, _, _, frames in synthetic_motion.iter_motion_videos(num_classes, seed=seed,
                                                                   **geometry):
        raw = frames.astype(np.int64)
        dec = packs[split].video_view(seen[split]).astype(np.int64)
        seen[split] += 1
        if dec.shape != raw.shape:
            raise ValueError(f"decoded {dec.shape} against raw {raw.shape}")
        hist += np.bincount(np.abs(dec - raw).ravel(), minlength=256)
        for key, v in (("raw", raw), ("dec", dec)):
            acc[key] += v.sum()
            acc[key + "2"] += (v * v).sum()
            acc[key + "_tt"] += np.abs(np.diff(v, axis=0)).sum()
        n += raw.size
        n_tt += raw[1:].size
    cum = np.cumsum(hist)

    def std(key):
        return float(np.sqrt(acc[key + "2"] / n - (acc[key] / n) ** 2))

    return {"videos": sum(seen.values()), "values": n,
            "mean_abs_diff": float((hist * np.arange(256)).sum() / n),
            "p99_abs_diff": int(np.searchsorted(cum, 0.99 * n)),
            "max_abs_diff": int(np.nonzero(hist)[0].max()),
            "std_raw": std("raw"), "std_decoded": std("dec"),
            "frame_to_frame_raw": acc["raw_tt"] / n_tt,
            "frame_to_frame_decoded": acc["dec_tt"] / n_tt,
            "meta": packs["train"].meta}


def motion_sources(root: str, source: str, num_classes: int, seed: int,
                   pack_dir: str | None = None, **geometry):
    """The motion set's (train, eval) sources under ``root``: lists of video
    records (``mp4``: written and decoded) or pack paths (``pack``: raw
    frames; ``mp4pack``: decoded ``.mp4``, read from ``pack_dir`` where it
    is given, else written under ``root``). ``geometry``:
    ``iter_motion_videos``' videos per class, frames and frame size."""
    _check_source(source)
    if source == "mp4":
        train_list, eval_list = synthetic_motion.make_motion_dataset(
            root, num_classes=num_classes, seed=seed, **geometry)
        return load_video_list(train_list, root=root), load_video_list(eval_list, root=root)
    if source == "mp4pack":
        if pack_dir is None:
            pack_dir = root
            write_mp4_packs(pack_dir, num_classes, seed, **geometry)
        return mp4pack_paths(pack_dir, num_classes, seed, **geometry)
    hw = (geometry.get("height", VIDEO_HW[0]), geometry.get("width", VIDEO_HW[1]))
    return _packs(root, synthetic_motion.iter_motion_videos(
        num_classes, seed=seed, **geometry), None, hw)


def eval_dataset(src, data: DataConfig, source: str, num_tags: int | None = None):
    """The eval-mode dataset over ``motion_sources``' ``src``."""
    if source == "mp4":
        return ClipDataset(src, data, mode="eval", num_tags=num_tags)
    return PackedDataset(src, data, mode="eval", num_tags=num_tags)


def num_videos(src, source: str) -> int:
    return len(src) if source == "mp4" else len(Pack(src))


def run(num_classes: int = 50, epochs: int = 40, batch_size: int = 64,
        base_lr: float = 0.05, seed: int = 0, root: str | None = None,
        keep_data: bool = False, model_name: str = "r2plus1d_18",
        clip_grad_norm: float = 0.0, norm: str = "batch",
        clip_len: int = 8, stride: int = 2, dropout: float = 0.0,
        source: str = "mp4", device: str | torch.device = "cuda",
        pack_dir: str | None = None) -> dict:
    _check_source(source)
    dev = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="fvt_hard_")
    t0 = time.time()
    train_src, eval_src = motion_sources(root, source, num_classes, seed, pack_dir)
    gen_s = time.time() - t0

    cfg = hard_config(num_classes, epochs, batch_size, base_lr, seed, model_name,
                      clip_grad_norm, norm, clip_len, stride, dropout)
    counter = LaunchCounter()
    t0 = time.time()
    with counter("fit"):
        state = fit(cfg, train_src, device=dev)
    train_s = time.time() - t0

    ds = eval_dataset(eval_src, cfg.data, source)
    t0 = time.time()
    with counter("eval"):
        scores, records = evaluate_video_scores(state.model, state.model.state_dict(), ds,
                                                cfg, clip_batch=8)
    eval_s = time.time() - t0
    labels = np.asarray([r.label for r in records])
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    result = {
        "benchmark": "hard_synthetic_motion_50",
        "model": model_name,
        "num_classes": num_classes,
        "train_videos": num_videos(train_src, source),
        "eval_videos": len(records),
        "clip_geometry": f"{clip_len}x32x32 (stride {stride}) "
                         "from 48x48x48 videos",
        "epochs": epochs,
        "steps": int(state.step),
        "seed": seed,
        "top1": round(topk_accuracy(scores, labels, k=1), 4),
        "top5": round(topk_accuracy(scores, labels, k=5), 4),
        "mAP": round(mean_average_precision(scores, onehot), 4),
        "chance_top1": round(1.0 / num_classes, 4),
        "clip_grad_norm": clip_grad_norm,
        "norm": norm,
        "batch_size": batch_size,
        "base_lr": base_lr,
        "dropout": dropout,
        "gen_seconds": round(gen_s, 1),
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
        **counter.record(dev),
        "source": source,
        "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
    }
    if not keep_data:
        shutil.rmtree(root, ignore_errors=True)
    return result


def run_multilabel(num_classes: int = 24, epochs: int = 90,
                   batch_size: int = 64, base_lr: float = 0.08, seed: int = 0,
                   root: str | None = None, keep_data: bool = False,
                   train_videos: int = 1500, eval_videos: int = 200,
                   source: str = "mp4", device: str | torch.device = "cuda") -> dict:
    """Multi-label variant: 2 simultaneous motions per video, a sigmoid tag
    head on r2plus1d_18 (the JAX file's measured recipe: 1500 videos, 90
    epochs, lr 0.08)."""
    _check_source(source)
    if source == "mp4pack":
        raise ValueError("the tagging set has no mp4pack packs: use 'mp4' or 'pack'")
    dev = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="fvt_hard_ml_")
    t0 = time.time()
    if source == "mp4":
        train_list, eval_list = synthetic_motion.make_tagging_dataset(
            root, num_classes=num_classes, seed=seed,
            train_videos=train_videos, eval_videos=eval_videos)
        tidx = synthetic_motion.tag_index(num_classes)
        train_src, _ = load_tag_list(train_list, root, tidx)
        eval_src, _ = load_tag_list(eval_list, root, tidx)
    else:
        train_src, eval_src = _packs(root, synthetic_motion.iter_tagging_videos(
            num_classes, train_videos=train_videos, eval_videos=eval_videos,
            seed=seed), num_classes)
    gen_s = time.time() - t0

    cfg = tagging_config(num_classes, epochs, batch_size, base_lr, seed)
    t0 = time.time()
    state = fit(cfg, train_src, num_tags=num_classes, device=dev)
    train_s = time.time() - t0

    ds = eval_dataset(eval_src, cfg.data, source, num_tags=num_classes)
    scores, records = evaluate_video_scores(state.model, state.model.state_dict(), ds,
                                            cfg, clip_batch=8)
    multihot = np.stack([r.multihot(num_classes) for r in records])
    pr = per_tag_precision_recall(scores, multihot, threshold=0.5)
    # top-2 exact set match: both objects' motions identified
    top2 = np.argsort(-scores, axis=1)[:, :2]
    exact = float(np.mean([set(t) == set(np.where(m)[0])
                           for t, m in zip(top2, multihot)]))
    result = {
        "benchmark": "hard_synthetic_motion_tagging",
        "model": "r2plus1d_18 (sigmoid multi-label head)",
        "num_tags": num_classes,
        "objects_per_video": 2,
        "train_videos": num_videos(train_src, source),
        "eval_videos": len(records),
        "epochs": epochs,
        "steps": int(state.step),
        "seed": seed,
        "mAP": round(mean_average_precision(scores, multihot), 4),
        "macro_f1": round(float(pr["f1"].mean()), 4),
        "top2_exact_set": round(exact, 4),
        "gen_seconds": round(gen_s, 1),
        "train_seconds": round(train_s, 1),
        "source": source,
        "device": str(dev),
        "card": card() if dev.type == "cuda" else None,
    }
    if not keep_data:
        shutil.rmtree(root, ignore_errors=True)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--classes", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--root", default=None)
    p.add_argument("--out", default=None)
    p.add_argument("--multilabel", action="store_true",
                   help="run the multi-object tagging variant")
    p.add_argument("--model", default="r2plus1d_18",
                   help="zoo name (e.g. r2plus1d_18_tpu) for the single-label run")
    p.add_argument("--clip-grad-norm", type=float, default=0.0)
    p.add_argument("--clip-len", type=int, default=8)
    p.add_argument("--stride", type=int, default=2)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--norm", default="batch",
                   help="ModelConfig.norm for the single-label run (batch|frozen)")
    p.add_argument("--source", choices=SOURCES, default="mp4",
                   help="mp4: write and decode .mp4 files (needs cv2); mp4pack: the same "
                        "decoded pixels from packs (--pack-dir); pack: the generator's raw "
                        "frames straight into .fvtpack files")
    add_pack_dir(p)
    p.add_argument("--write-packs", metavar="DIR", default=None,
                   help="write the motion set's mp4pack pair (--classes, --seed) into DIR "
                        "and exit (needs cv2)")
    p.add_argument("--pixel-gap", metavar="DIR", default=None,
                   help="compare DIR's mp4pack pair with the raw frames (pixel_gap), exit")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.write_packs or args.pixel_gap:
        out = (write_mp4_packs(args.write_packs, args.classes or 50, args.seed)
               if args.write_packs else pixel_gap(args.pixel_gap, args.classes or 50, args.seed))
        print(json.dumps(out))
        return out
    if args.multilabel:
        result = run_multilabel(
            min(args.classes or 24, 24), args.epochs or 90, args.batch,
            args.lr or 0.08, args.seed, args.root, source=args.source,
            device=args.device)
    else:
        result = run(args.classes or 50, args.epochs or 40, args.batch,
                     args.lr or 0.05, args.seed, args.root,
                     model_name=args.model,
                     clip_grad_norm=args.clip_grad_norm, norm=args.norm,
                     clip_len=args.clip_len, stride=args.stride,
                     dropout=args.dropout, source=args.source, device=args.device,
                     pack_dir=args.pack_dir)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
