"""Hard accuracy benchmark: r2plus1d_18 trained from scratch on 50
confusable motion classes (the port of the JAX package's
``benchmarks/accuracy_hard.py``, with its configs field for field).

Class identity is pure motion (direction x speed x trajectory; appearance is
class-blind by construction, data/synthetic_motion.py), so a per-frame model
scores at chance and a spatiotemporal backbone is needed. Dataset, sampler
draws and init all come from the seed.

    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard --source pack \
        --epochs 60 --out fastvideotagging_tpu_torch/benchmarks/ACCURACY_HARD.json
    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_hard --source pack \
        --multilabel --out fastvideotagging_tpu_torch/benchmarks/ACCURACY_TAGGING.json

``--source`` picks how the videos reach the loader, the caller's choice:
``mp4`` (the default) writes and decodes ``.mp4`` files as the JAX file
does (needs cv2); ``pack`` writes the same seeded frames straight into
``.fvtpack`` files (``write_pack_from_arrays``), with no codec round trip,
for a machine without cv2. The result JSON records the route and the
card's name and power limit. Trains and evaluates on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
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
from fastvideotagging_tpu_torch.data.packed import Pack, PackedDataset, write_pack_from_arrays
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.data.ucf101 import load_tag_list, load_video_list
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.metrics import (
    mean_average_precision,
    per_tag_precision_recall,
    topk_accuracy,
)

SOURCES = ("mp4", "pack")
# the videos' frame size (data/synthetic_motion.py's default): the packs'
# geometry and the configs' source_hw
VIDEO_HW = (48, 48)


def hard_config(num_classes: int = 50, epochs: int = 40, batch_size: int = 64,
                base_lr: float = 0.05, seed: int = 0, model_name: str = "r2plus1d_18",
                clip_grad_norm: float = 0.0, norm: str = "batch", clip_len: int = 8,
                stride: int = 2, dropout: float = 0.0) -> ExperimentConfig:
    """The single-label run's config: the JAX file's ``run``, field for field
    (``kernels`` takes the port's default)."""
    return ExperimentConfig(
        # the real backbone at a reduced input resolution (8x32x32)
        model=ModelConfig(name=model_name, num_classes=num_classes,
                          dropout=dropout, norm=norm),
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


def _packs(root: str, videos, num_tags: int | None) -> tuple[str, str]:
    """Write ``videos`` ((split, path, label or tag ids, frames)) into a
    train and an eval pack under ``root``; returns their paths."""
    paths = {split: os.path.join(root, f"{split}.fvtpack") for split in ("train", "eval")}
    split_items = {"train": [], "eval": []}
    for split, rel, target, frames in videos:
        if num_tags is None:
            split_items[split].append((rel, int(target), (), frames))
        else:
            split_items[split].append((rel, None, tuple(int(t) for t in target), frames))
    for split, items in split_items.items():
        write_pack_from_arrays(items, paths[split], VIDEO_HW, num_tags=num_tags)
    return paths["train"], paths["eval"]


def _check_source(source: str) -> None:
    if source not in SOURCES:
        raise ValueError(f"source must be one of {SOURCES}, got {source!r}")


def run(num_classes: int = 50, epochs: int = 40, batch_size: int = 64,
        base_lr: float = 0.05, seed: int = 0, root: str | None = None,
        keep_data: bool = False, model_name: str = "r2plus1d_18",
        clip_grad_norm: float = 0.0, norm: str = "batch",
        clip_len: int = 8, stride: int = 2, dropout: float = 0.0,
        source: str = "mp4", device: str | torch.device = "cuda") -> dict:
    _check_source(source)
    dev = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="fvt_hard_")
    t0 = time.time()
    if source == "mp4":
        train_list, eval_list = synthetic_motion.make_motion_dataset(
            root, num_classes=num_classes, seed=seed)
        train_src = load_video_list(train_list, root=root)
        eval_records = load_video_list(eval_list, root=root)
    else:
        train_src, eval_pack = _packs(root, synthetic_motion.iter_motion_videos(
            num_classes, seed=seed), None)
    gen_s = time.time() - t0
    n_train = len(train_src) if source == "mp4" else len(Pack(train_src))

    cfg = hard_config(num_classes, epochs, batch_size, base_lr, seed, model_name,
                      clip_grad_norm, norm, clip_len, stride, dropout)
    t0 = time.time()
    state = fit(cfg, train_src, device=dev)
    train_s = time.time() - t0

    ds = (ClipDataset(eval_records, cfg.data, mode="eval") if source == "mp4"
          else PackedDataset(eval_pack, cfg.data, mode="eval"))
    t0 = time.time()
    scores, records = evaluate_video_scores(state.model, state.model.state_dict(), ds,
                                            cfg, clip_batch=8)
    eval_s = time.time() - t0
    labels = np.asarray([r.label for r in records])
    onehot = np.eye(num_classes, dtype=np.float32)[labels]
    result = {
        "benchmark": "hard_synthetic_motion_50",
        "model": model_name,
        "num_classes": num_classes,
        "train_videos": n_train,
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
        "gen_seconds": round(gen_s, 1),
        "train_seconds": round(train_s, 1),
        "eval_seconds": round(eval_s, 1),
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
    dev = resolve_device(device)
    root = root or tempfile.mkdtemp(prefix="fvt_hard_ml_")
    t0 = time.time()
    if source == "mp4":
        train_list, eval_list = synthetic_motion.make_tagging_dataset(
            root, num_classes=num_classes, seed=seed,
            train_videos=train_videos, eval_videos=eval_videos)
        tidx = synthetic_motion.tag_index(num_classes)
        train_src, _ = load_tag_list(train_list, root, tidx)
        eval_records, _ = load_tag_list(eval_list, root, tidx)
    else:
        train_src, eval_pack = _packs(root, synthetic_motion.iter_tagging_videos(
            num_classes, train_videos=train_videos, eval_videos=eval_videos,
            seed=seed), num_classes)
    gen_s = time.time() - t0
    n_train = len(train_src) if source == "mp4" else len(Pack(train_src))

    cfg = tagging_config(num_classes, epochs, batch_size, base_lr, seed)
    t0 = time.time()
    state = fit(cfg, train_src, num_tags=num_classes, device=dev)
    train_s = time.time() - t0

    ds = (ClipDataset(eval_records, cfg.data, mode="eval", num_tags=num_classes)
          if source == "mp4" else
          PackedDataset(eval_pack, cfg.data, mode="eval", num_tags=num_classes))
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
        "train_videos": n_train,
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
                   help="mp4: write and decode .mp4 files (needs cv2); pack: the "
                        "same frames straight into .fvtpack files")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
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
                     dropout=args.dropout, source=args.source, device=args.device)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
