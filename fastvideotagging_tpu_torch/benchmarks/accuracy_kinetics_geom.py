"""Trained accuracy at the Kinetics geometry (the port of the JAX package's
``benchmarks/accuracy_kinetics_geom.py``, its config field for field).

Trains s3d on 8 motion classes at the Kinetics protocol's clip shape
(32-frame clips at stride 2, 224x224 crops of 256x256 frames; sources of
64 frames, 12 train and 4 eval videos a class), then records video-level
top-1 of one clip a video and of the ``eval_mode='uniform'`` aggregation of
4 clips, the multi-clip path at the geometry it serves. The record counts
K1-K3's launches over training and evaluation.

    python -m fastvideotagging_tpu_torch.benchmarks.accuracy_kinetics_geom --source pack \\
        --epochs 60 --out fastvideotagging_tpu_torch/benchmarks/ACCURACY_KINETICS_GEOM.json

``--source`` as in accuracy_hard. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import shutil
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import (
    SOURCES,
    LaunchCounter,
    add_pack_dir,
    eval_dataset,
    motion_sources,
    num_videos,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.config import (
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    ParallelConfig,
    TrainConfig,
)
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy

# the sources: 12 train and 4 eval videos a class of 64 frames at 256x256
GEOMETRY = dict(train_per_class=12, eval_per_class=4, num_frames=64, height=256, width=256)


def kinetics_config(num_classes: int = 8, epochs: int = 30, batch_size: int = 8,
                    base_lr: float = 0.02, seed: int = 0) -> ExperimentConfig:
    """The JAX file's config, field for field (``kernels`` takes the port's
    default)."""
    return ExperimentConfig(
        model=ModelConfig(name="s3d", num_classes=num_classes, dropout=0.0),
        # the Kinetics protocol: 256-side source, 224 crop, 32-frame clips
        data=DataConfig(source_hw=(256, 256), resize_hw=(256, 256),
                        crop_hw=(224, 224), random_flip=False,
                        num_workers=8, cache_mb=2048,
                        sampler=ClipSamplerConfig(clip_len=32, stride=2,
                                                  eval_mode="uniform",
                                                  num_eval_clips=4)),
        train=TrainConfig(batch_size=batch_size, num_epochs=epochs,
                          base_lr=base_lr, weight_decay=1e-4,
                          lr_steps=(int(epochs * 0.6), int(epochs * 0.85)),
                          warmup_epochs=2, seed=seed, log_every=20,
                          clip_grad_norm=1.0,  # s3d requirement
                          checkpoint_dir=""),
        parallel=ParallelConfig(data_parallel=1, model_parallel=1),
    )


def run(num_classes: int = 8, epochs: int = 30, batch_size: int = 8,
        base_lr: float = 0.02, seed: int = 0, source: str = "mp4",
        device: str | torch.device = "cuda", geometry: dict | None = None,
        pack_dir: str | None = None) -> dict:
    """``geometry`` replaces ``GEOMETRY``'s entries (a smaller set for a
    test; the record's crop and clip stay the config's)."""
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="fvt_kinetics_geom_")
    try:
        t0 = time.time()
        train_src, eval_src = motion_sources(root, source, num_classes, seed, pack_dir,
                                             **{**GEOMETRY, **(geometry or {})})
        gen_s = time.time() - t0
        cfg = kinetics_config(num_classes, epochs, batch_size, base_lr, seed)
        counter = LaunchCounter()
        t0 = time.time()
        with counter("fit"):
            state = fit(cfg, train_src, device=dev)
        train_s = time.time() - t0
        model = state.model.eval()
        sd = model.state_dict()
        labels = None

        def eval_top1(num_clips: int) -> float:
            nonlocal labels
            c = dataclasses.replace(cfg, data=dataclasses.replace(
                cfg.data, sampler=dataclasses.replace(cfg.data.sampler,
                                                      num_eval_clips=num_clips)))
            with counter(f"eval_{num_clips}_clips"):
                scores, recs = evaluate_video_scores(
                    model, sd, eval_dataset(eval_src, c.data, source), c, clip_batch=4)
            got = np.asarray([r.label for r in recs])
            if labels is not None and not np.array_equal(got, labels):
                raise RuntimeError("the two evaluations saw the videos in another order")
            labels = got
            return round(topk_accuracy(scores, labels, k=1), 4)

        t0 = time.time()
        result = {
            "benchmark": "kinetics_geometry_accuracy",
            "model": "s3d",
            "geometry": "32x224x224 (stride 2) from 256x256x64 videos",
            "num_classes": num_classes,
            "train_videos": num_videos(train_src, source),
            "eval_videos": num_videos(eval_src, source),
            "epochs": epochs,
            "steps": int(state.step),
            "seed": seed,
            "clip_grad_norm": 1.0,
            "batch_size": batch_size,
            "base_lr": base_lr,
            "chance_top1": round(1.0 / num_classes, 4),
            # the aggregation sweep the Kinetics configuration serves with
            "top1_single_clip": eval_top1(1),
            "top1_multi_clip_4": eval_top1(4),
            "gen_seconds": round(gen_s, 1),
            "train_seconds": round(train_s, 1),
        }
        result["eval_seconds"] = round(time.time() - t0, 1)
        result.update(counter.record(dev), source=source, device=str(dev),
                      card=card() if dev.type == "cuda" else None)
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--classes", type=int, default=8)
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--source", choices=SOURCES, default="mp4")
    add_pack_dir(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    result = run(num_classes=args.classes, epochs=args.epochs, source=args.source,
                 device=args.device, pack_dir=args.pack_dir)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
