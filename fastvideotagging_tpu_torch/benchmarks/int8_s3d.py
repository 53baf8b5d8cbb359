"""int8 PTQ accuracy of S3D on trained weights (the port of the JAX
package's ``benchmarks/int8_s3d.py``, its config field for field).

Trains s3d on the hard 50-class motion benchmark (ACCURACY_HARD_S3D's
recipe: 120 epochs, grad clip 1.0), calibrates the spec-driven int8 engine
on the first eval clips of 16 train videos (``quantize_for``: s3d's
site-aware static margins), then reports video-level top-1 of bf16, of the
static int8 engine and of the dynamic one, on the same clips. The record
adds the launches of Q1 / Q2 in one forward of each mode beside the calls
the engine's walk makes, and K1-K3's over training.

    python -m fastvideotagging_tpu_torch.benchmarks.int8_s3d --source pack \\
        --out fastvideotagging_tpu_torch/benchmarks/INT8_S3D.json

``--source`` as in accuracy_hard. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import SOURCES, add_pack_dir
from fastvideotagging_tpu_torch.benchmarks.int8_serving import (
    calibration_clips,
    forward_launches,
    int8_hard_config,
    train_motion,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine, quantize_for
from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy


def run(num_classes: int = 50, epochs: int = 120, batch_size: int = 64,
        base_lr: float = 0.05, seed: int = 0, source: str = "mp4",
        device: str | torch.device = "cuda", pack_dir: str | None = None) -> dict:
    dev = resolve_device(device)
    cfg = int8_hard_config("s3d", num_classes, epochs, batch_size, base_lr, seed,
                           clip_grad_norm=1.0)  # s3d diverges without it
    root = tempfile.mkdtemp(prefix="fvt_int8_s3d_")
    try:
        state, train_src, ds, facts = train_motion(cfg, root, source, dev, pack_dir)
        model = state.model
        sd = model.state_dict()
        calib = calibration_clips(train_src, cfg, source, dev)
        qpack = quantize_for("s3d", sd, calib)

        bf16_scores, records = evaluate_video_scores(model, sd, ds, cfg, clip_batch=8)
        labels = np.asarray([r.label for r in records])
        x = torch.cat(calib[:2])  # one clip batch of the eval's size
        spec = spec_for("s3d")
        launches = {}

        def int8_top1(dynamic: bool) -> float:
            apply = make_int8_engine("s3d", multilabel=False, dynamic=dynamic)
            launches["dynamic" if dynamic else "static"] = forward_launches(
                apply, qpack, x, spec, spec.default_float_blocks)
            scores, _ = evaluate_video_scores(model, qpack, ds, cfg, clip_batch=8,
                                              apply_fn=apply)
            return topk_accuracy(scores, labels, k=1)

        return {
            "benchmark": "int8_s3d_hard_motion_50",
            "model": "s3d",
            "num_classes": num_classes,
            "epochs": epochs,
            "seed": seed,
            "clip_grad_norm": 1.0,
            "bf16_top1": round(topk_accuracy(bf16_scores, labels, k=1), 4),
            "int8_top1": round(int8_top1(dynamic=False), 4),
            "int8_dynamic_top1": round(int8_top1(dynamic=True), 4),
            **facts,
            "int8_launches": launches,
            "eval_videos": len(records),
            "source": source,
            "device": str(dev),
            "card": card() if dev.type == "cuda" else None,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--classes", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--source", choices=SOURCES, default="mp4")
    add_pack_dir(p)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    result = run(num_classes=args.classes, epochs=args.epochs, batch_size=args.batch,
                 seed=args.seed, source=args.source, device=args.device,
                 pack_dir=args.pack_dir)
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
