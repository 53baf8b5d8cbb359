"""int8 PTQ schemes of the Inception families (s3d, i3d) on trained
weights, and their serving throughput (the port of the JAX package's
``benchmarks/int8_inception.py``, its config field for field).

Per model, on a model trained on the hard 50-class motion benchmark
(ACCURACY_HARD_S3D's recipe: 120 epochs, grad clip 1.0):

  * video-level top-1 of bf16, of the static engine at the global margin
    2.0, of the static engine at site-aware margins
    (``calibrate(return_margins=True)``) and of the dynamic engine, on the
    same clips; with ``--margin-sweep`` also static at the global margins
    1.0, 1.25, 1.5 and 2.5 and at the site margins times 0.75;
  * serving clips/s at B = 32, 16x112x112, random weights (throughput does
    not depend on them): the bf16 model (kernels='cuda') against the static
    and the dynamic engine, timed by CUDA events (the fastest of 5 windows
    of 20 forwards, the runs in turn: int8_serving.serving_throughput).

These records test the spec defaults (ops/arch_spec.py: s3d static at site
margins, i3d dynamic); the record adds the launches of Q1 / Q2 in one
forward of each mode beside the calls the engine's walk makes.

    python -m fastvideotagging_tpu_torch.benchmarks.int8_inception --source pack \\
        --margin-sweep --out fastvideotagging_tpu_torch/benchmarks/INT8_INCEPTION.json

``--source`` as in accuracy_hard. Runs on the card unless ``--device cpu``
(the throughput needs the card: ``--skip-throughput`` on the host).
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks import int8_serving
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import SOURCES
from fastvideotagging_tpu_torch.benchmarks.int8_serving import (
    calibration_clips,
    forward_launches,
    int8_hard_config,
    train_motion,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine
from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
from fastvideotagging_tpu_torch.ops.int8_infer import calibrate, quantize_variables
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy

SWEEP_MARGINS = (1.0, 1.25, 1.5, 2.5)
# the int8 engines whose throughput a record holds against bf16
ENGINES = {"int8_static": {"dynamic": False}, "int8_dynamic": {"dynamic": True}}


def serving_throughput(model_name: str) -> dict:
    """bf16 against int8 static and dynamic clips/s on the card, on the same
    random weights and clips (int8_serving.serving_throughput), under the JAX
    record's keys."""
    tp = int8_serving.serving_throughput(model_name, engines=ENGINES)
    runs = tp["runs"]
    return {
        **{f"{name}_clips_per_sec": r["clips_per_sec"] for name, r in runs.items()},
        "geometry": "B=32 16x112x112",
        "ms_per_forward": {name: r["ms"] for name, r in runs.items()},
        "window_ms": {name: r["window_ms"] for name, r in runs.items()},
        "timing": tp["timing"],
    }


def accuracy(model_name: str, num_classes: int = 50, epochs: int = 120,
             batch_size: int = 64, base_lr: float = 0.05, seed: int = 0,
             margin_sweep: bool = False, source: str = "mp4",
             device: str | torch.device = "cuda", kernels: str = "cuda") -> dict:
    """``kernels`` trains on the hand kernels ('cuda') or on their plain
    versions ('torch'), which tells a weight-dependent int8 result from one
    of the kernels."""
    dev = resolve_device(device)
    # no residual bypass in either family: unclipped early grads destroy the params
    cfg = int8_hard_config(model_name, num_classes, epochs, batch_size, base_lr, seed,
                           clip_grad_norm=1.0, kernels=kernels)
    root = tempfile.mkdtemp(prefix=f"fvt_int8inc_{model_name}_")
    try:
        state, train_src, ds, facts = train_motion(cfg, root, source, dev)
        model = state.model
        sd = model.state_dict()
        spec = spec_for(model_name)
        calib = calibration_clips(train_src, cfg, source, dev)
        scales, margins = calibrate(sd, calib, spec=spec, return_margins=True)
        qpack_global = quantize_variables(sd, scales, spec=spec, static_margin=2.0)
        qpack_site = quantize_variables(sd, scales, spec=spec, static_margin=margins)

        bf16_scores, records = evaluate_video_scores(model, sd, ds, cfg, clip_batch=8)
        labels = np.asarray([r.label for r in records])
        x = torch.cat(calib[:2])
        launches = {}

        def int8_top1(qpack, dynamic: bool) -> float:
            scores, _ = evaluate_video_scores(model, qpack, ds, cfg, clip_batch=8,
                                              apply_fn=make_int8_engine(model_name,
                                                                        dynamic=dynamic))
            return round(topk_accuracy(scores, labels, k=1), 4)

        for mode, dynamic in (("static", False), ("dynamic", True)):
            launches[mode] = forward_launches(make_int8_engine(model_name, dynamic=dynamic),
                                              qpack_global, x, spec, spec.default_float_blocks)
        marr = np.asarray(sorted(margins.values()))
        result = {
            "model": model_name,
            "num_classes": num_classes,
            "epochs": epochs,
            "seed": seed,
            "clip_grad_norm": 1.0,
            "bf16_top1": round(topk_accuracy(bf16_scores, labels, k=1), 4),
            "int8_static_global_top1": int8_top1(qpack_global, dynamic=False),
            "int8_static_site_top1": int8_top1(qpack_site, dynamic=False),
            "int8_dynamic_top1": int8_top1(qpack_global, dynamic=True),
            "site_margins": {
                "min": round(float(marr[0]), 3),
                "median": round(float(np.median(marr)), 3),
                "max": round(float(marr[-1]), 3),
                "num_sites": int(marr.size),
            },
            **facts,
            "kernels": kernels,
            "int8_launches": launches,
        }
        if margin_sweep:
            # more margin is coarser steps (scale = margin * absmax / 127): the
            # sweep separates clipping from resolution as the error source
            sweep = {f"global_{m}": int8_top1(
                quantize_variables(sd, scales, spec=spec, static_margin=m), dynamic=False)
                for m in SWEEP_MARGINS}
            sweep["site_x0.75"] = int8_top1(quantize_variables(
                sd, scales, spec=spec,
                static_margin={k: v * 0.75 for k, v in margins.items()}), dynamic=False)
            result["margin_sweep"] = sweep
        return result
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--models", nargs="+", default=["s3d", "i3d"])
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--classes", type=int, default=50)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--skip-throughput", action="store_true")
    p.add_argument("--margin-sweep", action="store_true",
                   help="also sweep static margins (global 1.0-2.5 and the site margins x0.75)")
    p.add_argument("--source", choices=SOURCES, default="mp4")
    p.add_argument("--kernels", choices=["cuda", "torch"], default="cuda",
                   help="ModelConfig.kernels of the training: 'torch' takes the hand "
                        "kernels' plain versions")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    results = []
    for m in args.models:
        row = accuracy(m, num_classes=args.classes, epochs=args.epochs, batch_size=args.batch,
                       margin_sweep=args.margin_sweep, source=args.source, device=args.device,
                       kernels=args.kernels)
        if not args.skip_throughput:
            row["throughput"] = serving_throughput(m)
        results.append(row)
        print(f"[int8_inception] {m}: {row}", file=sys.stderr, flush=True)

    result = {"benchmark": "int8_inception_schemes",
              "task": "hard_synthetic_motion_50 (8x32x32 clips)",
              "results": results,
              "source": args.source,
              "device": args.device,
              "card": card() if args.device == "cuda" else None}
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
