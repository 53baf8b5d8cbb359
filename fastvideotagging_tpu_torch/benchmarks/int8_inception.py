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

Two runs that train nothing into the record:

* ``--throughput-only``: re-measures the ``throughput`` row of each model
  of the committed record (written to ``--out``, the record itself by
  default); every other row stays byte for byte, and each re-measured row
  names its run and card.
* ``--site-report --out INT8_INCEPTION_S3D_SITES.json``: trains s3d once
  on the record's recipe and writes the run's bf16, site-static,
  global-static and dynamic top-1 with, for each int8 site, the
  calibration amax of each batch, the site margin, the share of the eval
  clips' values clipped at the site-static scale and the relative error of
  the reconstructed conv input (``int8_infer(..., debug_sites=True)``
  against the bf16 walk), the sites ranked by that error (``site_report``),
  and at mixed5b / mixed5c each channel's calibration and eval amax. Its
  training is the record's recipe, so with the same source its
  ``state_sha256`` and top-1 figures are the record's s3d row's.

``--source`` as in accuracy_hard. Runs on the card unless ``--device cpu``
(the throughput needs the card: ``--skip-throughput`` on the host).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks import int8_serving
from fastvideotagging_tpu_torch.benchmarks.accuracy_hard import SOURCES, add_pack_dir
from fastvideotagging_tpu_torch.benchmarks.int8_serving import (
    calibration_clips,
    eval_clips,
    forward_launches,
    int8_hard_config,
    train_motion,
)
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate_video_scores
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine
from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
from fastvideotagging_tpu_torch.ops.int8_infer import (
    _calibrate_sites,
    calibrate,
    int8_infer,
    quantize_variables,
    spec_walk,
)
from fastvideotagging_tpu_torch.train.metrics import topk_accuracy

SWEEP_MARGINS = (1.0, 1.25, 1.5, 2.5)
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "INT8_INCEPTION.json")
# eval videos whose clips the site report holds each site's values from
SITE_REPORT_VIDEOS = 64
# the sites whose channels the site report lists one by one (the worst
# sites of the s3d static default, INT8_INCEPTION_S3D_SITES)
CHANNEL_SITES = ("mixed5b.", "mixed5c.")
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


@torch.inference_mode()
def site_report(variables: dict, calib, eval_batches, spec) -> list[dict]:
    """Each int8 site of the static engine at site margins, ranked by error:
    the calibration amax of each batch of ``calib`` (the largest |value| of
    the site's input over the batch), the site margin
    (``calibrate(return_margins=True)``), the static scale, the share of
    ``eval_batches``' values at the site that the static scale clips
    (|round(x * inv_f / s)| > 127, the engine's static quantize) and the
    relative error of the engine's reconstructed input (``int8_infer(...,
    debug_sites=True)``) against the bf16 walk's, mean |q - r| / (mean |r|
    + 1e-9) as the JAX package's attribution tests take it. At the
    CHANNEL_SITES sites also ``channels``: each channel's calibration amax
    (over every calibration batch), its eval amax, the |value| past which
    the static scale clips it, and its share of the eval values clipped."""
    per_batch: dict[str, list] = {}
    calib_ch: dict[str, torch.Tensor] = {}
    for x in calib:
        for site, amax in _calibrate_sites(variables, x, spec).items():
            per_batch.setdefault(site, []).append(float(amax.max()))
            if site.startswith(CHANNEL_SITES):
                calib_ch[site] = torch.maximum(calib_ch.get(site, amax), amax)
    scales, margins = calibrate(variables, calib, spec=spec, return_margins=True)
    qpack = quantize_variables(variables, scales, spec=spec, static_margin=margins)
    sums: dict[str, list] = {}
    eval_ch: dict[str, list] = {}
    ref = {}

    def record(site, t):
        ref[site] = t.float()
        return t

    for x in eval_batches:
        spec_walk(spec, variables, x, record)
        _, got = int8_infer(qpack, x, spec, debug_sites=True)
        for site, q in got.items():
            r = ref[site]
            t = r * (qpack["inv_f"][site] / qpack["s_static"][site])
            clipped = torch.round(t).abs() > 127
            acc = sums.setdefault(site, [0.0, 0.0, 0, 0])
            acc[0] += float((q - r).abs().sum())
            acc[1] += float(r.abs().sum())
            acc[2] += int(clipped.sum())
            acc[3] += r.numel()
            if site in calib_ch:
                dims = tuple(range(r.ndim - 1))
                amax, hits = r.abs().amax(dim=dims), clipped.sum(dim=dims)
                prev = eval_ch.get(site)
                eval_ch[site] = ([amax, hits, r.numel() // r.shape[-1]] if prev is None else
                                 [torch.maximum(prev[0], amax), prev[1] + hits,
                                  prev[2] + r.numel() // r.shape[-1]])
    rows = [{"site": site,
             "rel_error": (d / n) / (a / n + 1e-9),
             "clipped_share": c / n,
             "margin": margins[site],
             "static_scale": float(qpack["s_static"][site]),
             "calib_amax_per_batch": per_batch[site]}
            for site, (d, a, c, n) in sums.items()]
    for row in rows:
        site = row["site"]
        if site in eval_ch:
            amax, hits, count = eval_ch[site]
            clip_at = (127.5 * qpack["s_static"][site]
                       / torch.as_tensor(qpack["inv_f"][site], dtype=torch.float32,
                                         device=amax.device)).expand_as(amax)
            row["channels"] = {
                "calib_amax": [round(float(v), 5) for v in calib_ch[site]],
                "eval_amax": [round(float(v), 5) for v in amax],
                "clips_past": [round(float(v), 5) for v in clip_at],
                "eval_clipped_share": [round(float(v) / count, 5) for v in hits],
            }
    return sorted(rows, key=lambda r: -r["rel_error"])


def accuracy(model_name: str, num_classes: int = 50, epochs: int = 120,
             batch_size: int = 64, base_lr: float = 0.05, seed: int = 0,
             margin_sweep: bool = False, source: str = "mp4",
             device: str | torch.device = "cuda", kernels: str = "cuda",
             sites: bool = False, pack_dir: str | None = None) -> dict:
    """``kernels`` trains on the hand kernels ('cuda') or on their plain
    versions ('torch'), which tells a weight-dependent int8 result from one
    of the kernels. ``sites``: add the ``site_report`` of the trained
    weights on the first SITE_REPORT_VIDEOS eval videos."""
    dev = resolve_device(device)
    # no residual bypass in either family: unclipped early grads destroy the params
    cfg = int8_hard_config(model_name, num_classes, epochs, batch_size, base_lr, seed,
                           clip_grad_norm=1.0, kernels=kernels)
    root = tempfile.mkdtemp(prefix=f"fvt_int8inc_{model_name}_")
    try:
        state, train_src, ds, facts = train_motion(cfg, root, source, dev, pack_dir)
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
        if sites:
            clips = eval_clips(ds, cfg, dev, SITE_REPORT_VIDEOS)
            result["sites"] = site_report(sd, calib, [torch.cat(clips[i:i + 16])
                                                      for i in range(0, len(clips), 16)], spec)
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
    add_pack_dir(p)
    p.add_argument("--kernels", choices=["cuda", "torch"], default="cuda",
                   help="ModelConfig.kernels of the training: 'torch' takes the hand "
                        "kernels' plain versions")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    p.add_argument("--throughput-only", action="store_true",
                   help="re-measure the throughput rows of the committed record (nothing is "
                        "trained), written to --out (the record itself by default)")
    p.add_argument("--site-report", action="store_true",
                   help="train s3d once and write its per-site calibration report to --out")
    args = p.parse_args(argv)
    if args.throughput_only:
        return remeasure_throughput(RECORD, args.out or RECORD, args.models)
    if args.site_report:
        return write_site_report(args)

    results = []
    for m in args.models:
        row = accuracy(m, num_classes=args.classes, epochs=args.epochs, batch_size=args.batch,
                       margin_sweep=args.margin_sweep, source=args.source, device=args.device,
                       kernels=args.kernels, pack_dir=args.pack_dir)
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


def remeasure_throughput(record: str, out: str, models) -> dict:
    """Replace the ``throughput`` row of each of ``models`` in ``record``
    (written to ``out``) by a new ``serving_throughput`` that names this run
    and the card; the other rows are written back as they were read (json
    round-trips them byte for byte)."""
    resolve_device("cuda")
    with open(record) as f:
        result = json.load(f)
    name = card()
    for row in result["results"]:
        if row["model"] in models:
            tp = serving_throughput(row["model"])
            tp["dynamic_over_static"] = round(tp["int8_dynamic_clips_per_sec"]
                                              / tp["int8_static_clips_per_sec"], 4)
            tp["run"] = ("int8_inception --throughput-only: the engines as captured CUDA "
                         "graphs, measured apart from the run that trained the other rows")
            tp["card"] = name
            row["throughput"] = tp
            print(f"[int8_inception] {row['model']} throughput: {tp}", file=sys.stderr,
                  flush=True)
    line = json.dumps(result, indent=2)
    print(line)
    with open(out, "w") as f:
        f.write(line + "\n")
    return result


def write_site_report(args) -> dict:
    """--site-report: one s3d training on the record's recipe, its top-1 per
    scheme and ``site_report``."""
    row = accuracy("s3d", num_classes=args.classes, epochs=args.epochs, batch_size=args.batch,
                   source=args.source, device=args.device, kernels=args.kernels, sites=True,
                   pack_dir=args.pack_dir)
    keep = ("model", "num_classes", "epochs", "seed", "clip_grad_norm", "bf16_top1",
            "int8_static_global_top1", "int8_static_site_top1", "int8_dynamic_top1",
            "site_margins", "train_seconds", "steps", "kernels", "state_sha256")
    result = {"benchmark": "int8_inception_s3d_sites",
              "task": "hard_synthetic_motion_50 (8x32x32 clips)",
              **{k: row[k] for k in keep},
              "site_eval_videos": SITE_REPORT_VIDEOS,
              "sites": row["sites"],
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
