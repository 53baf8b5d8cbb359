"""int8 against bf16 at the Kinetics geometry on the card (the port of the
JAX package's ``benchmarks/int8_kinetics.py``, its config field for field:
r2plus1d_34, B = 8, 32x224x224 clips, 101 classes, seeded random weights,
the int8 engine calibrated on the first 2 clips).

Two parts, one record (the JAX record ``INT8_KINETICS_PROFILE.json``'s
keys, and the clips/s its default mode writes):

  1. clips/s of the bf16 model and of the int8 engine in its modes
     (default: static scales, the spec's bf16 tail; full int8, no bf16
     tail; dynamic scales; the exact residual), each a captured CUDA graph
     (evaluation/graphed.py), as the JAX script times jitted engines; CUDA
     events, the fastest of 3 windows of 5 forwards after one not kept,
     every window written down;
  2. the device-time attribution of the int8 and the bf16 forwards
     (``utils/step_profiler.py``'s eval mode, the port's counterpart of the
     JAX script's HLO join): time a forward in int8 convs (Q1, its fused
     epilogues included), float convs (K1 / K2 and the library's), the
     standalone quantize passes (Q2: what a quantize fused into the
     producer's epilogue would remove) and the rest, and the
     ``epilogue_fused_upper_bound_ms`` = the int8 total less the standalone
     quantize passes.

    python -m fastvideotagging_tpu_torch.benchmarks.int8_kinetics \\
        --out fastvideotagging_tpu_torch/benchmarks/INT8_KINETICS_PROFILE.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.int8_serving import serving_throughput
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.utils.step_profiler import profile_eval_step

MODEL = "r2plus1d_34"
B, T, CROP = 8, 32, 224
ITERS, WINDOWS = 5, 3  # forwards a timed window, windows kept
STEPS = 3  # forwards traced for the attribution
# the int8 engine's modes the JAX script times: int8_infer's options
ENGINES = {"int8": {}, "int8_full": {"float_blocks": ()}, "int8_dynamic": {"dynamic": True},
           "int8_exact_residual": {"residual": "exact"}}


def throughput(device: str = "cuda") -> dict:
    """clips/s of the bf16 model and each int8 mode, each a captured graph,
    on the same weights and clips, calibrated on the first 2 clips
    (``int8_serving.serving_throughput``) -> {run: {clips_per_sec, ms,
    window_ms}}."""
    return serving_throughput(MODEL, ENGINES, B, T, CROP, iters=ITERS, windows=WINDOWS,
                              calib=2, device=device)["runs"]


def _buckets(rows, info) -> dict:
    """The JAX record's buckets of one traced forward, from the attribution
    rows (ms a forward)."""
    cat = {"conv_s8": 0.0, "conv_float": 0.0, "quantize_pass_s8out": 0.0, "other": 0.0}
    quant = []
    for r in rows:
        if r.role == "quant":
            cat["quantize_pass_s8out"] += r.us
            quant.append([round(r.us), r.path])
        elif r.path and "conv3d_s8" in r.kernel:
            cat["conv_s8"] += r.us
        elif r.path:
            cat["conv_float"] += r.us
        else:
            cat["other"] += r.us
    quant.sort(reverse=True)
    return {"total_ms": round(sum(cat.values()) / 1e3, 3),
            "ms": {k: round(v / 1e3, 3) for k, v in cat.items()},
            "top_quantize_passes_us": quant[:8],
            "device_busy_ms": round(info["device_us_per_step"] / 1e3, 3),
            "steps_captured": info["steps_captured"]}


def profile(device: str = "cuda") -> dict:
    """The int8 (default mode) and bf16 forwards traced and attributed."""
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, int8 in (("int8", "static"), ("bf16", None)):
            rows, _cats, info = profile_eval_step(
                MODEL, B, T, CROP, n_steps=STEPS, trace_dir=os.path.join(tmp, name), int8=int8,
                device=device)
            report[name] = _buckets(rows, info)
            print(f"[int8_kinetics] {name}: {json.dumps(report[name])}", file=sys.stderr,
                  flush=True)
    ub = report["int8"]["total_ms"] - report["int8"]["ms"]["quantize_pass_s8out"]
    report["epilogue_fused_upper_bound_ms"] = round(ub, 3)
    report["bf16_total_ms"] = report["bf16"]["total_ms"]
    report["upper_bound_speedup_vs_bf16"] = (round(report["bf16"]["total_ms"] / ub, 3)
                                             if ub > 0 else None)
    return report


def conclusion(report: dict, rates: dict) -> str:
    """What the run's numbers say, in the JAX record's terms."""
    i8 = report["int8"]
    share = i8["ms"]["quantize_pass_s8out"] / i8["total_ms"] if i8["total_ms"] else 0.0
    speedup = rates["int8"]["clips_per_sec"] / rates["bf16"]["clips_per_sec"]
    return (f"standalone quantize passes (Q2) take {share:.1%} of the int8 forward's attributed "
            f"device time ({i8['ms']['quantize_pass_s8out']} of {i8['total_ms']} ms; Q1's "
            f"epilogues quantize the rest in place); int8 convs {i8['ms']['conv_s8']} ms against "
            f"bf16's float convs {report['bf16']['ms']['conv_float']} ms; the epilogue-fused "
            f"upper bound is {report['upper_bound_speedup_vs_bf16']}x bf16's device time; "
            f"graphed clips/s int8 {rates['int8']['clips_per_sec']} against bf16 "
            f"{rates['bf16']['clips_per_sec']} ({speedup:.3f}x)")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rates = throughput(args.device)
    print(f"[int8_kinetics] clips/s: {json.dumps(rates)}", file=sys.stderr, flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    report = profile(args.device)
    result = {
        "date": time.strftime("%Y-%m-%d"),
        "source": ("fastvideotagging_tpu_torch/benchmarks/int8_kinetics.py (device-time "
                   "attribution: torch.profiler kernels joined to the engine's conv sites, "
                   f"{STEPS} traced forwards; clips/s of captured CUDA graphs)"),
        "geometry": f"{MODEL} B={B} {T}x{CROP}x{CROP}",
        **report,
        "bf16_clips_per_sec": rates["bf16"]["clips_per_sec"],
        "int8_clips_per_sec": rates["int8"]["clips_per_sec"],
        "int8_full_clips_per_sec": rates["int8_full"]["clips_per_sec"],
        "int8_dynamic_clips_per_sec": rates["int8_dynamic"]["clips_per_sec"],
        "int8_exact_residual_clips_per_sec": rates["int8_exact_residual"]["clips_per_sec"],
        "speedup_default": round(rates["int8"]["clips_per_sec"]
                                 / rates["bf16"]["clips_per_sec"], 3),
        "window_ms": {k: v["window_ms"] for k, v in rates.items()},
        "timing": (f"{'CUDA events' if dev.type == 'cuda' else 'the host clock'}, the fastest "
                   f"of {WINDOWS} windows of {ITERS} forwards after one not kept"),
        "conclusion": conclusion(report, rates),
        "device": args.device,
        "card": card() if dev.type == "cuda" else None,
    }
    line = json.dumps(result, indent=1)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
