"""SlowFast's train step and eval forward on the card: the faithful
dual-rate model against the time-to-channel packed ``_tpu`` variant (the
port of the JAX package's ``benchmarks/slowfast_step.py``, its config field
for field: B = 32, 16x112x112 clips from 128x171 uint8, 101 classes).

For each model: the train step's clips/s and seconds, the TF/s of its conv
operations and its conv roofline (``conv_roofline_seconds``) with the
roofline's share of the step, and the eval forward's clips/s as a captured
CUDA graph (``utils/step_profiler.py``'s ``bench_train_step`` /
``bench_inference``; CUDA events, the fastest of 3 windows after one not
kept, every window written down).

The models are different programs (the packed fast pathway does about 4x
the fast path's operations): clips/s compares them; each roofline share is
its own program's. The reference's finding that ``_tpu`` is faster was a
TPU lane-occupancy result; the H100's order is whatever this run measures.

    python -m fastvideotagging_tpu_torch.benchmarks.slowfast_step \\
        --out fastvideotagging_tpu_torch/benchmarks/SLOWFAST_STEP.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.utils.step_profiler import bench_inference, bench_train_step

MODELS = ("slowfast_r2plus1d", "slowfast_r2plus1d_tpu")
CLIP_LEN, CROP, SOURCE_HW = 16, 112, (128, 171)  # clips cropped from uint8 frames
ITERS, WINDOWS = 5, 3  # train steps a timed window (forwards: twice as many), windows kept
TIMING = ("CUDA events, the fastest of {windows} windows after one not kept (train: {iters} "
          "steps a window, eval: {fwd} forwards of a captured CUDA graph a window)")


def step_row(model: str, batch: int = 32, device: str = "cuda") -> dict:
    """The JAX record's row of ``model``, with each window's ms."""
    tr = bench_train_step(model, batch, CLIP_LEN, CROP, SOURCE_HW, device=device, iters=ITERS,
                          windows=WINDOWS)
    inf = bench_inference(model, batch, CLIP_LEN, CROP, device=device, iters=2 * ITERS,
                          windows=WINDOWS)
    return {
        "train_clips_per_sec": round(tr["clips_per_sec"], 2),
        "step_s": round(tr["step_s"], 5),
        "achieved_tflops": round(tr["achieved_tflops"], 2),
        "conv_roofline_step_s": round(tr["conv_roofline_step_s"], 5),
        "roofline_fraction": round(tr["roofline_fraction"], 4),
        "infer_clips_per_sec": round(inf["clips_per_sec"], 2),
        "train_window_ms": [round(t, 3) for t in tr["window_ms"]],
        "infer_window_ms": [round(t, 3) for t in inf["window_ms"]],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)

    rows = {}
    for model in MODELS:
        rows[model] = step_row(model, args.batch, args.device)
        print(f"[slowfast_step] {model}: {rows[model]}", file=sys.stderr, flush=True)
    faithful, packed = (rows[m]["train_clips_per_sec"] for m in MODELS)
    result = {"benchmark": "slowfast_train_step", "batch": args.batch,
              "geometry": f"{CLIP_LEN}x{CROP}x{CROP}", "rows": rows,
              "tpu_over_faithful_train": round(packed / faithful, 3),
              "tpu_over_faithful_infer": round(rows[MODELS[1]]["infer_clips_per_sec"]
                                               / rows[MODELS[0]]["infer_clips_per_sec"], 3),
              "timing": TIMING.format(windows=WINDOWS, iters=ITERS, fwd=2 * ITERS),
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
