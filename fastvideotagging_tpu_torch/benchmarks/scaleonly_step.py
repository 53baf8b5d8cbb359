"""``norm='scaleonly'`` against batch norm in the train step on the card
(the port of the JAX package's ``benchmarks/scaleonly_step.py``, its arms
field for field: the ``_tpu`` model with batch and with scaleonly norm, the
faithful model with scaleonly; B = 32, 16x112x112 clips from 128x171
uint8, 101 classes).

Each arm's train step (``utils/step_profiler.py::bench_train_step``):
clips/s, seconds, the TF/s of its conv operations and the share of the
step its conv roofline takes; the conv inventory is the same under either
norm, so the shares compare directly. CUDA events, the fastest of 3
windows of 5 steps after one not kept, every window written down.

    python -m fastvideotagging_tpu_torch.benchmarks.scaleonly_step \\
        --out fastvideotagging_tpu_torch/benchmarks/SCALEONLY_STEP.json

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.utils.step_profiler import bench_train_step

ARMS = (("r2plus1d_18_tpu", "batch"), ("r2plus1d_18_tpu", "scaleonly"),
        ("r2plus1d_18", "scaleonly"))
CLIP_LEN, CROP, SOURCE_HW = 16, 112, (128, 171)  # clips cropped from uint8 frames
ITERS, WINDOWS = 5, 3  # train steps a timed window, windows kept
TIMING = "CUDA events, the fastest of {windows} windows of {iters} steps after one not kept"


def arm_row(model: str, norm: str, batch: int = 32, device: str = "cuda") -> dict:
    """The JAX record's row of one arm, with each window's ms."""
    tr = bench_train_step(model, batch, CLIP_LEN, CROP, SOURCE_HW, norm=norm, device=device,
                          iters=ITERS, windows=WINDOWS)
    return {
        "clips_per_sec": round(tr["clips_per_sec"], 2),
        "step_s": round(tr["step_s"], 5),
        "achieved_tflops": round(tr["achieved_tflops"], 2),
        "conv_roofline_step_s": round(tr["conv_roofline_step_s"], 5),
        "roofline_fraction": round(tr["roofline_fraction"], 4),
        "window_ms": [round(t, 3) for t in tr["window_ms"]],
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", default=None)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    resolve_device(args.device)

    rows = {}
    for model, norm in ARMS:
        key = f"{model}+{norm}"
        rows[key] = arm_row(model, norm, args.batch, args.device)
        print(f"[scaleonly_step] {key}: {rows[key]}", file=sys.stderr, flush=True)
    result = {"benchmark": "scaleonly_train_step", "batch": args.batch, "rows": rows,
              "geometry": f"{CLIP_LEN}x{CROP}x{CROP}",
              "timing": TIMING.format(windows=WINDOWS, iters=ITERS),
              "device": args.device, "card": card() if args.device == "cuda" else None}
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
