"""The remat policies against materializing ('none') in the train step on
the card (the port of the JAX package's ``benchmarks/remat_step.py``, its
arms field for field: r2plus1d_18 and r2plus1d_18_tpu, each of
``REMAT_POLICIES``, B = 32, 16x112x112 clips from 128x171 uint8).

Each arm runs in its own process (a fresh build, allocator and cache
state) and is repeated; the record keeps every observation and, per arm,
the fastest with its change against the model's 'none'
(``vs_none_pct`` > 0: the policy is faster than materializing). A process
times the preset's train step with ``utils/step_profiler.py``'s
``bench_train_step`` (CUDA events, the fastest of 3 windows of 5 steps
after one not kept). The reference's ``temp_bytes_mib`` is XLA's estimate
of the compiled step's temporary buffers; the port's is what the step
allocates on the card above the memory held before it (its peak).

    python -m fastvideotagging_tpu_torch.benchmarks.remat_step \\
        --out fastvideotagging_tpu_torch/benchmarks/REMAT_STEP.json
    python -m fastvideotagging_tpu_torch.benchmarks.remat_step --arm r2plus1d_18_tpu,mid

Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.models.r2plus1d import REMAT_POLICIES
from fastvideotagging_tpu_torch.utils.step_profiler import bench_train_step

MODELS = ("r2plus1d_18", "r2plus1d_18_tpu")
POLICIES = ("none", "full", "dots", "mid", "conv")
assert set(POLICIES) == set(REMAT_POLICIES)
CLIP_LEN, CROP, SOURCE_HW = 16, 112, (128, 171)  # clips cropped from uint8 frames
ITERS, WINDOWS = 5, 3  # train steps a timed window, windows kept
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_arm(model: str, policy: str, batch: int = 32, device: str = "cuda") -> dict:
    """One arm's row (the JAX script's ``run_arm``)."""
    tr = bench_train_step(model, batch, CLIP_LEN, CROP, SOURCE_HW, remat=policy, device=device,
                          iters=ITERS, windows=WINDOWS)
    return {
        "model": model,
        "remat": policy,
        "batch": batch,
        "step_ms": round(tr["step_s"] * 1e3, 2),
        "clips_per_sec": round(tr["clips_per_sec"], 1),
        "achieved_tflops": round(tr["achieved_tflops"], 1),
        "roofline_fraction": round(tr["roofline_fraction"], 4),
        "temp_bytes_mib": tr["peak_step_mib"],
        "window_ms": [round(t, 3) for t in tr["window_ms"]],
    }


def _child(args, model: str, policy: str) -> list[str]:
    return [sys.executable, "-m", "fastvideotagging_tpu_torch.benchmarks.remat_step",
            "--arm", f"{model},{policy}", "--batch", str(args.batch), "--device", args.device]


def summarize(arms: list[dict], models, policies) -> list[dict]:
    """Per (model, policy) the fastest observation, with ``vs_none_pct``
    against that model's 'none'."""
    best = {}
    for row in arms:
        if "error" in row:
            continue
        key = (row["model"], row["remat"])
        if key not in best or row["step_ms"] < best[key]["step_ms"]:
            best[key] = row
    table = []
    for model in models:
        base = best.get((model, "none"))
        for policy in policies:
            row = best.get((model, policy))
            if row is None:
                continue
            entry = {k: v for k, v in row.items() if k != "rep"}
            if base and policy != "none":
                entry["vs_none_pct"] = round((base["step_ms"] / row["step_ms"] - 1.0) * 100, 1)
            table.append(entry)
    return table


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arm", default=None, help="model,policy (the child process's arm)")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--repeats", type=int, default=2, help="fresh processes per arm")
    p.add_argument("--models", default=",".join(MODELS))
    p.add_argument("--policies", default=",".join(POLICIES))
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    resolve_device(args.device)

    if args.arm:
        model, policy = args.arm.split(",")
        row = run_arm(model, policy, args.batch, args.device)
        print(json.dumps(row))
        return row

    models, policies = args.models.split(","), args.policies.split(",")
    arms = []
    for model in models:
        for policy in policies:
            for rep in range(args.repeats):
                print(f"[remat_step] {model} remat={policy} rep {rep}...", file=sys.stderr,
                      flush=True)
                proc = subprocess.run(_child(args, model, policy), capture_output=True,
                                      text=True, timeout=1200, cwd=_ROOT)
                if proc.returncode != 0:
                    print(proc.stderr[-2000:], file=sys.stderr)
                    arms.append({"model": model, "remat": policy, "rep": rep,
                                 "error": "child failed: " + proc.stderr.strip()[-300:]})
                    continue
                row = json.loads(proc.stdout.strip().splitlines()[-1])
                row["rep"] = rep
                arms.append(row)
                print(f"[remat_step]   -> {row['step_ms']} ms, {row['clips_per_sec']} clips/s",
                      file=sys.stderr, flush=True)

    table = summarize(arms, models, policies)
    faster = [f"{r['model']}:{r['remat']}" for r in table if r.get("vs_none_pct", 0) > 0]
    result = {
        "benchmark": "remat_step_ab",
        "protocol": (f"per-arm fresh process, CUDA events, the fastest of {WINDOWS} "
                     f"windows of {ITERS} steps after one not kept "
                     "(step_profiler.bench_train_step), best of "
                     f"{args.repeats} processes per arm; vs_none_pct > 0 means the policy "
                     "is faster than materializing"),
        "batch": args.batch,
        "geometry": f"{CLIP_LEN}x{CROP}x{CROP} from {SOURCE_HW[0]}x{SOURCE_HW[1]} uint8",
        "best_per_arm": table,
        "all_observations": arms,
        "policies": ("none | full (a block keeps its input only) | dots (the outputs of its "
                     "convs; BN, ReLU and the add recomputed) | mid (all but the (2+1)D mid "
                     "activation) | conv (the temporal convs' outputs and the block input): "
                     "models/r2plus1d.py"),
        "conclusion": (f"faster than 'none': {', '.join(faster) or 'no policy'}; "
                       + "; ".join(f"{r['model']} {r['remat']} {r['vs_none_pct']:+.1f} %"
                                   for r in table if "vs_none_pct" in r)),
        "device": args.device,
        "card": card() if args.device == "cuda" else None,
    }
    line = json.dumps(result, indent=2)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
