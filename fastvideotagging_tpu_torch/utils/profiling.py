"""Device-time breakdown of one R(2+1)D forward on the card.

    python -m fastvideotagging_tpu_torch.utils.profiling [--model r2plus1d_18]
        [--clip-batch 8] [--iters 5]

Runs the eval forward of a seeded random-weight model (16x112x112 clips,
bf16) with ``kernels='cuda'`` and ``kernels='torch'``, traces ``--iters``
forwards with ``torch.profiler`` after a warm-up, and prints one JSON line
per backend: device time per forward by kernel group, the device's busy
time, the host wall time and the idle share (1 - busy / wall).
"""

from __future__ import annotations

import argparse
import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fastvideotagging_tpu_torch.models.zoo import get_model

GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("K1 spatial_conv_kernel", ("spatial_conv_kernel",)),
    ("K2 temporal_conv_kernel", ("temporal_conv_kernel",)),
    ("library conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90")),
    ("elementwise (BN, ReLU, add, casts)", ("elementwise", "vectorized", "unrolled")),
    ("reduction (pool)", ("reduce",)),
    ("copy / layout", ("copy", "memcpy", "memset", "cat")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def _busy_us(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def breakdown(model: torch.nn.Module, x: torch.Tensor, iters: int) -> dict:
    with torch.inference_mode():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                model(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    intervals = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        dur = e.time_range.elapsed_us()
        intervals.append((e.time_range.start, e.time_range.end))
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + dur
        names[e.name] = names.get(e.name, 0.0) + dur
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_us(intervals)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:12]
    return dict(
        ms_per_forward={g: v / iters / 1e3 for g, v in sorted(groups.items(),
                                                                key=lambda kv: -kv[1])},
        device_busy_ms_per_forward=busy / iters / 1e3,
        wall_ms_per_forward=wall_us / iters / 1e3,
        idle_share=1.0 - busy / wall_us,
        top_kernels_ms_per_forward=[(n[:120], v / iters / 1e3) for n, v in top],
    )


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r2plus1d_18")
    ap.add_argument("--clip-batch", type=int, default=8)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args()
    g = torch.Generator().manual_seed(0)
    state = get_model(args.model, num_classes=400, device="cpu", generator=g).state_dict()
    x = torch.randn((args.clip_batch, 16, 112, 112, 3),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    for backend in ("cuda", "torch"):
        model = get_model(args.model, num_classes=400, backend=backend)
        model.load_state_dict(state)
        res = breakdown(model, x, args.iters)
        print(json.dumps(dict(model=args.model, kernels=backend, clip_batch=args.clip_batch,
                              device=torch.cuda.get_device_name(0), **res)), flush=True)


if __name__ == "__main__":
    main()
