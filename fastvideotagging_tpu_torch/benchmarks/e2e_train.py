"""``fit()`` end to end on the card: the throughput a user gets (the port of
the JAX package's ``benchmarks/e2e_train.py``, its config field for field:
the ``r2plus1d18_ucf101`` preset, B = 32, a synthetic ``.fvtpack`` of 512
videos of 20 frames at the ship geometry 128x171, 4 epochs, a speed row
every 8 steps).

The pack is written directly from ``data/synthetic.make_frames`` (no codec
round trip; the reader under test is ``data/packed.py``), then the real
``fit()`` runs with a JSONL sink: packed dataset -> clip gather on the
host's workers -> ``device_prefetch`` (pinned copies on a side stream) ->
the train step -> the metric sync and the JSONL row. Each row's
``samples_per_sec`` is fit's own: the wall time of ``log_every`` steps
between two metric syncs (loader, copy, device, sync). The first window
holds the kernels' first launches; the median of the rest is the result,
with every window written down.

Three variants: the default; ``--host-crop`` (the host ships crop_hw
frames); ``--device-cache`` (the whole pack on the card, each step's copy a
few KB of indices, ``data/device_cache.py``). Beside them: the H2D bound of
one batch of frames (CUDA events over pinned copies, the fastest of 3
windows) and the bare train step's clips/s
(``step_profiler.bench_train_step``), with e2e / bare.

    python -m fastvideotagging_tpu_torch.benchmarks.e2e_train --all \\
        --out fastvideotagging_tpu_torch/benchmarks/E2E_TRAIN.json

Runs on the card unless ``--device cpu``; ``--smoke`` takes a toy
geometry (tiny3d, 40x56, 4 frames, B = 4) for a mechanics check.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.config import PRESETS
from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.train.fit import fit
from fastvideotagging_tpu_torch.utils.profiling import window_ms
from fastvideotagging_tpu_torch.utils.step_profiler import bench_train_step

VARIANTS = {"e2e_train": {}, "e2e_train_host_crop": {"host_crop": True},
            "e2e_train_device_cache": {"device_cache": True}}
NOTE = ("median steady-state samples/sec over fit()'s logging windows (each the wall time of "
        "log_every steps: loader, H2D prefetch, device step, metric sync, JSONL write; the "
        "first window also holds the kernels' first launches). e2e / bare near 1: the loader "
        "hides behind the card; e2e near the H2D bound: the copy limits it.")


def write_synth_pack(path: str, num_videos: int, frames_per_video: int, hw,
                     num_classes: int = 8) -> None:
    """Synthetic frames -> pack (``write_pack_from_arrays``, no codec)."""
    h, w = hw
    write_pack_from_arrays(
        ((f"synth/v{i:05d}.mp4", i % num_classes, [],
          make_frames(i % num_classes, frames_per_video, h, w, seed=i))
         for i in range(num_videos)), path, hw)


def train_config(smoke: bool, epochs: int, log_every: int, host_crop: bool = False,
                 device_cache: bool = False):
    """The preset (or the toy geometry) with the variant's data knobs."""
    cfg = PRESETS["r2plus1d18_ucf101"]
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, host_crop=host_crop, cache_on_device=device_cache))
    if smoke:
        cfg = dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, name="tiny3d", num_classes=8),
            data=dataclasses.replace(cfg.data, resize_hw=(40, 56), crop_hw=(32, 32),
                                     num_workers=2,
                                     sampler=dataclasses.replace(cfg.data.sampler,
                                                                 clip_len=4)),
            train=dataclasses.replace(cfg.train, batch_size=4))
    return dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_epochs=epochs, log_every=log_every, checkpoint_dir=""))


def measure_h2d_bound(batch_shape, dev: torch.device) -> dict:
    """The copy of one batch of uint8 frames from pinned host memory to the
    card: MiB/s and the clips/s it bounds (CUDA events, the fastest of 3
    windows of 3 copies after one not kept)."""
    host = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, batch_shape, dtype=np.uint8)).pin_memory()
    dst = torch.empty(batch_shape, dtype=torch.uint8, device=dev)
    ms = min(window_ms({"h2d": lambda: dst.copy_(host, non_blocking=True)}, 3, 3)["h2d"])
    mib = host.numel() / 2**20
    return {"batch_mib": round(mib, 1), "h2d_mib_per_sec": round(mib / ms * 1e3, 1),
            "h2d_bound_clips_per_sec": round(batch_shape[0] / ms * 1e3, 1)}


def run(pack: str, pack_videos: int, epochs: int, log_every: int, smoke: bool,
        host_crop: bool = False, device_cache: bool = False, device: str = "cuda") -> dict:
    """One variant's row (the JAX script's ``run``) on an existing pack."""
    dev = resolve_device(device)
    cfg = train_config(smoke, epochs, log_every, host_crop, device_cache)
    batch = cfg.train.batch_size
    ship_hw = cfg.data.crop_hw if host_crop else cfg.data.resize_hw
    # with the device cache a step copies an index batch (KB): no frame bound;
    # the host has no copy to the card to measure
    h2d = {} if device_cache else (
        measure_h2d_bound((batch, cfg.data.sampler.clip_len) + tuple(ship_hw) + (3,), dev)
        if dev.type == "cuda" else dict.fromkeys(
            ("batch_mib", "h2d_mib_per_sec", "h2d_bound_clips_per_sec")))
    with tempfile.TemporaryDirectory() as tmp:
        jsonl = os.path.join(tmp, "metrics.jsonl")
        t0 = time.time()
        fit(cfg, pack, metrics_path=jsonl, device=dev)
        wall = time.time() - t0
        with open(jsonl) as f:
            rows = [json.loads(line) for line in f]
    speeds = [r["samples_per_sec"] for r in rows if "samples_per_sec" in r]
    if not speeds:
        raise RuntimeError("fit() logged no speed rows; lower log_every")
    steady = speeds[1:] or speeds
    return {
        "config": "smoke" if smoke else "r2plus1d18_ucf101",
        "host_crop": host_crop,
        "device_cache": device_cache,
        "batch_size": batch,
        "pack_videos": pack_videos,
        "pack_mib": round(os.path.getsize(pack) / 2**20, 1),
        "steps_per_epoch": pack_videos // batch,
        "epochs": epochs,
        "log_every": log_every,
        "e2e_clips_per_sec_median": round(statistics.median(steady), 2),
        "e2e_clips_per_sec_best": round(max(steady), 2),
        "first_window_clips_per_sec": round(speeds[0], 2),
        "wall_s_total": round(wall, 1),
        "speed_windows": [round(s, 1) for s in speeds],
        "data_wait_frac": [r.get("data_wait_frac") for r in rows if "samples_per_sec" in r],
        **h2d,
        "note": NOTE,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--videos", type=int, default=512)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--log-every", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="the toy geometry (tiny3d, 40x56, 4 frames, B = 4)")
    ap.add_argument("--host-crop", action="store_true",
                    help="ship crop_hw frames from the host")
    ap.add_argument("--device-cache", action="store_true",
                    help="the whole pack on the card, a step's copy the sampling indices")
    ap.add_argument("--all", action="store_true", help="the three variants on one pack")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--out", default=None,
                    help="the record (a variant run alone merges its row into it)")
    args = ap.parse_args(argv)
    if args.host_crop and args.device_cache:
        ap.error("--host-crop and --device-cache exclude each other (the cache ships no frames)")
    dev = resolve_device(args.device)
    names = (list(VARIANTS) if args.all else
             ["e2e_train_device_cache" if args.device_cache
              else "e2e_train_host_crop" if args.host_crop else "e2e_train"])
    record = {}
    if args.out and not args.all and os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        pack = os.path.join(tmp, "bench.fvtpack")
        t0 = time.time()
        cfg = train_config(args.smoke, args.epochs, args.log_every)
        write_synth_pack(pack, args.videos, args.frames, cfg.data.resize_hw)
        print(f"[e2e_train] pack: {args.videos} videos, "
              f"{os.path.getsize(pack) / 2**20:.0f} MiB, {time.time() - t0:.1f} s", flush=True)
        for name in names:
            row = run(pack, args.videos, args.epochs, args.log_every, args.smoke,
                      device=args.device, **VARIANTS[name])
            print(f"[e2e_train] {name}: {json.dumps(row)}", flush=True)
            record[name] = row
    d = cfg.data
    bare = bench_train_step(cfg.model.name, cfg.train.batch_size, d.sampler.clip_len,
                            d.crop_hw[0], d.resize_hw, device=args.device)["clips_per_sec"]
    for name in names:
        record[name]["bare_step_clips_per_sec"] = round(bare, 2)
        record[name]["e2e_over_bare_step"] = round(
            record[name]["e2e_clips_per_sec_median"] / bare, 3)
    record.update(date=time.strftime("%Y-%m-%d"), device=args.device,
                  card=card() if dev.type == "cuda" else None)
    line = json.dumps(record, indent=1)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
