"""The native serving tier on the card against the in-process forward (the
port of the JAX package's ``benchmarks/native_serving.py``, its rows field
for field):

  * ``parity``: r2plus1d_18, float32, B = 2: the CPU runner's scores of an
    AOTInductor CPU package (``export_serving_native(device='cpu')``, its
    convs the library's: the CPU runner loads no op library) against the
    in-process ``ServingFn`` on the same uint8 clips (max |diff| of the
    (B, 101) softmax scores);
  * ``throughput``: bf16, B = 8 uint8 clips of 16x128x171: the CUDA
    runner's ``--bench`` (21 instances of distinct content, a two-point
    slope) -> clips/s with no Python in the serving process;
  * ``daemon`` and ``daemon_pipelined``: the runner's ``--serve`` daemon
    (``NativeServer``) answering requests of B = 8 one at a time, and with
    ``--pipeline 2`` and three requests in flight (``request_many``; its
    replies held to the sequential daemon's on the same inputs);
  * ``int8``: the int8 engine's package through the runner's ``--bench``.

Each row carries the in-process forward beside it: the same serving
function (preprocess, backbone or int8 engine, head) run as ``Tagger``
runs it, the preprocess eager and the rest a captured CUDA graph
(evaluation/graphed.py), timed by CUDA events (the fastest of 3 windows
of 10 forwards after one not kept). The daemon rows are timed by
the host's clock (the forwards run in another process): the fastest of 3
windows of 12 requests after one not kept, every window written down.

The JAX record's ``plugin`` (the PJRT plugin the runner loads) has no
counterpart: the port's runner loads the op library of the hand kernels,
named under ``op_library``.

    python -m fastvideotagging_tpu_torch.benchmarks.native_serving \\
        --out fastvideotagging_tpu_torch/benchmarks/NATIVE_SERVING.json

Runs on the card (the parity row's package runs on the host either way).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.benchmarks.kernel_micro import card
from fastvideotagging_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
from fastvideotagging_tpu_torch.evaluation import serving
from fastvideotagging_tpu_torch.evaluation.graphed import Graphed
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.native import runner
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.utils.profiling import window_ms

CLIP = (16, 128, 171)  # T and the ship geometry of the serving input
CROP = (112, 112)
ITERS, WINDOWS = 10, 3  # the in-process forward's timing: forwards a window, windows kept
BENCH_ATTEMPTS = 3  # the runner leaves --bench out when its host slope is not positive
TOL = 5e-2  # the native rows' scores against the in-process forward


def _cfg(compute_dtype: str, kernels: str = "cuda") -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=101, compute_dtype=compute_dtype,
                          kernels=kernels),
        data=DataConfig(source_hw=CLIP[1:], resize_hw=CLIP[1:], crop_hw=CROP))


@functools.lru_cache(maxsize=1)
def _state() -> dict:
    """Seeded random weights, the same for every row (the JAX script's
    PRNGKey(0) init in each); the parameters are f32 whatever the compute
    dtype."""
    return model_from_config(_cfg("float32").model, device="cpu",
                             generator=torch.Generator().manual_seed(0)).state_dict()


def _clips(rng, *lead) -> np.ndarray:
    return rng.integers(0, 255, lead + CLIP + (3,)).astype(np.uint8)


def _in_process(fn, clips: np.ndarray, dev: torch.device) -> dict:
    """The serving function ``fn`` (a ``ServingFn``) in process on
    ``clips``, as ``Tagger`` runs it: the preprocess eager, the backbone and
    head a captured graph (``ServingFn.scores``). -> (its clips/s and
    windows, a callable for its scores)."""
    core = Graphed(fn.scores, "the in-process serving forward")
    d = fn.cfg.data

    def run(frames_u8):
        return core(preprocess_eval_clip(frames_u8, d.resize_hw, d.crop_hw, d.mean, d.std,
                                         out_dtype=fn.dtype))
    x = torch.from_numpy(clips).to(dev)
    ms = window_ms({"fwd": lambda: run(x)}, ITERS, WINDOWS, dev.type == "cuda")["fwd"]
    return {"in_process_graphed_clips_per_sec": round(clips.shape[0] / min(ms) * 1e3, 2),
            "in_process_window_ms": [round(t, 4) for t in ms]}, run


def _bench(package: str, clips: np.ndarray, workdir: str, dev: torch.device) -> dict:
    """The runner's --bench of ``package`` on ``clips`` (n, B, ...): its
    bench dict and last instance's scores, measured again where the runner
    found no positive slope."""
    for _ in range(BENCH_ATTEMPTS):
        summary = runner.run_summary(package, [clips], workdir, device=dev.type,
                                     bench=clips.shape[0], timeout=1800)
        if summary.get("bench") is not None:
            return summary
    raise RuntimeError(f"the runner's --bench found no positive slope in {BENCH_ATTEMPTS} runs")


def parity_row(workdir: str, dev: torch.device) -> dict:
    # the CPU runner loads no op library: the package's convs are the library's
    cfg = _cfg("float32", kernels="torch")
    sd = _state()
    pkg = serving.export_serving_native(cfg, sd, 2, os.path.join(workdir, "serve_f32.pt2"),
                                        device="cpu")
    clips = _clips(np.random.default_rng(0), 2)
    with torch.inference_mode():
        ref = serving.ServingFn(cfg, sd, device="cpu")(torch.from_numpy(clips)).float().numpy()
    out = runner.run_summary(pkg, [clips], os.path.join(workdir, "parity"), device="cpu")
    diff = float(np.abs(out["outputs"][0] - ref).max())
    print(f"[native_serving] parity (f32 scores, B=2): max abs diff {diff:.2e}", flush=True)
    return {"model": "r2plus1d_18", "compute_dtype": "float32", "clip_batch": 2,
            "max_abs_diff": diff, "runner": "cpu"}


def _bench_row(engine: str, workdir: str, dev: torch.device, batch: int = 8, n: int = 21,
               seed: int = 1) -> dict:
    cfg = _cfg("bfloat16")
    sd = {k: v.to(dev) for k, v in _state().items()}
    rng = np.random.default_rng(seed)
    qpack = None
    if engine == "int8":
        qpack = serving.quantize_for_serving(cfg, sd, [_clips(rng, batch)], device=dev)
    pkg = serving.export_serving_native(cfg, sd, batch,
                                        os.path.join(workdir, f"serve_{engine}.pt2"),
                                        qpack=qpack, device=dev)
    clips = _clips(rng, n, batch)
    summary = _bench(pkg, clips, os.path.join(workdir, f"bench_{engine}"), dev)
    bench = summary["bench"]
    fn = serving.ServingFn(cfg, sd, qpack=qpack, device=dev)
    inproc, in_process = _in_process(fn, clips[-1], dev)
    err = float(np.abs(summary["outputs"][0] - in_process(
        torch.from_numpy(clips[-1]).to(dev)).float().cpu().numpy()).max())
    if err > TOL:
        raise RuntimeError(f"the native {engine} package's scores lie {err} from the "
                           f"in-process forward's (tol {TOL})")
    sec = bench["sec_per_exec"]
    row = {"model": "r2plus1d_18",
           **({"engine": "int8"} if engine == "int8" else {"compute_dtype": "bfloat16"}),
           "clip_batch": batch, "bench_instances": n, "sec_per_exec": round(sec, 6),
           "clips_per_sec": round(batch / sec, 2), **bench,
           "launches": summary.get("launches"), "max_abs_diff_vs_in_process": err, **inproc}
    if engine == "int8":
        row["note"] = ("the int8 engine's static package (calibrated on one random uint8 batch: "
                       "a speed row; accuracy is the int8 records' job), the same --bench "
                       "protocol as the bf16 throughput row")
    print(f"[native_serving] {engine} runner --bench: {row['clips_per_sec']} clips/s "
          f"({sec * 1e3:.3f} ms/exec at B={batch}); in-process graphed "
          f"{inproc['in_process_graphed_clips_per_sec']} clips/s", flush=True)
    return row, pkg, fn


def throughput_row(workdir: str, dev: torch.device) -> tuple:
    return _bench_row("bf16", workdir, dev)


def int8_row(workdir: str, dev: torch.device) -> dict:
    return _bench_row("int8", workdir, dev, seed=3)[0]


def _daemon_row(pkg: str, fn, workdir: str, dev: torch.device, pipeline: int,
                batch: int = 8, n: int = 12) -> dict:
    """Requests of ``batch`` clips through the daemon, WINDOWS windows
    of ``n`` after one not kept (2 requests warm it first)."""
    rng = np.random.default_rng(2)
    reqs = [_clips(rng, batch) for _ in range(n + 2)]
    spec = [((batch,) + CLIP + (3,), np.uint8)]
    window_s = []
    with runner.NativeServer(pkg, spec, workdir, device=dev.type, pipeline=pipeline) as srv:
        for clips in reqs[:2]:
            srv.request([clips])
        for w in range(WINDOWS + 1):
            t0 = time.monotonic()
            if pipeline:
                outs = [o for o, in srv.request_many([c] for c in reqs[2:])]
            else:
                outs = [srv.request([c])[0] for c in reqs[2:]]
            if w:
                window_s.append((time.monotonic() - t0) / n)
        seq = [srv.request([c])[0] for c in reqs[2:4]]
    for a, b in zip(outs[:2], seq):
        np.testing.assert_array_equal(a, b)
    with torch.inference_mode():
        want = fn(torch.from_numpy(reqs[2]).to(dev)).float().cpu().numpy()
    err = float(np.abs(outs[0] - want).max())
    if err > TOL:
        raise RuntimeError(f"the daemon's scores lie {err} from the in-process forward's")
    inproc, _ = _in_process(fn, reqs[2], dev)
    sec = min(window_s)
    row = {"model": "r2plus1d_18", "compute_dtype": "bfloat16", "clip_batch": batch,
           "requests": n, **({"pipeline": pipeline} if pipeline else {}),
           "sec_per_request": round(sec, 6), "clips_per_sec": round(batch / sec, 2),
           "window_sec_per_request": [round(s, 6) for s in window_s],
           "max_abs_diff_vs_in_process": err, **inproc,
           "note": ("per-request wall time by the host's clock: the input file's write, the "
                    "stdin line, staging, the program and readback in the C++ runner, the "
                    "output file's read; the in-process graphed forward beside it takes "
                    "device-resident clips")}
    print(f"[native_serving] daemon{' pipelined' if pipeline else ''}: {row['clips_per_sec']} "
          f"clips/s ({sec * 1e3:.2f} ms/request at B={batch})", flush=True)
    return row


ROWS = ("parity", "throughput", "daemon", "int8", "daemon_pipelined")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("rows", nargs="*", help=f"the rows to run ({', '.join(ROWS)}; all by default)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--out", default=None,
                   help="the record (rows run alone are merged into it)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    names = args.rows or list(ROWS)
    record = {}
    if args.out and set(names) != set(ROWS) and os.path.exists(args.out):
        with open(args.out) as f:
            record = json.load(f)
    record.update(date=time.strftime("%Y-%m-%d"),
                  op_library=(os.path.basename(_build.build_op_library())
                              if dev.type == "cuda" else None))
    with tempfile.TemporaryDirectory() as workdir:
        bf16 = None
        for name in names:
            if name == "parity":
                record[name] = parity_row(workdir, dev)
            elif name == "int8":
                record[name] = int8_row(workdir, dev)
            else:
                if bf16 is None:
                    bf16 = throughput_row(workdir, dev)
                if name == "throughput":
                    record[name] = bf16[0]
                else:
                    record[name] = _daemon_row(bf16[1], bf16[2], os.path.join(workdir, name),
                                               dev, pipeline=2 if name.endswith("pipelined")
                                               else 0)
    record.update(device=args.device, card=card() if dev.type == "cuda" else None)
    line = json.dumps(record, indent=1)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return record


if __name__ == "__main__":
    main()
