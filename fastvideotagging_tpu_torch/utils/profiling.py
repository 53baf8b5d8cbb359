"""Tracing and step timing (the reference's ``utils/profiling.py``), and the
device-time breakdown of one forward, or of one training step, on the card.

* ``trace(logdir)``: a context manager around ``torch.profiler`` that
  writes a Chrome / Perfetto trace of the block into ``logdir``;
* ``sync(tree)``: waits for the device that holds the first tensor of a
  pytree;
* ``StepTimer``: seconds a step, warm-up steps left out, synchronized every
  ``sync_every`` steps;
* ``window_ms``: the speed scripts' protocol: ms a call of each of several
  runs by CUDA events, in windows that take the runs in turn, after one
  window not kept.

The breakdown:

    python -m fastvideotagging_tpu_torch.utils.profiling [--model r2plus1d_18]
        [--clip-batch 8] [--clip 16 112 112] [--iters 5] [--steps 20]
        [--train [--batch 32]] [--sites] [--int8]

Without ``--train``: the eval forward of a seeded random-weight model
(``--clip`` clips, 16x112x112 by default, bf16) with ``kernels='cuda'``,
``kernels='torch'`` and the fused engine on K4 (``ops/fused_infer.py``,
R(2+1)D only). With ``--int8``: the forward with ``kernels='cuda'`` beside
the int8 engine's (``ops/int8_infer.py``, on Q1 / Q2, through the model's
spec: any name of ``ops.arch_spec.COVERED_MODELS``), static and dynamic,
its qpack calibrated on the run's clips. With
``--train``: the training step of ``train/loop.py`` (preprocess, forward in
train mode, loss, backward, SGD) for the ``r2plus1d18_ucf101`` preset on
one seeded random batch of ``--batch`` clips, with ``kernels='cuda'`` and
``kernels='torch'``. With ``--sites``: K1 and K2 alone at each (2+1)D conv
site of r2plus1d_18 at ``--clip-batch`` clips, forward through the routed
``ops.spatial_conv`` / ``ops.temporal_conv`` and dx through autograd with
only x requiring its gradient (the backward runs the dx and no dw): the
device time of one call by kernel group, beside its CUDA-event time, which
also holds the host's work per call. Each traces ``--iters`` iterations with
``torch.profiler`` after a warm-up, and prints one JSON line per backend:
device time per iteration by kernel group, the device's busy time, the host
wall time and the idle share (1 - busy / wall). Then ``--steps`` more
iterations, untraced, each timed alone between two CUDA events and a
synchronize: the median, least and greatest time of one iteration.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from collections.abc import Mapping
from typing import Callable

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fastvideotagging_tpu_torch.models.zoo import get_model
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(logdir: str = "fvt_trace"):
    """Trace the block with ``torch.profiler`` (the host, and the card where
    there is one) and write it to ``<logdir>/trace.json`` as a Chrome /
    Perfetto trace. Yields ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def _first_tensor(tree):
    """The first tensor of a pytree: a tensor, mappings, lists and tuples of
    them, dataclasses (a TrainState) and modules (parameters, then buffers)."""
    if torch.is_tensor(tree):
        return tree
    if isinstance(tree, Mapping):
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    elif isinstance(tree, torch.nn.Module):
        items = list(tree.parameters()) + list(tree.buffers())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    else:
        return None
    for item in items:
        leaf = _first_tensor(item)
        if leaf is not None:
            return leaf
    return None


def sync(tree) -> None:
    """Wait until the device that holds the first tensor of ``tree`` has run
    all the work queued on it; a tensor on the host needs no wait. Raises on
    a tree without a tensor."""
    leaf = _first_tensor(tree)
    if leaf is None:
        raise ValueError("sync: the tree holds no tensor")
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)


class StepTimer:
    """Seconds a step over the steps after ``warmup``, counted as the
    reference's ``StepTimer`` counts them: the clock starts at step
    ``warmup`` and, every ``sync_every`` steps after it, the time since the
    last reading is credited to those ``sync_every`` steps.

    Each reading is the host clock right after ``sync`` of the step's
    result, so between two readings the host queues steps while the card
    runs them, and a reading covers both: the time a user waits for those
    steps. CUDA events would leave the host's share out."""

    def __init__(self, warmup: int = 2, sync_every: int = 10):
        self.warmup = warmup
        self.sync_every = sync_every
        self.steps = 0
        self.timed_steps = 0
        self.total = 0.0
        self._tic = None

    def step(self, result_tree) -> None:
        self.steps += 1
        if self.steps == self.warmup:
            sync(result_tree)
            self._tic = time.perf_counter()
            return
        if self.steps > self.warmup and (self.steps - self.warmup) % self.sync_every == 0:
            sync(result_tree)
            now = time.perf_counter()
            self.total += now - self._tic
            self.timed_steps += self.sync_every
            self._tic = now

    @property
    def seconds_per_step(self) -> float:
        return self.total / self.timed_steps if self.timed_steps else float("nan")


def window_ms(runs: dict, iters: int, windows: int, cuda: bool = True) -> dict:
    """ms per call of each run: ``windows`` windows, each timing ``iters``
    calls of every run in turn by CUDA events, after one such window that
    is not kept (the first windows of a process run slow) -> {run: [ms of
    each kept window]}. ``cuda=False``: the host's clock (a CPU run)."""
    out = {name: [] for name in runs}
    for w in range(windows + 1):
        events = {}
        for name, fn in runs.items():
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            else:
                t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            if cuda:
                end.record()
                events[name] = (start, end)
            elif w:
                out[name].append((time.perf_counter() - t0) * 1e3 / iters)
        if cuda:
            torch.cuda.synchronize()
        for name, (start, end) in events.items():
            if w:
                out[name].append(start.elapsed_time(end) / iters)
    return out


GROUPS = (  # first match wins; matched against the lower-cased kernel name
    ("K1 spatial_conv_hopper_kernel (+ weight layout, reduce)",
     ("spatial_conv_hopper_kernel", "spatial_conv_weight_kernel",
      "spatial_conv_reduce_kernel")),
    ("K2 temporal_conv_hopper_kernel (+ weight layout, pad, reduce)", ("temporal_conv_",)),
    ("K3 temporal_dw_hopper_kernel (+ pad, reduce)", ("temporal_dw",)),
    ("K4 fused_block_hopper_kernel (+ weight layout, reduce)", ("fused_block",)),
    ("library matmul (cuBLAS)", ("nvjet", "xmma_gemm", "gemv", "s16816gemm", "s1688gemm",
                                 "sgemm", "splitkreduce", "cublas")),
    ("library conv (cuDNN)", ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90",
                              "wgrad", "dgrad", "fprop")),
    ("optimizer (foreach SGD, clip)", ("multi_tensor", "foreach")),
    ("elementwise (BN, ReLU, add, casts)", ("elementwise", "vectorized", "unrolled")),
    ("reduction (BN statistics, pool, loss)", ("reduce", "softmax", "nll")),
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


# seconds of calls a trace starts with, left out: the card's first
# milliseconds of kernels after the profiler starts go unrecorded
PROFILER_RAMP_S = 0.05
_MEASURED = "fvt/measured"


def breakdown(run: Callable[[], object], iters: int) -> dict:
    """Trace ``iters`` calls of ``run`` after three warm-up calls, and calls
    for PROFILER_RAMP_S inside the trace that are left out."""
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < PROFILER_RAMP_S:
            run()
        torch.cuda.synchronize()
        with torch.profiler.record_function(_MEASURED):
            t0 = time.perf_counter()
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    start = min((e.time_range.start for e in events
                 if e.name == _MEASURED and e.device_type == DeviceType.CPU), default=None)
    if start is None:
        raise RuntimeError("the profiler recorded no measured window")
    groups: dict[str, float] = {}
    names: dict[str, float] = {}
    intervals = []
    for e in events:
        # the card's copy of the window's annotation is no kernel
        if (e.device_type != DeviceType.CUDA or e.time_range.start < start
                or e.is_user_annotation or e.name == _MEASURED):
            continue
        dur = e.time_range.elapsed_us()
        intervals.append((e.time_range.start, e.time_range.end))
        groups[_group(e.name)] = groups.get(_group(e.name), 0.0) + dur
        names[e.name] = names.get(e.name, 0.0) + dur
    if not intervals:
        raise RuntimeError("the profiler recorded no device activity")
    busy = _busy_us(intervals)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:16]
    return dict(
        ms_per_iter={g: v / iters / 1e3 for g, v in sorted(groups.items(),
                                                             key=lambda kv: -kv[1])},
        device_busy_ms_per_iter=busy / iters / 1e3,
        wall_ms_per_iter=wall_us / iters / 1e3,
        idle_share=1.0 - busy / wall_us,
        top_kernels_ms_per_iter=[(n[:120], v / iters / 1e3) for n, v in top],
    )


def event_ms(run: Callable[[], object], iters: int) -> dict:
    """``iters`` calls of ``run``, each between two CUDA events and followed
    by a synchronize: the spread of one call's time on the card, untraced."""
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return dict(median=times[len(times) // 2], min=times[0], max=times[-1])


def _forward_runs(args):
    from fastvideotagging_tpu_torch.models.zoo import CLIP_SHAPED

    kw = {"clip_shape": tuple(args.clip)} if args.model in CLIP_SHAPED else {}
    g = torch.Generator().manual_seed(0)
    state = get_model(args.model, num_classes=400, device="cpu", generator=g, **kw).state_dict()
    x = torch.randn((args.clip_batch, *args.clip, 3),
                    generator=torch.Generator(device="cuda").manual_seed(1),
                    device="cuda").to(torch.bfloat16)
    for backend in ("cuda",) if args.int8 else ("cuda", "torch"):
        model = get_model(args.model, num_classes=400, backend=backend, **kw)
        model.load_state_dict(state)

        def run(model=model):
            with torch.inference_mode():
                model(x)
        yield backend, dict(what="eval forward", clip_batch=args.clip_batch), run
    weights = {k: v.cuda() for k, v in state.items()}
    if args.int8:
        from fastvideotagging_tpu_torch.evaluation.quantized import quantize_for
        from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
        from fastvideotagging_tpu_torch.ops.int8_infer import int8_infer

        spec = spec_for(args.model)
        qpack = quantize_for(args.model, weights, [x])
        for mode in ("static", "dynamic"):
            def int8(dynamic=mode == "dynamic"):
                int8_infer(qpack, x, spec, dynamic=dynamic)
            yield f"int8_{mode}", dict(what="eval forward, int8 engine",
                                       clip_batch=args.clip_batch), int8
        return
    blocks = model.stage_blocks

    def fused():
        r2plus1d_fused_infer(weights, x, stage_blocks=blocks)
    yield "fused", dict(what="eval forward, fused engine", clip_batch=args.clip_batch), fused


def _train_runs(args):
    from fastvideotagging_tpu_torch.config import PRESETS
    from fastvideotagging_tpu_torch.train.loop import make_sample_batch, make_train_step
    from fastvideotagging_tpu_torch.train.state import create_train_state

    preset = PRESETS["r2plus1d18_ucf101"]
    preset = dataclasses.replace(
        preset, model=dataclasses.replace(preset.model, name=args.model),
        train=dataclasses.replace(preset.train, batch_size=args.batch))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {k: v.cuda() for k, v in make_sample_batch(preset).items()}
    batch["frames"] = torch.randint(0, 256, batch["frames"].shape, generator=gen,
                                    device="cuda", dtype=torch.uint8)
    batch["labels"] = (torch.arange(args.batch, device="cuda")
                       % preset.model.num_classes).int()
    for backend in ("cuda", "torch"):
        cfg = dataclasses.replace(
            preset, model=dataclasses.replace(preset.model, kernels=backend))
        state = create_train_state(cfg, steps_per_epoch=100,
                                   generator=torch.Generator().manual_seed(0))
        step = make_train_step(state.model, cfg)

        def run(step=step, state=state):
            step(state, batch, gen)
        yield backend, dict(what="training step", batch=args.batch), run
        del state, step, run
        torch.cuda.empty_cache()


def _site_runs(args):
    from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
    from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

    b = args.clip_batch
    sites = [("stem", ops.temporal_conv, (b, 16, 56, 56, 45), 64)]
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        sites += [(f"stage{stage + 1}", ops.spatial_conv, (b, t, hw, hw, c), m),
                  (f"stage{stage + 1}", ops.temporal_conv, (b, t, hw, hw, m), c)]
    gen = torch.Generator(device="cuda").manual_seed(2)
    for name, conv, xs, co in sites:
        c = xs[-1]
        taps = (3, 3) if conv is ops.spatial_conv else (3,)
        x = torch.randn(xs, generator=gen, device="cuda").to(torch.bfloat16)
        w = (torch.randn(taps + (c, co), generator=gen, device="cuda")
             / (9 * c) ** 0.5).to(torch.bfloat16)
        g = torch.randn(xs[:-1] + (co,), generator=gen, device="cuda").to(torch.bfloat16)
        xg = x.clone().requires_grad_(True)
        y = conv(xg, w)

        def fwd(conv=conv, x=x, w=w):
            with torch.inference_mode():
                conv(x, w)

        def dx(y=y, xg=xg, g=g):
            torch.autograd.grad(y, xg, g, retain_graph=True)
        what = dict(what=f"{conv.__name__} at {name}", x=list(xs), co=co, clip_batch=b)
        yield "cuda", dict(what, role="fwd"), fwd
        yield "cuda", dict(what, role="dx"), dx
        del x, w, g, xg, y, fwd, dx
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="r2plus1d_18")
    ap.add_argument("--clip-batch", type=int, default=8)
    ap.add_argument("--clip", type=int, nargs=3, default=(16, 112, 112), metavar=("T", "H", "W"))
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--sites", action="store_true")
    ap.add_argument("--int8", action="store_true")
    args = ap.parse_args()
    runs = _train_runs if args.train else _site_runs if args.sites else _forward_runs
    for backend, what, run in runs(args):
        res = breakdown(run, args.iters)
        res["event_ms_per_iter"] = event_ms(run, args.steps)
        print(json.dumps(dict(model=args.model, kernels=backend, **what,
                              device=torch.cuda.get_device_name(0), **res)), flush=True)


if __name__ == "__main__":
    main()
