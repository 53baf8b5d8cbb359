"""Per-kernel attribution of a train step or a serving forward on the card:
the counterpart of the reference's ``utils/step_profiler.py``.

The reference joins XLA's compiled HLO to a ``jax.profiler`` trace. The
port has no HLO: it joins its own inventory of the convs a step runs to a
``torch.profiler`` trace.

* The inventory (``ConvInventory``, ``int8_inventory``): every conv of a
  forward, with its input shape, kernel, strides, pads, output channels,
  dtype and module path (forward hooks on ``models/layers.py``'s
  ``Conv3D``, ``SpatialConv`` and ``TemporalConv``; for the int8 engine,
  its Q1 calls and bf16 convs under their conv ids). A train step adds
  each conv's dx (where its input needs a gradient: not the first conv's)
  and dw.
* The scopes (ops/scopes.py): while a step is traced, each conv's forward
  runs under ``fvt/fwd/<path>``, its backward nodes under
  ``fvt/bwd/<path>``, the hand kernels' dx and dw under ``fvt/dx/<path>``
  and ``fvt/dw/<path>``, the int8 engine's convs and quantize passes under
  ``fvt/fwd/<conv id>`` and ``fvt/quant/<site>``, and the train step's
  preprocess and update under ``fvt/preprocess`` and ``fvt/optimizer``.
* ``load_trace_durations``: the trace's device kernels, each joined to the
  host op that launched it (the kernel's "External id", else its runtime
  call's "correlation"), that op's chain of enclosing host events (by time
  on its thread) and the ``ProfilerStep#N`` mark around its launch.
* ``attribute``: one row a launch group (a conv site and role, or another
  kernel by category), with its time a step, TF/s, and its floor: the least
  time the card could take for the conv's work (``conv_work``), the larger
  of its operations at the dtype's peak and its bytes at the memory rate.
* ``conv_roofline_seconds``: the reference's op-level conv roofline of a
  step, a sum over every conv of max(flops / peak, bytes / bandwidth), the
  yardstick of the benchmark's north star.
* ``bench_train_step`` / ``bench_inference``: the reference's
  ``bench.bench_train_step`` / ``bench_inference`` on the port (the speed
  scripts' step and forward times, ``profiling.window_ms``'s protocol).

Usage (the card by default; ``--device cpu`` traces the host's ops in
place of the card's kernels):

    python -m fastvideotagging_tpu_torch.utils.step_profiler --model r2plus1d_18
    python -m fastvideotagging_tpu_torch.utils.step_profiler --eval [--int8 static]
"""

from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import glob
import json
import math
import os
import shutil
from typing import NamedTuple

import numpy as np
import torch

from fastvideotagging_tpu_torch.ops import scopes
from fastvideotagging_tpu_torch.utils.profiling import (
    PROFILER_RAMP_S,
    StepTimer,
    sync,
    trace,
    window_ms,
)

# Published H100 SXM peaks (NVIDIA's data sheet, dense): tensor-core rates
# by operand type (float32 outside the tensor cores: the port keeps TF32
# off), and the HBM3 rate.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "int8": 1979e12, "float32": 67e12}
PEAK_BYTES_S = 3.35e12
DTYPE_BYTES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "int8": 1, "uint8": 1}
ROLES = ("fwd", "dx", "dw")
# the port's hand kernels (K1-K4, Q1, Q2, with their helper kernels) by the
# parts of their names: each launch of one belongs to a conv site
HAND_KERNELS = {"spatial_conv_": "K1", "temporal_conv_": "K2", "temporal_dw": "K3",
                "fused_block": "K4", "conv3d_s8": "Q1", "quantize_s8": "Q2",
                "quantize_amax": "Q2"}


# ---------------------------------------------------------------------------
# The work of a conv: one source for every bound the port prints
# ---------------------------------------------------------------------------


def out_size(n: int, k: int, s: int, pad) -> int:
    return (n + pad[0] + pad[1] - k) // s + 1


def _axis_pairs(n: int, k: int, s: int, lo: int, out: int) -> int:
    """(output, tap) pairs along an axis whose input index falls inside it."""
    return sum(1 for o in range(out) for d in range(k) if 0 <= o * s - lo + d < n)


def _axis_reads(n: int, k: int, s: int, lo: int, out: int) -> int:
    """Input indices along an axis that some (output, tap) pair reads."""
    return len({o * s - lo + d for o in range(out) for d in range(k)} & set(range(n)))


class ConvWork(NamedTuple):
    """Operations and bytes of one conv call. ``x_bytes``: the activation
    read (x for fwd and dw, the output gradient g for dx); ``w_bytes``: the
    other operand read (the weights for fwd and dx, g for dw); ``y_bytes``:
    the output written (y, dx or dw)."""
    flops: float
    x_bytes: float
    w_bytes: float
    y_bytes: float

    @property
    def nbytes(self) -> float:
        return self.x_bytes + self.w_bytes + self.y_bytes


def conv_work(x_shape, kernel, strides, pads, co: int, dtype: str = "bfloat16",
              role: str = "fwd", *, taps: str = "inside", out_dtype: str | None = None,
              stored_c: int | None = None) -> ConvWork:
    """The work of a conv over x (N, T, H, W, C) with a (kt, kh, kw) kernel,
    ``strides``, ``pads`` ((lo, hi) for T, H, W) and ``co`` output channels,
    as its forward (``role`` 'fwd'), its input gradient ('dx') or its weight
    gradient ('dw'). Each operand is read once and the output written once,
    in ``dtype`` (the output in ``out_dtype``, ``dtype`` by default).
    ``stored_c``: the channels x and the weights are stored with (the int8
    engine pads C to 16), ``C`` by default.

    ``taps='inside'`` (the floors of the port's kernels): the operations of
    the (output, tap) pairs whose input falls inside x, 2 a multiply-add,
    none into the zero padding; x's bytes are the rows some tap reads (a
    strided 1x1x1 conv reads an eighth of x). ``taps='all'`` (the
    reference's ``conv_roofline_seconds``): 2 x the output's elements x the
    contraction (taps x C for fwd, taps x Co for dx, the output rows for
    dw), and every operand whole."""
    if role not in ROLES:
        raise ValueError(f"role must be one of {ROLES}, got {role!r}")
    n, t, h, w, c = x_shape
    cs = c if stored_c is None else stored_c
    spatial = (t, h, w)
    outs = [out_size(d, k, s, p) for d, k, s, p in zip(spatial, kernel, strides, pads)]
    rows_in, rows_out = n * t * h * w, n * math.prod(outs)
    ntaps = math.prod(kernel)
    eb, ob = DTYPE_BYTES[dtype], DTYPE_BYTES[out_dtype or dtype]
    if taps == "inside":
        pairs = n * math.prod(_axis_pairs(d, k, s, p[0], o) for d, k, s, p, o in
                              zip(spatial, kernel, strides, pads, outs))
        flops = 2.0 * pairs * c * co
        read = n * math.prod(_axis_reads(d, k, s, p[0], o) for d, k, s, p, o in
                             zip(spatial, kernel, strides, pads, outs))
    elif taps == "all":
        flops = {"fwd": 2.0 * rows_out * co * ntaps * c, "dx": 2.0 * rows_in * c * ntaps * co,
                 "dw": 2.0 * ntaps * c * co * rows_out}[role]
        read = rows_in
    else:
        raise ValueError(f"taps must be 'inside' or 'all', got {taps!r}")
    w_elems = ntaps * cs * co
    if role == "fwd":
        return ConvWork(flops, float(read * cs * eb), float(w_elems * eb),
                        float(rows_out * co * ob))
    if role == "dx":
        return ConvWork(flops, float(rows_out * co * eb), float(w_elems * eb),
                        float(rows_in * c * ob))
    return ConvWork(flops, float(read * cs * eb), float(rows_out * co * eb),
                    float(ntaps * c * co * ob))


def least_seconds(work: ConvWork, dtype: str) -> tuple[float, str]:
    """The least time the card could take for ``work`` and what bounds it:
    the larger of its operations at the dtype's peak and its bytes at the
    memory rate ('operations' or 'bytes')."""
    t_ops = work.flops / PEAK_FLOPS[dtype]
    t_bytes = work.nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# The conv inventory
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSite:
    """One conv of a forward, and the roles a step runs it in."""
    path: str
    x_shape: tuple
    kernel: tuple
    strides: tuple
    pads: tuple
    co: int
    dtype: str
    roles: tuple = ("fwd",)
    stored_c: int | None = None  # int8: the padded channels of x and the weights
    out_dtype: str | None = None  # int8: the output Q1 writes

    def work(self, role: str, taps: str = "inside") -> ConvWork:
        out = self.out_dtype if role == "fwd" else None
        if role == "dw" and taps == "inside":
            out = "float32"  # the gradient of an f32 parameter
        return conv_work(self.x_shape, self.kernel, self.strides, self.pads, self.co,
                         self.dtype, role, taps=taps, out_dtype=out, stored_c=self.stored_c)

    def floor_seconds(self, role: str) -> float:
        """The least time for ``role`` ('bwd': F.conv3d's backward, its dx
        where the site has one and its dw)."""
        roles = [r for r in ("dx", "dw") if r in self.roles] if role == "bwd" else [role]
        return sum(least_seconds(self.work(r), self.dtype)[0] for r in roles)

    def flops(self, role: str) -> float:
        roles = [r for r in ("dx", "dw") if r in self.roles] if role == "bwd" else [role]
        return sum(self.work(r).flops for r in roles)


def conv_part(path: str) -> str:
    """The reference's category part of a conv site: 'spatial', 'temporal',
    'downsample' or 'stem/other'."""
    parts = path.replace("/", ".").split(".")
    if "spatial" in parts:
        return "spatial"
    if "temporal" in parts:
        return "temporal"
    if any("down" in p for p in parts):
        return "downsample"
    return "stem/other"


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _module_site(path: str, module, x: torch.Tensor, train: bool) -> ConvSite:
    from fastvideotagging_tpu_torch.models.layers import (
        Conv3D,
        SpatialConv,
        TemporalConv,
        _conv_pads,
    )

    spatial = tuple(x.shape[1:4])
    if isinstance(module, SpatialConv):
        k, s, p = module.k, module.stride, module.k // 2
        kernel, strides, pads = (1, k, k), (1, s, s), ((0, 0), (p, p), (p, p))
    elif isinstance(module, TemporalConv):
        k, s, p = module.k, module.stride, module.k // 2
        kernel, strides, pads = (k, 1, 1), (s, 1, 1), ((p, p), (0, 0), (0, 0))
    elif isinstance(module, Conv3D):
        kernel, strides = module.kernel_size, module.strides
        pads = _conv_pads(module.padding, kernel, strides, spatial)
    else:
        raise TypeError(f"{path}: not a conv module: {type(module).__name__}")
    roles = ("fwd",)
    if train:
        roles += (("dx",) if x.requires_grad else ()) + ("dw",)
    return ConvSite(path, tuple(x.shape), tuple(kernel), tuple(strides),
                    tuple(tuple(p) for p in pads), module.kernel.shape[-1],
                    _dtype_name(module.dtype), roles)


def _backward_nodes(out: torch.Tensor, stop) -> list:
    """The autograd nodes a module's forward made: from the output's node
    back to (not into) the input's node and the parameters' accumulators."""
    seen, todo, nodes = set(), [out.grad_fn], []
    while todo:
        node = todo.pop()
        if node is None or node is stop or id(node) in seen:
            continue
        seen.add(id(node))
        if type(node).__name__ == "AccumulateGrad":
            continue
        nodes.append(node)
        todo.extend(fn for fn, _ in node.next_functions)
    return nodes


def _scoped_node(node, name: str) -> None:
    """Run ``node``'s backward under a record_function named ``name``."""
    open_ = []

    def pre(grad_outputs):
        rf = torch.profiler.record_function(name)
        rf.__enter__()
        open_.append(rf)

    def post(grad_inputs, grad_outputs):
        if open_:
            open_.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


class ConvInventory:
    """Forward hooks on every conv module of ``model``: each conv's site
    (the first forward that runs it: ``sites``, by path), and, while the
    scopes are on, its forward under ``fvt/fwd/<path>`` (the current site
    of ops/scopes.py, which the hand kernels' backward reads) and the
    backward nodes it made under ``fvt/bwd/<path>``. A context manager that
    removes the hooks on exit."""

    def __init__(self, model: torch.nn.Module):
        from fastvideotagging_tpu_torch.models.layers import Conv3D, SpatialConv, TemporalConv

        self.sites: dict[str, ConvSite] = {}
        self._open: list = []
        self._handles = []
        for path, m in model.named_modules():
            if isinstance(m, (Conv3D, SpatialConv, TemporalConv)):
                self._handles.append(m.register_forward_pre_hook(
                    lambda mod, args, path=path: self._pre(path, mod, args[0])))
                self._handles.append(m.register_forward_hook(
                    lambda mod, args, out, path=path: self._post(path, args[0], out)))

    def _pre(self, path, module, x):
        train = torch.is_grad_enabled() and module.kernel.requires_grad
        self.sites.setdefault(path, _module_site(path, module, x, train))
        stack = contextlib.ExitStack()
        stack.enter_context(scopes.site("fwd", path))
        self._open.append(stack)

    def _post(self, path, x, out):
        self._open.pop().close()
        if scopes.active() and torch.is_tensor(out) and out.grad_fn is not None:
            for node in _backward_nodes(out, x.grad_fn):
                _scoped_node(node, f"{scopes.PREFIX}bwd/{path}")

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()


@contextlib.contextmanager
def int8_inventory(qpack):
    """Record the int8 engine's convs while the block runs (one forward is
    enough): yields a dict {conv id: ConvSite} that fills as Q1 and the
    bf16 tail's convs run, each under its conv id (the scopes are on)."""
    from fastvideotagging_tpu_torch.ops import int8_conv, int8_infer

    sites: dict[str, ConvSite] = {}
    cin = {pack["wk"].data_ptr(): pack["w"].shape[3] for pack in qpack["convs"].values()}
    q1, bf16 = int8_conv.conv3d_s8, int8_infer._bf16_conv

    def rec_q1(q, wk, kernel_size, mul, add, s, strides, pads, relu=False, out_f32=False,
               residual=None, requant=None, amax=None):
        path = scopes.current_path()
        out = "int8" if requant is not None else "float32" if out_f32 else "bfloat16"
        sites.setdefault(path, ConvSite(
            path, tuple(q.shape[:-1]) + (cin[wk.data_ptr()],), tuple(kernel_size),
            tuple(strides), tuple(tuple(p) for p in pads), wk.shape[0], "int8",
            stored_c=q.shape[-1], out_dtype=out))
        return q1(q, wk, kernel_size, mul, add, s, strides, pads, relu, out_f32, residual,
                  requant, amax)

    def rec_bf16(x, kernel, strides, pads=None):
        pads = pads or tuple((k // 2, k // 2) for k in kernel.shape[:3])
        path = scopes.current_path()
        sites.setdefault(path, ConvSite(
            path, tuple(x.shape), tuple(kernel.shape[:3]), tuple(strides),
            tuple(tuple(p) for p in pads), kernel.shape[-1], "bfloat16"))
        return bf16(x, kernel, strides, pads)

    int8_conv.conv3d_s8, int8_infer._bf16_conv = rec_q1, rec_bf16
    try:
        with scopes.recording():
            yield sites
    finally:
        int8_conv.conv3d_s8, int8_infer._bf16_conv = q1, bf16


def conv_roofline_seconds(sites, peak_flops: float | None = None,
                          mem_bw: float = PEAK_BYTES_S) -> tuple[float, float, int]:
    """The reference's textbook op-level conv roofline of a step: for every
    conv the step runs (each site in each of its roles: fwd, dx, dw), the
    least time max(flops / peak, bytes / mem_bw) with the reference's
    counts (``conv_work(..., taps='all')``: 2 x output elements x
    contraction, every operand and the output once), summed. ``peak_flops``
    None takes each site's dtype's peak.

    Returns (roofline_seconds, total_conv_flops, n_convs)."""
    sec, flops, n = 0.0, 0.0, 0
    for site in sites:
        for role in site.roles:
            work = conv_work(site.x_shape, site.kernel, site.strides, site.pads, site.co,
                             site.dtype, role, taps="all", stored_c=site.stored_c)
            peak = peak_flops or PEAK_FLOPS[site.dtype]
            sec += max(work.flops / peak, work.nbytes / mem_bw)
            flops += work.flops
            n += 1
    return sec, flops, n


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_STEP = "ProfilerStep#"
_BACKWARD = "autograd::engine::evaluate_function"


@dataclasses.dataclass
class Kernel:
    """A device kernel (or, on a host trace, a leaf op) of a captured step,
    joined to its launch: the innermost conv site scope around it (role,
    path), the innermost region, and whether it ran in a backward."""
    name: str
    ts: float
    dur: float
    step: int
    role: str | None = None
    path: str | None = None
    region: str | None = None
    backward: bool = False
    joined: str = "external id"  # how the launch was found


@dataclasses.dataclass
class TraceDurations:
    kernels: list
    steps: list  # the step numbers the trace holds device work of
    device: str  # 'cuda' or 'cpu'
    busy_us: dict  # step -> device busy time (overlap counted once)
    sum_us: dict  # step -> sum of the kernels' durations
    outside: int = 0  # device events outside every step mark
    partial: tuple = ()  # steps the trace holds only part of, left out

    @property
    def steps_captured(self) -> int:
        return len(self.steps)

    @property
    def device_us_per_step(self) -> float:
        return sum(self.busy_us.values()) / max(len(self.steps), 1)

    @property
    def sum_us_per_step(self) -> float:
        return sum(self.sum_us.values()) / max(len(self.steps), 1)


def _busy(intervals) -> float:
    busy, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def _parents(events) -> dict:
    """{id(event): parent event} by time containment on each thread."""
    parent = {}
    by_thread = collections.defaultdict(list)
    for e in events:
        by_thread[(e["pid"], e["tid"])].append(e)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack = []
        for e in evs:
            end = e["ts"] + e["dur"]
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < end - 1e-3:
                stack.pop()
            if stack:
                parent[id(e)] = stack[-1]
            stack.append(e)
    return parent


def _trace_file(trace_dir: str) -> str:
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    return files[-1]


def load_trace_durations(trace_dir: str, device: str | None = None) -> TraceDurations:
    """The device work of each captured step of the newest trace under
    ``trace_dir``.

    A step is a ``ProfilerStep#N`` mark; a kernel belongs to the step whose
    mark spans its launch (on any thread: a CUDA backward runs on the
    autograd engine's). Steps are counted from the kernels the trace holds,
    not from the steps requested; on the card a step with fewer kernels
    than the others was captured in part and is left out (``partial``). ``device`` 'cuda' reads the card's
    kernels, copies and sets, and raises when the trace holds none; 'cpu'
    reads each host op's own time (its children's left out) as the device's
    work; None picks 'cuda' where the trace has device events."""
    with open(_trace_file(trace_dir)) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    host = [e for e in events if e.get("cat") in _HOST_CATS]
    dev_events = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if device is None:
        device = "cuda" if dev_events else "cpu"
    if device == "cuda" and not dev_events:
        raise RuntimeError("the profiler recorded no device activity")
    parent = _parents(host)
    marks = sorted((e["ts"], e["ts"] + e["dur"], int(e["name"][len(_STEP):]))
                   for e in host if e["name"].startswith(_STEP))
    starts = [m[0] for m in marks]

    def step_of(ts):
        i = bisect.bisect_right(starts, ts) - 1
        return marks[i][2] if i >= 0 and ts <= marks[i][1] else None

    if device == "cuda":
        by_ext = {e["args"]["External id"]: e for e in host
                  if e.get("cat") in ("cpu_op", "user_annotation")
                  and e.get("args", {}).get("External id")}
        by_corr = {e["args"]["correlation"]: e for e in host
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")
                   and "correlation" in e.get("args", {})}
        launches = []
        for k in dev_events:
            args = k.get("args", {})
            runtime = by_corr.get(args.get("correlation"))
            op = by_ext.get(args.get("External id"))
            joined = "external id"
            if op is None:
                op, joined = runtime, "correlation"
            launches.append((k, op, (runtime or op or k)["ts"], joined))
    else:  # each host op for its own time, its children's left out
        child_us = collections.defaultdict(float)
        for e in host:
            if id(e) in parent:
                child_us[id(parent[id(e)])] += e["dur"]
        launches = [(dict(e, dur=max(e["dur"] - child_us[id(e)], 0.0)), e, e["ts"], "host op")
                    for e in host if e.get("cat") == "cpu_op"]
    kernels, outside = [], 0
    for k, op, launch_ts, joined in launches:
        step = step_of(launch_ts)
        if step is None:
            outside += 1
            continue
        kern = Kernel(k["name"], k["ts"], k["dur"], step, joined=joined if op else "none")
        e = op
        while e is not None:
            parsed = scopes.parse(e["name"])
            if parsed and parsed[0] == "site" and kern.path is None:
                kern.role, kern.path = parsed[1], parsed[2]
            elif parsed and parsed[0] == "region" and kern.region is None:
                kern.region = parsed[1]
            if e["name"].startswith(_BACKWARD):
                kern.backward = True
            e = parent.get(id(e))
        kernels.append(kern)
    per_step = collections.Counter(k.step for k in kernels)
    partial = ()
    if device == "cuda" and per_step:
        # every step launches the same kernels: one with fewer was captured in
        # part (the card's first milliseconds after the profiler starts go
        # unrecorded), and its time would bias the mean
        full = max(per_step.values())
        partial = tuple(sorted(s for s, n in per_step.items() if n < full))
        kernels = [k for k in kernels if k.step not in partial]
    steps = sorted({k.step for k in kernels})
    sums = {s: sum(k.dur for k in kernels if k.step == s) for s in steps}
    # a host op's own time is spread between its children: its sum is its busy time
    busy = sums if device == "cpu" else {
        s: _busy((k.ts, k.ts + k.dur) for k in kernels if k.step == s) for s in steps}
    return TraceDurations(kernels, steps, device, busy, sums, outside, partial)


# ---------------------------------------------------------------------------
# Attribution
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Row:
    """One launch group: a conv site in one role, or the other kernels of one
    name in one category. Times a step."""
    us: float
    tflops: float
    floor_us: float | None
    path: str
    role: str
    kernel: str
    category: str
    launches: float

    @property
    def slack_us(self) -> float:
        return self.us - (self.floor_us or 0.0)


def category(kern: Kernel) -> str:
    """The reference's categories (``fwd_conv_spatial`` ...,
    ``bwd_elementwise/other``), with ``optimizer`` for the update and
    ``fwd_quantize`` for the int8 engine's quantize passes."""
    if kern.path is not None:
        if kern.role == "quant":
            return "fwd_quantize"
        return ("fwd_" if kern.role == "fwd" else "bwd_") + "conv_" + conv_part(kern.path)
    if kern.region in ("preprocess", "optimizer"):
        return kern.region
    return ("bwd_" if kern.backward else "fwd_") + "elementwise/other"


def _hand(name: str) -> str | None:
    """The hand kernel a device kernel's name belongs to, or None."""
    return next((k for part, k in HAND_KERNELS.items() if part in name), None)


def attribute(durations: TraceDurations, sites: dict):
    """-> (rows sorted by time, {category: us a step}, info).

    A conv row holds every kernel launched under one site and role (the
    conv's kernel and its helpers: weight layouts, pads, reduces), with the
    TF/s of the conv's operations (the taps inside the input) and its floor
    (``ConvSite.floor_seconds``); the other rows hold one kernel name in one
    category, with no floor. ``info``: the steps captured, the device's busy
    time a step and the sum of the kernels' times a step (equal where no two
    kernels overlap), the attributed time a step, the closure (the sum of
    the floors against the measured time of the rows that have one, and
    against all), the kernels the join could not place in a step, and the
    launches of the hand kernels (``HAND_KERNELS``) with the names of those
    found under no conv site, and the time a step of each hand kernel (with
    its helpers) and of all other kernels."""
    steps = max(durations.steps_captured, 1)
    groups: dict = {}
    for k in durations.kernels:
        cat = category(k)
        key = (cat, k.path, k.role) if k.path is not None else (cat, None, k.name)
        g = groups.setdefault(key, dict(us=0.0, n=0, names=collections.Counter()))
        g["us"] += k.dur
        g["n"] += 1
        g["names"][k.name] += k.dur
    rows, cats = [], collections.defaultdict(float)
    for (cat, path, role_or_name), g in groups.items():
        us = g["us"] / steps
        cats[cat] += us
        names = [n for n, _ in g["names"].most_common()]
        if path is None:
            rows.append(Row(us, 0.0, None, "", "", role_or_name[:100], cat, g["n"] / steps))
            continue
        site, role = sites.get(path), role_or_name
        floor = flops = None
        if site is not None and role != "quant":
            floor = site.floor_seconds(role) * 1e6
            flops = site.flops(role)
        rows.append(Row(us, flops / us / 1e6 if flops and us > 0 else 0.0, floor, path, role,
                        "; ".join(n[:60] for n in names[:3]), cat, g["n"] / steps))
    rows.sort(key=lambda r: -r.us)
    total = sum(r.us for r in rows)
    floored = [r for r in rows if r.floor_us is not None]
    floors = sum(r.floor_us for r in floored)
    info = dict(
        steps_captured=durations.steps_captured, device=durations.device,
        device_us_per_step=durations.device_us_per_step,
        kernel_sum_us_per_step=durations.sum_us_per_step,
        attributed_us_per_step=total,
        floors_us_per_step=floors,
        floored_measured_us_per_step=sum(r.us for r in floored),
        closure=floors / total if total else float("nan"),
        closure_floored=floors / sum(r.us for r in floored) if floored else float("nan"),
        outside_steps=durations.outside, partial_steps=list(durations.partial),
        unjoined=sum(1 for k in durations.kernels if k.joined == "none"),
        hand_kernels=sum(1 for k in durations.kernels if _hand(k.name)),
        by_kernel_us={name: sum(k.dur for k in durations.kernels
                                if (_hand(k.name) or "other") == name) / steps
                      for name in sorted({_hand(k.name) or "other"
                                          for k in durations.kernels})},
        hand_kernels_unplaced=sorted({k.name[:80] for k in durations.kernels
                                      if _hand(k.name) and k.path is None}))
    return rows, dict(sorted(cats.items(), key=lambda kv: -kv[1])), info


# ---------------------------------------------------------------------------
# Profiling a step
# ---------------------------------------------------------------------------


def _traced_steps(run, n_steps: int, trace_dir: str, dev: torch.device):
    """``run`` n_steps times under ``trace``, after unmarked steps for
    PROFILER_RAMP_S, each step marked ``ProfilerStep#i`` and timed between
    two CUDA events on the card (the host clock around a sync on the CPU).
    -> ms of each step."""
    import time

    shutil.rmtree(trace_dir, ignore_errors=True)
    cuda = dev.type == "cuda"
    marks = []
    with scopes.recording(), trace(trace_dir):
        t0 = time.perf_counter()
        while True:
            sync(run())
            if time.perf_counter() - t0 >= PROFILER_RAMP_S:
                break
        for i in range(n_steps):
            if cuda:
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"{_STEP}{i}"):
                out = run()
            if cuda:
                end.record()
                marks.append((start, end))
            else:
                sync(out)
                marks.append(time.perf_counter() - t0)
        sync(out)
    return [s.elapsed_time(e) for s, e in marks] if cuda else [t * 1e3 for t in marks]


def _timed(run, warmup: int, steps: int) -> float:
    timer = StepTimer(warmup=warmup, sync_every=steps)
    for _ in range(warmup + steps):
        timer.step(run())
    return timer.seconds_per_step


def _finish(run, sites, n_steps, trace_dir, dev, extra):
    before_s = _timed(run, 2, n_steps)
    step_ms = _traced_steps(run, n_steps, trace_dir, dev)
    durations = load_trace_durations(trace_dir, "cuda" if dev.type == "cuda" else "cpu")
    rows, cats, info = attribute(durations, sites)
    roof, flops, n = conv_roofline_seconds(sites.values())
    per_step = [durations.busy_us.get(i, 0.0) / 1e3 for i in range(n_steps)]
    info.update(extra, step_ms=step_ms, busy_ms=per_step,
                roofline_s=roof, conv_flops=flops, n_convs=n,
                step_timer_s=_timed(run, 2, n_steps), step_timer_before_s=before_s,
                sites=len(sites))
    return rows, cats, info


def _clips(shape, dev, seed: int = 0) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dev).to(torch.bfloat16)


def train_config(model_name: str = "r2plus1d_18", batch_size: int = 32, clip_len: int = 16,
                 crop: int = 112, source_hw=(128, 171), norm: str = "batch",
                 compute_dtype: str = "bfloat16", kernels: str = "cuda"):
    """The ``r2plus1d18_ucf101`` preset (101 classes, SGD) with the
    reference's keywords; its defaults are the preset's."""
    from fastvideotagging_tpu_torch.config import PRESETS

    p = PRESETS["r2plus1d18_ucf101"]
    return dataclasses.replace(
        p,
        model=dataclasses.replace(p.model, name=model_name, norm=norm, kernels=kernels,
                                  compute_dtype=compute_dtype),
        data=dataclasses.replace(p.data, source_hw=tuple(source_hw),
                                 resize_hw=tuple(source_hw), crop_hw=(crop, crop),
                                 sampler=dataclasses.replace(p.data.sampler,
                                                             clip_len=clip_len)),
        train=dataclasses.replace(p.train, batch_size=batch_size))


def _train_run(cfg, device):
    """(state, run): the preset's train step from seeded uint8 clips (as
    ``utils/profiling.py --train``); ``run()`` makes one step."""
    from fastvideotagging_tpu_torch._device import resolve_device
    from fastvideotagging_tpu_torch.train.loop import make_sample_batch, make_train_step
    from fastvideotagging_tpu_torch.train.state import create_train_state

    dev = resolve_device(device)
    state = create_train_state(cfg, steps_per_epoch=100, device=dev,
                               generator=torch.Generator().manual_seed(0))
    step = make_train_step(state.model, cfg)
    batch = make_sample_batch(cfg)
    rng = np.random.default_rng(0)
    batch["frames"] = torch.from_numpy(
        rng.integers(0, 256, batch["frames"].shape, dtype=np.uint8))
    batch["labels"] = (torch.arange(cfg.train.batch_size) % cfg.model.num_classes).int()
    batch = {k: v.to(dev) for k, v in batch.items()}
    gen = torch.Generator(device=dev).manual_seed(1)

    def run():
        return step(state, batch, gen)[1]["loss"]
    return state, run


def train_step_sites(cfg, device: str = "cuda") -> dict:
    """{path: ConvSite} of one train step of ``cfg`` (fwd, dx where the
    input needs it, dw)."""
    state, run = _train_run(cfg, device)
    with ConvInventory(state.model) as inv:
        sync(run())
    return inv.sites


def profile_train_step(model_name: str = "r2plus1d_18", batch_size: int = 32,
                       clip_len: int = 16, crop: int = 112, source_hw=(128, 171),
                       n_steps: int = 4, trace_dir: str = "fvt_step_trace",
                       norm: str = "batch", device: str = "cuda",
                       compute_dtype: str = "bfloat16"):
    """Trace and attribute ``n_steps`` train steps of the preset
    (``train_config``) after two warm-up steps. -> (rows, categories,
    info)."""
    cfg = train_config(model_name, batch_size, clip_len, crop, source_hw, norm, compute_dtype)
    state, run = _train_run(cfg, device)
    dev = next(state.model.parameters()).device
    with ConvInventory(state.model) as inv:
        for _ in range(2):
            sync(run())
        rows, cats, info = _finish(run, inv.sites, n_steps, trace_dir, dev,
                                   dict(what="train step", model=model_name,
                                        batch=batch_size))
    return rows, cats, info


def profile_eval_step(model_name: str = "r2plus1d_18", batch_size: int = 32,
                      clip_len: int = 16, crop: int = 112, n_steps: int = 4,
                      trace_dir: str = "fvt_eval_trace", int8: str | None = None,
                      device: str = "cuda", norm: str = "batch"):
    """Trace and attribute ``n_steps`` eval forwards of seeded random
    weights (101 classes, bf16) on seeded clips (B, clip_len, crop, crop, 3)
    after two warm-up forwards. ``int8`` 'static' or 'dynamic': the int8
    engine of ``model_name`` (any covered name), calibrated on the traced
    clips. -> (rows, categories, info)."""
    from fastvideotagging_tpu_torch._device import resolve_device
    from fastvideotagging_tpu_torch.models.zoo import CLIP_SHAPED, get_model

    dev = resolve_device(device)
    kw = {"clip_shape": (clip_len, crop, crop)} if model_name in CLIP_SHAPED else {}
    if norm != "batch":
        kw["norm"] = norm
    model = get_model(model_name, num_classes=101, device="cpu",
                      generator=torch.Generator().manual_seed(0), **kw).to(dev).eval()
    x = _clips((batch_size, clip_len, crop, crop, 3), dev)
    extra = dict(what=f"eval forward{', int8 ' + int8 if int8 else ''}", model=model_name,
                 batch=batch_size)
    if int8 is None:
        def run():
            with torch.inference_mode():
                return model(x)
        with ConvInventory(model) as inv:
            for _ in range(2):
                sync(run())
            return _finish(run, inv.sites, n_steps, trace_dir, dev, extra)
    if int8 not in ("static", "dynamic"):
        raise ValueError(f"int8 must be 'static' or 'dynamic', got {int8!r}")
    from fastvideotagging_tpu_torch.evaluation.quantized import quantize_for
    from fastvideotagging_tpu_torch.ops.arch_spec import spec_for
    from fastvideotagging_tpu_torch.ops.int8_infer import int8_infer

    variables = {k: v for k, v in model.state_dict().items()}
    qpack = quantize_for(model_name, variables, [x])
    spec, dynamic = spec_for(model_name), int8 == "dynamic"
    del model

    def run():
        return int8_infer(qpack, x, spec, dynamic=dynamic)
    with int8_inventory(qpack) as sites:
        sync(run())
    sync(run())
    return _finish(run, sites, n_steps, trace_dir, dev, extra)


def bench_train_step(model_name: str = "r2plus1d_18", batch_size: int = 32,
                     clip_len: int = 16, crop: int = 112, source_hw=(128, 171),
                     norm: str = "batch", remat: str = "none", device: str = "cuda",
                     iters: int = 5, windows: int = 3) -> dict:
    """The reference's ``bench.bench_train_step`` on the port: the preset's
    train step (``train_config`` with ``remat``) from seeded uint8 clips,
    timed by ``window_ms`` (the fastest of ``windows`` windows of ``iters``
    steps after one not kept; the host clock on the CPU). The reference
    divides XLA's count of the step's operations by its time; the port has
    no compiler's count, so ``achieved_tflops`` is the conv operations of the
    step (fwd, dx, dw at every site, ``conv_work``'s count with every tap)
    over its time, and ``conv_roofline_step_s`` is ``conv_roofline_seconds``
    of the same sites. ``peak_step_mib``: the memory a step allocates above
    what is held before it (the card only; None on the CPU)."""
    cfg = train_config(model_name, batch_size, clip_len, crop, source_hw, norm)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=remat))
    state, run = _train_run(cfg, device)
    dev = next(state.model.parameters()).device
    cuda = dev.type == "cuda"
    with ConvInventory(state.model) as inv:
        sync(run())
    roof, flops, _ = conv_roofline_seconds(inv.sites.values())
    peak = None
    if cuda:
        torch.cuda.synchronize(dev)
        held = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        sync(run())
        peak = round((torch.cuda.max_memory_allocated(dev) - held) / 2**20, 1)
    ms = window_ms({"step": run}, iters, windows, cuda)["step"]
    sec = min(ms) / 1e3
    return dict(clips_per_sec=batch_size / sec, step_s=sec, achieved_tflops=flops / sec / 1e12,
                conv_flops=flops, conv_roofline_step_s=roof, roofline_fraction=roof / sec,
                window_ms=ms, peak_step_mib=peak)


def bench_inference(model_name: str = "r2plus1d_18", batch_size: int = 32, clip_len: int = 16,
                    crop: int = 112, device: str = "cuda", iters: int = 10,
                    windows: int = 3) -> dict:
    """The reference's ``bench.bench_inference`` on the port: the eval
    forward of seeded random weights (101 classes, bf16) on seeded clips as
    one captured CUDA graph (evaluation/graphed.py; the reference times a
    jitted forward), timed by ``window_ms`` -> {clips_per_sec, ms,
    window_ms}."""
    from fastvideotagging_tpu_torch._device import resolve_device
    from fastvideotagging_tpu_torch.evaluation.graphed import Graphed
    from fastvideotagging_tpu_torch.models.zoo import get_model

    dev = resolve_device(device)
    model = get_model(model_name, num_classes=101, device="cpu",
                      generator=torch.Generator().manual_seed(0)).to(dev).eval()
    x = _clips((batch_size, clip_len, crop, crop, 3), dev)
    fwd = Graphed(model, f"the {model_name} eval forward")
    ms = window_ms({"fwd": lambda: fwd(x)}, iters, windows, dev.type == "cuda")["fwd"]
    return dict(clips_per_sec=batch_size / min(ms) * 1e3, ms=min(ms), window_ms=ms)


def format_report(rows, cats, info, top: int = 30) -> str:
    """The reference's printout: steps captured, categories, the closure,
    the rows with the largest slack."""
    total = info["attributed_us_per_step"]
    lines = [
        f"trace: {info['steps_captured']} step(s) captured on the {info['device']} (in part, "
        f"left out: {info['partial_steps']}), device "
        f"busy {info['device_us_per_step'] / 1e3:.3f} ms/step (kernels' sum "
        f"{info['kernel_sum_us_per_step'] / 1e3:.3f}, attributed {total / 1e3:.3f})",
        f"== categories ({total / 1e3:.3f} ms/step) =="]
    lines += [f"{v / 1e3:9.3f} ms  {100 * v / total:5.1f}%  {k}" for k, v in cats.items()]
    lines.append(
        f"floors of the conv rows {info['floors_us_per_step'] / 1e3:.3f} ms against their "
        f"{info['floored_measured_us_per_step'] / 1e3:.3f} ms measured (closure "
        f"{info['closure_floored']:.3f}) and {total / 1e3:.3f} ms in all ({info['closure']:.3f})")
    lines.append(f"conv roofline (the reference's): {info['roofline_s'] * 1e3:.3f} ms over "
                 f"{info['n_convs']} convs, {info['conv_flops'] / 1e9:.3f} GFLOP")
    lines.append("by kernel: " + ", ".join(f"{k} {v / 1e3:.3f} ms"
                                            for k, v in info["by_kernel_us"].items()))
    lines.append("== largest slack (measured - floor) ==")
    for r in sorted(rows, key=lambda r: -r.slack_us)[:top]:
        floor = "     -" if r.floor_us is None else f"{r.floor_us:6.0f}"
        where = f"{r.role} {r.path}" if r.path else r.category
        lines.append(f"{r.us:9.1f} us (floor {floor})  {r.tflops:6.1f} TF/s  "
                     f"x{r.launches:<5.1f} {where[:50]:50s} {r.kernel[:60]}")
    return "\n".join(lines)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="r2plus1d_18")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--clip-len", type=int, default=16)
    p.add_argument("--crop", type=int, default=112)
    p.add_argument("--norm", default="batch")
    p.add_argument("--top", type=int, default=30)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--eval", action="store_true",
                   help="profile the eval-mode forward instead of the train step")
    p.add_argument("--int8", choices=("static", "dynamic"), default=None,
                   help="with --eval: the int8 engine")
    p.add_argument("--device", default="cuda")
    p.add_argument("--trace-dir", default=None)
    args = p.parse_args(argv)
    if args.int8 and not args.eval:
        p.error("--int8 profiles the serving forward: give --eval")
    if args.eval:
        rows, cats, info = profile_eval_step(
            args.model, args.batch, args.clip_len, args.crop, args.steps,
            args.trace_dir or "fvt_eval_trace", int8=args.int8, device=args.device,
            norm=args.norm)
    else:
        rows, cats, info = profile_train_step(
            args.model, args.batch, args.clip_len, args.crop, n_steps=args.steps,
            trace_dir=args.trace_dir or "fvt_step_trace", norm=args.norm, device=args.device)
    if args.device != "cpu" and torch.cuda.is_available():
        print(f"device: {torch.cuda.get_device_name(0)}")
    print(format_report(rows, cats, info, args.top))
    print(f"steps: {['%.3f' % v for v in info['step_ms']]} ms by "
          f"{'CUDA events' if info['device'] == 'cuda' else 'the host clock'}, busy "
          f"{['%.3f' % v for v in info['busy_ms']]} ms; StepTimer "
          f"{info['step_timer_s'] * 1e3:.3f} ms/step untraced after the trace, "
          f"{info['step_timer_before_s'] * 1e3:.3f} before it")
    return rows, cats, info


if __name__ == "__main__":
    main()
