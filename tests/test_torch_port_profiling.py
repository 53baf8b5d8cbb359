"""The port's profiling tier (utils/profiling.py's ``trace``, ``sync``,
``StepTimer``; utils/step_profiler.py) against the JAX package's, on the
CPU.

- ``StepTimer`` counts the steps it times as the reference's does, on the
  same sequences;
- ``sync`` finds the first tensor of nested trees and refuses a tree with
  none; ``trace`` writes a Chrome trace;
- ``conv_roofline_seconds``: the reference reads the CPU-compiled HLO of
  the JAX ``make_train_step`` for r2plus1d_18 (B = 2, 4x64x64 crops, f32);
  the port reads the convs its own train step runs on the same config
  (``train_step_sites``). Both list the same 110 convs (37 forwards, 37
  weight gradients, 36 input gradients: the stem's input needs none) with
  the same flops and bytes each, and the same roofline at the same peaks
  (1e-6 relative). XLA on the CPU rewrote none of them at this size. At
  4x32x32 it does: stage 4's frame is 2x2, smaller than its 3x3 spatial
  taps, and XLA turns those convs inside out (the frame as the window,
  ``dim_labels=012fb_o012i->f012b``): the three stride-1 spatial forwards
  and dx's and the strided stage entry's dx, seven convs whose operands the
  reference's count then reads as other dims (65,536 flops for the
  84,934,656 of a forward);
- ``attribute`` on a synthetic trace: the join of kernels to their launch
  (by "External id", else by the runtime call's "correlation"), the
  categories, the per-step normalization by the steps captured, the
  floors and the closure;
- ``step_profiler.main`` at tiny3d size on the CPU, train and eval, and the
  int8 engine's scopes on r2plus1d_18;
- ``conv_work`` against the formulas chip_smoke.py used before it moved
  there, at the kernel table's sites and at Q1's forms.
"""

import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.models import model_from_config as jmodel_from_config
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train import loop as jloop
from fastvideotagging_tpu.train.state import create_train_state as jcreate_train_state
from fastvideotagging_tpu.utils import profiling as jprofiling
from fastvideotagging_tpu.utils import step_profiler as jsp
from fastvideotagging_tpu_torch.ops import scopes
from fastvideotagging_tpu_torch.utils import profiling, step_profiler as sp


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    """Two intra-op threads: the suite runs six workers side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("warmup,sync_every,steps", [(2, 3, 11), (1, 1, 5), (3, 4, 3),
                                                     (2, 10, 25), (4, 2, 9)])
def test_step_timer_counts_as_the_reference(warmup, sync_every, steps):
    got = profiling.StepTimer(warmup=warmup, sync_every=sync_every)
    want = jprofiling.StepTimer(warmup=warmup, sync_every=sync_every)
    for i in range(steps):
        got.step({"loss": torch.full((2,), float(i))})
        want.step(jnp.full((2,), float(i)))
    assert (got.steps, got.timed_steps) == (want.steps, want.timed_steps)
    if want.timed_steps:
        assert got.seconds_per_step >= 0.0 and got.total >= 0.0
    else:
        assert math.isnan(got.seconds_per_step) and math.isnan(want.seconds_per_step)
    if (warmup, sync_every, steps) == (2, 3, 11):
        assert got.timed_steps == 9  # the reference test's sequence


def test_sync_finds_the_first_tensor():
    t = torch.ones(3)
    profiling.sync({"a": [(), {"b": (t, torch.zeros(1))}]})
    profiling.sync(torch.nn.Linear(2, 2))
    state = sp._train_run(sp.train_config("tiny3d", 2, 4, 32, (32, 32)), "cpu")[0]
    assert profiling._first_tensor(state) is next(state.model.parameters())
    profiling.sync(state)
    assert profiling._first_tensor([[], {"x": None}, (5, t)]) is t
    with pytest.raises(ValueError, match="no tensor"):
        profiling.sync({"a": [1, "b"]})


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tr")) as logdir:
        with torch.profiler.record_function("fvt/fwd/probe"):
            torch.ones(4, 4) @ torch.ones(4, 4)
    assert logdir == str(tmp_path / "tr")
    with open(tmp_path / "tr" / profiling.TRACE_FILE) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"fvt/fwd/probe", "aten::mm"} <= names


# --------------------------------------------------------------------------
# the conv roofline against the reference's on the compiled JAX step
# --------------------------------------------------------------------------

ROOF = dict(model_name="r2plus1d_18", batch_size=2, clip_len=4, crop=64, source_hw=(64, 64),
            compute_dtype="float32")
PEAK, BW = 1e12, 1e9  # the same peaks on both sides (low: both bounds bind somewhere)


def _jax_step_hlo():
    p = jconfig.PRESETS["r2plus1d18_ucf101"]
    cfg = dataclasses.replace(
        p, model=dataclasses.replace(p.model, compute_dtype="float32"),
        data=dataclasses.replace(p.data, source_hw=(64, 64), resize_hw=(64, 64), crop_hw=(64, 64),
                                 sampler=dataclasses.replace(p.data.sampler, clip_len=4)),
        train=dataclasses.replace(p.train, batch_size=2))
    model = jmodel_from_config(cfg.model)
    tx = jlr.make_optimizer(cfg.train, steps_per_epoch=100)
    state = jcreate_train_state(model, tx, jax.random.PRNGKey(0),
                                jnp.zeros((1, 4, 64, 64, 3), jnp.float32))
    step = jloop.make_train_step(model, cfg, donate=False)
    batch = jloop.make_sample_batch(cfg)
    return jax.jit(step).lower(state, batch, jax.random.PRNGKey(1)).compile().as_text()


def test_conv_roofline_matches_the_reference_on_the_compiled_step():
    hlo = _jax_step_hlo()
    _, comp_convs = jsp.parse_hlo(hlo)
    want = sorted((fl, nb) for convs in comp_convs.values() for *_, fl, nb in convs)
    sites = sp.train_step_sites(sp.train_config(**ROOF), device="cpu")
    got = sorted((w.flops, w.nbytes) for s in sites.values() for w in
                 (s.work(r, taps="all") for r in s.roles))
    roles = [r for s in sites.values() for r in s.roles]
    assert (roles.count("fwd"), roles.count("dx"), roles.count("dw")) == (37, 36, 37)
    assert "dx" not in sites["stem_spatial"].roles
    # conv by conv: XLA rewrote no conv of this step into another op
    assert got == want
    sec, flops, n = sp.conv_roofline_seconds(sites.values(), PEAK, BW)
    jsec, jflops, jn = jsp.conv_roofline_seconds(hlo, PEAK, BW)
    assert n == jn == 110
    assert flops == pytest.approx(jflops, rel=1e-6)
    assert sec == pytest.approx(jsec, rel=1e-6)


# --------------------------------------------------------------------------
# attribute on a synthetic trace
# --------------------------------------------------------------------------

SITE = sp.ConvSite("stage1_block0.conv1.spatial", (2, 4, 8, 8, 64), (1, 3, 3),
                   (1, 1, 1), ((0, 0), (1, 1), (1, 1)), 144, "bfloat16", ("fwd", "dx", "dw"))
DOWN = sp.ConvSite("stage2_block0.downsample", (2, 4, 8, 8, 64), (1, 1, 1),
                   (2, 2, 2), ((0, 0), (0, 0), (0, 0)), 128, "bfloat16", ("fwd", "dx", "dw"))


def _x(name, ts, dur, cat="cpu_op", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": args}


def _k(name, ts, dur, ext, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"External id": ext, "correlation": corr}}


def _synthetic_trace(path):
    """Four step marks, all the device work in two of them, a kernel in a
    third, none in the fourth: per full step a K1 forward
    at SITE (with its weight layout), its dx on the backward thread (joined
    by the runtime call's correlation only), a cuDNN backward at DOWN, a
    preprocess copy, a ReLU, its backward and the optimizer."""
    ev = []
    for step in range(2):
        t0 = 1000.0 * step
        ev += [_x(f"ProfilerStep#{step}", t0, 900, "user_annotation", **{"External id": 100}),
               _x("fvt/preprocess", t0 + 1, 20, "user_annotation"),
               _x("aten::copy_", t0 + 2, 10, **{"External id": 10 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 3, 2, "cuda_runtime", correlation=1 + 100 * step,
                  **{"External id": 10 + 100 * step}),
               _x(f"fvt/fwd/{SITE.path}", t0 + 30, 40, "user_annotation"),
               _x("fvt::spatial_conv", t0 + 31, 30, **{"External id": 11 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 32, 2, "cuda_runtime", correlation=2 + 100 * step),
               _x("cudaLaunchKernel", t0 + 35, 2, "cuda_runtime", correlation=3 + 100 * step),
               _x("aten::relu", t0 + 80, 5, **{"External id": 12 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 81, 2, "cuda_runtime", correlation=4 + 100 * step),
               # the backward, on the autograd engine's thread
               _x("autograd::engine::evaluate_function: ReluBackward0", t0 + 100, 20, tid=2),
               _x("aten::threshold_backward", t0 + 101, 10, tid=2,
                  **{"External id": 13 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 102, 2, "cuda_runtime", tid=2,
                  correlation=5 + 100 * step),
               _x(f"fvt/dx/{SITE.path}", t0 + 150, 30, "user_annotation", tid=2),
               _x("cudaLaunchKernel", t0 + 151, 2, "cuda_runtime", tid=2,
                  correlation=6 + 100 * step),
               _x("autograd::engine::evaluate_function: ConvolutionBackward0", t0 + 200, 60,
                  tid=2),
               _x(f"fvt/bwd/{DOWN.path}", t0 + 201, 50, "user_annotation", tid=2),
               _x("aten::convolution_backward", t0 + 202, 40, tid=2,
                  **{"External id": 14 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 203, 2, "cuda_runtime", tid=2,
                  correlation=7 + 100 * step),
               _x("fvt/optimizer", t0 + 300, 50, "user_annotation"),
               _x("aten::_foreach_add_", t0 + 301, 20, **{"External id": 15 + 100 * step}),
               _x("cudaLaunchKernel", t0 + 302, 2, "cuda_runtime", correlation=8 + 100 * step)]
        d = 1000.0 * step + 5000  # the device's clock runs behind the host's launches
        ev += [_k("elementwise_kernel copy", d, 30, 10 + 100 * step, 1 + 100 * step),
               _k("spatial_conv_weight_kernel", d + 40, 10, 11 + 100 * step, 2 + 100 * step),
               _k("spatial_conv_hopper_kernel", d + 50, 100, 11 + 100 * step, 3 + 100 * step),
               _k("vectorized_elementwise_kernel relu", d + 150, 20, 12 + 100 * step,
                  4 + 100 * step),
               _k("vectorized_elementwise_kernel threshold", d + 170, 20, 13 + 100 * step,
                  5 + 100 * step),
               _k("spatial_conv_hopper_kernel", d + 190, 110, 0, 6 + 100 * step),
               _k("sm90_xmma_dgrad", d + 300, 60, 14 + 100 * step, 7 + 100 * step),
               _k("multi_tensor_apply_kernel", d + 360, 40, 15 + 100 * step, 8 + 100 * step)]
    ev.append(_x("ProfilerStep#2", 2000.0, 100, "user_annotation"))  # no device work
    # a step captured in part (fewer kernels than the others): left out
    ev += [_x("ProfilerStep#3", 3000.0, 100, "user_annotation"),
           _x("aten::relu", 3001.0, 5, **{"External id": 812}),
           _k("vectorized_elementwise_kernel relu", 8000.0, 20, 812, 0)]
    ev.append(_k("stray_kernel", 9000.0, 5, 999, 999))  # launched outside every step
    ev.append({"ph": "X", "cat": "gpu_user_annotation", "name": f"fvt/fwd/{SITE.path}", "pid": 0,
               "tid": 7, "ts": 5040.0, "dur": 110})  # the card's copy of a scope: not work
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_attribute_on_a_synthetic_trace(tmp_path):
    _synthetic_trace(str(tmp_path))
    d = sp.load_trace_durations(str(tmp_path))
    assert d.device == "cuda" and d.steps == [0, 1] and d.steps_captured == 2
    assert d.outside == 1 and d.partial == (3,)
    assert d.device_us_per_step == d.sum_us_per_step == 390.0
    by = {(k.name, k.step): k for k in d.kernels}
    dx = [k for k in d.kernels if k.role == "dx"]
    assert len(dx) == 2 and all(k.joined == "correlation" and k.path == SITE.path for k in dx)
    assert by[("vectorized_elementwise_kernel threshold", 0)].backward
    rows, cats, info = sp.attribute(d, {SITE.path: SITE, DOWN.path: DOWN})
    assert cats == {"bwd_conv_spatial": 110.0, "fwd_conv_spatial": 110.0, "bwd_conv_downsample": 60.0,
                    "optimizer": 40.0, "preprocess": 30.0, "fwd_elementwise/other": 20.0,
                    "bwd_elementwise/other": 20.0}
    row = {(r.role, r.path): r for r in rows if r.path}
    fwd = row[("fwd", SITE.path)]
    assert fwd.launches == 2.0 and fwd.us == 110.0
    assert fwd.kernel.startswith("spatial_conv_hopper_kernel; spatial_conv_weight_kernel")
    assert fwd.floor_us == pytest.approx(sp.least_seconds(SITE.work("fwd"), "bfloat16")[0] * 1e6)
    assert fwd.tflops == pytest.approx(SITE.work("fwd").flops / 110.0 / 1e6)
    bwd = row[("bwd", DOWN.path)]
    assert bwd.floor_us == pytest.approx(
        (DOWN.floor_seconds("dx") + DOWN.floor_seconds("dw")) * 1e6)
    floors = fwd.floor_us + row[("dx", SITE.path)].floor_us + bwd.floor_us
    assert info["floors_us_per_step"] == pytest.approx(floors)
    assert info["attributed_us_per_step"] == 390.0
    assert info["closure"] == pytest.approx(floors / 390.0)
    assert info["closure_floored"] == pytest.approx(floors / 280.0)
    assert info["unjoined"] == 0 and info["steps_captured"] == 2
    # the hand kernels, each under a conv site, and the time a step by kernel
    assert info["hand_kernels"] == 6 and info["hand_kernels_unplaced"] == []
    assert info["by_kernel_us"] == {"K1": 220.0, "other": 170.0}


def test_a_trace_without_device_work_raises(tmp_path):
    ev = [_x("ProfilerStep#0", 0.0, 10, "user_annotation"), _x("aten::add", 1.0, 2)]
    with open(tmp_path / "trace.json", "w") as f:
        json.dump({"traceEvents": ev}, f)
    with pytest.raises(RuntimeError, match="no device activity"):
        sp.load_trace_durations(str(tmp_path), "cuda")
    d = sp.load_trace_durations(str(tmp_path))  # a host trace: its ops are the work
    assert d.device == "cpu" and d.steps == [0] and d.kernels[0].name == "aten::add"


# --------------------------------------------------------------------------
# the entry point on the CPU
# --------------------------------------------------------------------------


def test_main_train_step_on_the_cpu(tmp_path, capsys):
    rows, cats, info = sp.main(["--device", "cpu", "--model", "tiny3d", "--batch", "2",
                                "--clip-len", "4", "--crop", "32", "--steps", "2",
                                "--trace-dir", str(tmp_path / "tr")])
    out = capsys.readouterr().out
    assert "trace: 2 step(s) captured on the cpu" in out and "largest slack" in out
    assert info["steps_captured"] == 2 and len(info["step_ms"]) == 2
    assert {"fwd_conv_stem/other", "bwd_conv_stem/other", "preprocess", "optimizer",
            "fwd_elementwise/other"} <= set(cats)
    paths = {(r.role, r.path) for r in rows if r.path}
    assert {("fwd", "conv1"), ("fwd", "conv2"), ("bwd", "conv1"), ("bwd", "conv2")} <= paths
    # tiny3d: two forwards, two weight gradients, conv2's input gradient
    assert info["n_convs"] == 5 and info["sites"] == 2
    assert info["attributed_us_per_step"] == pytest.approx(info["device_us_per_step"])
    assert info["step_timer_s"] > 0
    assert not scopes.active()


def test_main_eval_forward_on_the_cpu(tmp_path):
    rows, cats, info = sp.main(["--eval", "--device", "cpu", "--model", "tiny3d", "--batch",
                                "2", "--clip-len", "4", "--crop", "32", "--steps", "3",
                                "--trace-dir", str(tmp_path / "tr")])
    assert info["steps_captured"] == 3 and info["n_convs"] == 2
    assert "fwd_conv_stem/other" in cats and not any(c.startswith("bwd") for c in cats)
    with pytest.raises(SystemExit):
        sp.main(["--int8", "static", "--device", "cpu"])


def test_int8_forward_runs_under_its_conv_ids(tmp_path):
    """The int8 engine's Q1 calls and bf16 tail convs land in the inventory
    and the trace under their conv ids, its quantize passes under their
    sites."""
    rows, cats, info = sp.profile_eval_step("r2plus1d_18", 1, 4, 32, n_steps=1,
                                            trace_dir=str(tmp_path / "tr"), int8="static",
                                            device="cpu")
    from fastvideotagging_tpu_torch.ops.arch_spec import conv_id, iter_convs, spec_for

    ids = {conv_id(c) for _, c in iter_convs(spec_for("r2plus1d_18"))}
    traced = {r.path for r in rows if r.path and r.role == "fwd"}
    assert traced == ids and info["sites"] == len(ids) == 37
    assert "fwd_quantize" in cats and {"fwd_conv_spatial", "fwd_conv_temporal",
                                       "fwd_conv_downsample", "fwd_conv_stem/other"} <= set(cats)
    assert {r.path for r in rows if r.role == "quant"} == {"input"}  # static: Q1 quantizes


# --------------------------------------------------------------------------
# conv_work against chip_smoke.py's earlier formulas
# --------------------------------------------------------------------------


def _old_work(kernel, x_shape, co, k=3):
    """chip_smoke.py's ``work`` before it called conv_work."""
    def tap_pairs(n):
        return sum(max(0, n - abs(d - k // 2)) for d in range(k))
    b, t, h, w, c = x_shape
    rows = b * t * h * w
    if kernel == "spatial_conv":
        flops = 2.0 * b * t * tap_pairs(h) * tap_pairs(w) * c * co
    else:
        flops = 2.0 * b * h * w * tap_pairs(t) * c * co
    if kernel == "temporal_dw":
        nbytes = 2.0 * rows * (c + co) + 4.0 * k * c * co
    else:
        nbytes = 2.0 * (rows * (c + co) + (k * k if kernel == "spatial_conv" else k) * c * co)
    return flops, nbytes


def _path_sites(b):
    """chip_smoke.py's ``path_sites``: r2plus1d_18's kernel sites at
    16x112x112."""
    sites = [("temporal_conv", (b, 16, 56, 56, 45), 64, 1)]
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = (27 * c * c) // (9 * c + 3 * c)
        n = 4 if stage == 0 else 3
        sites += [("spatial_conv", (b, t, hw, hw, c), m, n),
                  ("temporal_conv", (b, t, hw, hw, m), c, n)]
    return sites


def _bound_ms(flops, nbytes):
    return max(flops / 989e12, nbytes / 3.35e12) * 1e3


def _geometry(kernel):
    if kernel == "spatial_conv":
        return (1, 3, 3), (1, 1, 1), ((0, 0), (1, 1), (1, 1))
    return (3, 1, 1), (1, 1, 1), ((1, 1), (0, 0), (0, 0))


@pytest.mark.parametrize("batch", [8, 32, 64])
def test_conv_work_equals_the_earlier_bounds_at_the_path_sites(batch):
    """Every site and role of the kernel table, and its sums: K1 0.4257 /
    3.4052 ms, K2 0.2828 / 2.2608 ms, K3 1.1307 ms (serving at 8 clips /
    train step at 32)."""
    sums = {}
    for kernel, xs, co, n in _path_sites(batch):
        size, strides, pads = _geometry(kernel)
        cases = [("fwd", xs, co), ("dx", xs[:-1] + (co,), xs[-1])]
        for role, x, c_out in cases:
            got = sp.conv_work(x, size, strides, pads, c_out)
            assert (got.flops, got.nbytes) == _old_work(kernel, x, c_out), (kernel, xs, role)
            sums[(kernel, role)] = sums.get((kernel, role), 0.0) + n * _bound_ms(*_old_work(
                kernel, x, c_out))
            # the dx role of the forward's geometry is the same work
            dx = sp.conv_work(xs, size, strides, pads, co, role="dx")
            assert (dx.flops, dx.nbytes) == _old_work(kernel, xs[:-1] + (co,), xs[-1])
        if kernel == "temporal_conv":
            dw = sp.conv_work(xs, size, strides, pads, co, role="dw", out_dtype="float32")
            assert (dw.flops, dw.nbytes) == _old_work("temporal_dw", xs, co)
            sums[("temporal_dw", "dw")] = sums.get(("temporal_dw", "dw"), 0.0) + n * _bound_ms(
                *_old_work("temporal_dw", xs, co))
    if batch == 8:
        assert round(sums[("spatial_conv", "fwd")], 4) == 0.4257
        assert round(sums[("temporal_conv", "fwd")], 4) == 0.2828
    if batch == 32:
        assert round(sums[("spatial_conv", "fwd")] + sums[("spatial_conv", "dx")], 4) == 3.4052
        assert round(sums[("temporal_conv", "fwd")] + sums[("temporal_conv", "dx")], 4) == 2.2608
        assert round(sums[("temporal_dw", "dw")], 4) == 1.1307


def _old_int8_io(key, c):
    """chip_smoke.py's ``_int8_bound`` before it called conv_work: (flops,
    the bytes of the input the taps read and of the weights)."""
    qs, kernel, strides, pads, co = key
    n, t, h, w, cp = qs

    def out_of(d, k, s, p):
        return (d + p[0] + p[1] - k) // s + 1
    pairs, read = 1, n * cp
    for d, k, s, p in zip((t, h, w), kernel, strides, pads):
        o = out_of(d, k, s, p)
        pairs *= sum(1 for i in range(o) for j in range(k) if 0 <= i * s - p[0] + j < d)
        read *= len({i * s - p[0] + j for i in range(o) for j in range(k)} & set(range(d)))
    return 2.0 * n * pairs * c * co, read + co * kernel[0] * kernel[1] * kernel[2] * cp


@pytest.mark.parametrize("key,c", [
    (((8, 16, 112, 112, 16), (1, 7, 7), (1, 2, 2), ((0, 0), (3, 3), (3, 3)), 45), 3),
    (((8, 8, 28, 28, 128), (1, 1, 1), (2, 2, 2), ((0, 0), (0, 0), (0, 0)), 256), 128),
    (((8, 16, 56, 56, 144), (3, 1, 1), (2, 1, 1), ((1, 1), (0, 0), (0, 0)), 128), 144),
    (((8, 32, 224, 224, 16), (7, 7, 7), (2, 2, 2), ((2, 3), (2, 3), (2, 3)), 64), 3),
    (((8, 8, 56, 56, 16), (1, 1, 1), (1, 1, 1), ((0, 0), (0, 0), (0, 0)), 8), 8),
])
def test_conv_work_equals_the_earlier_int8_bound(key, c):
    qs, kernel, strides, pads, co = key
    got = sp.conv_work(qs[:-1] + (c,), kernel, strides, pads, co, "int8", stored_c=qs[-1])
    flops, nbytes = _old_int8_io(key, c)
    assert (got.flops, got.x_bytes + got.w_bytes) == (flops, nbytes)


def test_roofline_counts_are_the_references():
    """``taps='all'``: 2 x output elements x contraction, every operand
    whole; a strided conv's dx counts its whole input."""
    x, k, s, p, co = (2, 4, 16, 16, 64), (1, 1, 1), (2, 2, 2), ((0, 0),) * 3, 128
    fwd = sp.conv_work(x, k, s, p, co, "float32", "fwd", taps="all")
    dx = sp.conv_work(x, k, s, p, co, "float32", "dx", taps="all")
    dw = sp.conv_work(x, k, s, p, co, "float32", "dw", taps="all")
    rows_in, rows_out = 2 * 4 * 16 * 16, 2 * 2 * 8 * 8
    assert fwd.flops == 2.0 * rows_out * co * 64 and dw.flops == fwd.flops
    assert dx.flops == 2.0 * rows_in * 64 * co
    assert fwd.nbytes == 4.0 * (rows_in * 64 + 64 * co + rows_out * co) == dw.nbytes
    inside = sp.conv_work(x, k, s, p, co, "float32", "fwd")
    assert inside.flops == fwd.flops and inside.x_bytes == fwd.x_bytes / 8
    with pytest.raises(ValueError, match="role"):
        sp.conv_work(x, k, s, p, co, role="dy")
