"""Chip smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the
numbers the repo keeps).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. card   — name, power limit and device count;
2. build  — compile every csrc/*.cu kernel (one nvcc per source, in
            parallel) and print ptxas' register / shared memory report;
3. kernels — at every kernel-eligible (2+1)D conv site of R(2+1)D-18
            (16x112x112, bf16), at the serving clip batch (8) and the
            training batch (32): K1 (spatial 1xkxk) and K2 (temporal kx1x1)
            forward and as dx (the same kernels on the flipped,
            channel-transposed weights, C and Co swapped, as the training
            step runs them, through ``spatial_conv_dx_cuda`` /
            ``temporal_conv_dx_cuda``), each with its plan, TFLOP/s or GB/s
            and share of the bound printed, no K1 path site padded, two
            launches bitwise equal where the plan splits the contraction,
            K2's device time split between its kernels at clip_batch 8, and
            at K2's stem (C = 45) its pad pass and F.pad before the launch
            timed against the kernel on channels padded beforehand), K3 (the temporal
            weight gradient, two launches bitwise equal, with its plan,
            GB/s or TFLOP/s and share of the bound printed, and at the
            stem the time of its channel pad pass) — each against its
            plain PyTorch version, with the times of the kernel, the plain
            version and the library call for the same function (F.conv3d,
            torch.nn.grad.conv3d_input / conv3d_weight; cuDNN, TF32 off)
            beside the least time the card could take. Then the two
            autograd Functions' dx and dw against autograd through the
            plain versions;
   3c. K4 (the fused spatial conv + folded BN + ReLU + temporal conv) at
            r2plus1d_18's four stride-1 pair sites at clip_batch 8 against
            its plain version (two launches bitwise equal), timed beside
            the library chain (F.conv3d -> affine -> ReLU -> F.conv3d),
            the port's unfused chain (K1 -> affine -> ReLU -> K2) and the
            least time the card could take, with its plan (rows x mid
            channels x groups, blocks, waves, shared memory), TFLOP/s,
            share of the bound, the split of its device time between its
            weight layouts, fused kernel and reduce (torch.profiler), and
            the times of the tilings the plan did not choose;
   3d. K5-K9, the temporal-conv micro-benchmark's designs
            (ops/temporal_micro.py: v2, v3 at tiles <= 448 and <= 224 and
            its dx, dw v3, v3p at both tiles, dw v2) at its three shapes
            (``benchmarks.kernel_micro.SHAPES``, B = 32, k = 3) against
            their plain versions (K7, K9: two launches bitwise equal), each
            timed beside its plain version, the library call for the same
            function and the least time the card could take, its device
            time split between its kernels (pad pass, GEMM, reduce); K2 and
            K3 at the same shapes, timed; then the micro-benchmark's entry point
            ``kernel_micro.main(["--shape", "tpu1"])`` end to end, its
            launches counted from 0 (every design at least once);
4. path   — the port's Tagger (r2plus1d_18, 400 classes, multilabel, bf16,
            kernels='cuda', seeded random weights) on seeded synthetic
            frames through ``scores_from``: launch counts per forward,
            finite scores, agreement with the kernels='torch' tagger and
            with an f32 reference forward, clips/s of both taggers;
5. train  — the ``r2plus1d18_ucf101`` preset (101 classes, B = 32, bf16,
            batch-statistics BN, dropout 0.5, SGD) through
            ``create_train_state`` / ``make_train_step`` on one seeded
            synthetic batch: launch counts of one step (26 / 28 / 14),
            step-0 loss and logits against a kernels='torch' state with
            the same weights, the gradients of both against an f32
            reference, a falling loss over 10 steps,
            moved BN statistics, ms per step, clips/s and peak memory of
            both routes;
6. eval   — ``evaluate()`` over a seeded ``.fvtpack`` (8 synthetic videos
            of 160 frames at 128x171, 400 tags, dense clips: 80 clips) on
            r2plus1d_18 with seeded random weights, three engines: the
            default apply with kernels='cuda', with kernels='torch', and
            the fused engine on K4 as ``apply_fn``: launch counts per
            chunk (fused: 13 K4, no K1/K2), finite video scores, fused
            scores against kernels='cuda', fused logits against an f32
            reference forward, metrics, clips/s and forward ms.

The line before the last is a JSON object with one entry per kernel. Its
``launches`` is the kernel's launches over the main path's runs, phases 4 to
6 (each run counted from 0 just before it and read just after), and
``launches_by_run`` splits them by run; its times are per training step for
K1-K3 and per serving forward for K4 (inference only). K5-K9's path is the
micro-benchmark's run in phase 3d (``launches_by_run`` {"micro": n}); their
times are one call at the tpu1 shape (K6, K8 at tiles <= 448). The last
line is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch import Tagger, get_model
from fastvideotagging_tpu_torch.benchmarks import kernel_micro
from fastvideotagging_tpu_torch.config import (
    PRESETS,
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
)
from fastvideotagging_tpu_torch.data.packed import open_dataset, write_pack_from_arrays
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation import evaluate as evaluation
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as fused
from fastvideotagging_tpu_torch.ops import temporal_micro as micro
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_batch, preprocess_eval_clip
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state
from fastvideotagging_tpu_torch.utils.profiling import breakdown

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12

CLIP_BATCH = 8
TRAIN_BATCH = 32
TRAIN_STEPS = 10
SEED = 0
K = 3
DEV = "cuda"  # everything here runs on the card
# kernel vs plain version: both take the same bf16 inputs and sum in f32;
# they differ by summation order and the bf16 rounding of the output
# (2^-8 relative), so 1e-2 of the output's largest magnitude.
KERNEL_TOL = 1e-2
# K3 writes f32 and differs from its plain version by summation order only:
# 1e-3 of the output's largest magnitude.
DW_TOL = 1e-3
# path: the kernels='cuda' and kernels='torch' routes round to bf16 at
# different places; logits agree within 5e-2 of the largest |logit|
# (the model-level bound of tests/test_fused_infer.py), scores and the
# training loss within 5e-2.
PATH_TOL = 5e-2
# Gradients of one training step, all parameters taken together, as
# ||g - g_ref|| / ||g_ref|| against an f32 reference (F.conv3d, TF32 off) on
# the same weights, batch and dropout mask. bf16 gradients of this network
# at a random init are far from the f32 ones with either route (BN
# statistics and the cotangents between layers are rounded to bf16), so the
# kernels='cuda' route is held to the kernels='torch' route's distance:
# at most 1.25 times as far, plus 0.02.
GRAD_FACTOR, GRAD_SLACK = 1.25, 0.02

KERNELS = {
    "spatial_conv": dict(
        name="spatial_conv_hopper_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/spatial_conv.cu",
        replaces="fastvideotagging_tpu/ops/conv2plus1d.py:94 (_spatial_pallas)"),
    "temporal_conv": dict(
        name="temporal_conv_hopper_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/spatial_conv.cu",
        replaces="fastvideotagging_tpu/ops/conv2plus1d.py:225 (_temporal_pallas)"),
    "temporal_dw": dict(
        name="temporal_dw_hopper_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/temporal_dw.cu",
        replaces="fastvideotagging_tpu/ops/conv2plus1d.py:284 (_temporal_dw)"),
    "fused_block": dict(
        name="fused_block_hopper_kernel", route="cuda",
        source="fastvideotagging_tpu_torch/csrc/fused_block.cu",
        replaces="fastvideotagging_tpu/ops/fused_block.py:99 (_fused_pallas)"),
}
# launches of one r2plus1d_18 training step: forward + dx, and the dw
TRAIN_STEP_LAUNCHES = {"spatial_conv": 26, "temporal_conv": 28, "temporal_dw": 14,
                       "fused_block": 0}
# launches of one r2plus1d_18 forward per engine: K1 / K2 at 13 / 14 sites,
# or K4 at the 13 stride-1 (2+1)D pairs
FORWARD_LAUNCHES = {
    "cuda": {"spatial_conv": 13, "temporal_conv": 14, "temporal_dw": 0, "fused_block": 0},
    "torch": {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0, "fused_block": 0},
    "fused": {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0, "fused_block": 13},
}
EVAL_VIDEOS, EVAL_FRAMES, EVAL_CLASSES = 8, 160, 400
# K5-K9, the micro-benchmark's designs, by their launch-count key; their
# path is the micro-benchmark (phase 3d), not phases 4-6
_MICRO_SOURCE = "fastvideotagging_tpu_torch/csrc/temporal_micro.cu"
MICRO_KERNELS = {
    "v2": dict(name="micro_fwd_kernel<kV2> (K5, after micro_pad_kernel)", route="cuda",
               source=_MICRO_SOURCE,
               replaces="benchmarks/kernel_micro.py:91 (pallas_temporal_v2)"),
    "v3": dict(name="micro_fwd_kernel<kV3> (K6)", route="cuda", source=_MICRO_SOURCE,
               replaces="benchmarks/kernel_micro.py:155 (pallas_temporal_v3; its dx "
                        "pallas_temporal_dx_v3 :267)"),
    "dw_v3": dict(name="micro_dw_kernel<kDwV3> (K7, + micro_reduce_kernel)", route="cuda",
                  source=_MICRO_SOURCE,
                  replaces="benchmarks/kernel_micro.py:200 (pallas_temporal_dw_v3)"),
    "v3p": dict(name="micro_fwd_kernel<kV3P> (K8)", route="cuda", source=_MICRO_SOURCE,
                replaces="benchmarks/kernel_micro.py:241 (pallas_temporal_v3p)"),
    "dw_v2": dict(name="micro_dw_kernel<kDwV2> (K9, after micro_pad_kernel, + "
                       "micro_reduce_kernel)", route="cuda", source=_MICRO_SOURCE,
                  replaces="benchmarks/kernel_micro.py:297 (pallas_temporal_dw)"),
}
# the micro-benchmark call whose time stands in a design's kernels entry
MICRO_HEADLINE = {"v2": "v2 fwd", "v3": "v3 fwd tile<=448", "dw_v3": "dw v3",
                  "v3p": "v3p fwd tile<=448", "dw_v2": "dw v2"}


def path_sites(b: int = CLIP_BATCH):
    """The stride-1, kernel-eligible (2+1)D conv sites of r2plus1d_18 at
    16x112x112: (site, kernel, x shape (B,T,H,W,C), Co, launches/forward)."""
    sites = [("stem_temporal", "temporal_conv", (b, 16, 56, 56, 45), 64, 1)]
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        n = 4 if stage == 0 else 3  # stage entries (stride 2) go to F.conv3d
        sites.append((f"stage{stage + 1}_spatial", "spatial_conv", (b, t, hw, hw, c), m, n))
        sites.append((f"stage{stage + 1}_temporal", "temporal_conv", (b, t, hw, hw, m), c, n))
    return sites


def tap_pairs(n: int, k: int = K) -> int:
    """(output, input) position pairs of a size-k, stride-1, k//2-padded
    conv along an axis of length n that fall inside it: n - |d - k//2| per
    tap d. Taps into the zero padding do no work."""
    return sum(max(0, n - abs(d - k // 2)) for d in range(k))


def spatial_flops(x_shape, co: int, k: int = K) -> float:
    """Operations of a 1 x k x k conv over the taps that fall inside the
    frame: x (B, T, H, W, C) -> Co channels."""
    b, t, h, w, c = x_shape
    return 2.0 * b * t * tap_pairs(h, k) * tap_pairs(w, k) * c * co


def _min_time(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def work(kernel: str, x_shape, co: int, k: int = K):
    """(operations, bytes) of one call: each input read once, each output
    written once, and the operations of the taps that fall inside the input
    (none into its zero padding)."""
    b, t, h, w, c = x_shape
    rows = b * t * h * w
    if kernel == "spatial_conv":
        flops = spatial_flops(x_shape, co, k)
    else:
        flops = 2.0 * b * h * w * tap_pairs(t, k) * c * co
    if kernel == "temporal_dw":
        nbytes = 2.0 * rows * (c + co) + 4.0 * k * c * co
    else:
        taps = k * k if kernel == "spatial_conv" else k
        nbytes = 2.0 * (rows * (c + co) + taps * c * co)
    return flops, nbytes


def bound(kernel: str, x_shape, co: int, k: int = K):
    """The least time (ms) the card could take, and what bounds it (see
    ``work``)."""
    return _min_time(*work(kernel, x_shape, co, k))


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_card() -> str:
    print("== phase 1: card", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"torch.cuda.get_device_name(0)={kind} device_count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")
    return smi.splitlines()[0]


def phase_build() -> None:
    print("== phase 2: build", flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"built {sorted(reports)} in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        print(f"-- ptxas report for {name}.cu:")
        print(report.strip())


def _ncdhw(x5: torch.Tensor) -> torch.Tensor:
    """NTHWC tensor as a channels-last-3d NCDHW view (no copy)."""
    return x5.permute(0, 4, 1, 2, 3)


def site_cases(kernel: str, xs, co: int, gen: torch.Generator):
    """The kernel calls one conv site makes in a training step, each with
    its plain version and the library call for the same function:
    (role, kernel key, run, plain, library, (bound ms, bound by), other
    runs of the same call by name). The last holds, at a C that is not a
    multiple of 8 (the stem's 45), "prepadded": the same kernel on channels
    padded beforehand (K3 and K2), and for K2 "F.pad": F.pad before the
    launch instead of the kernel's pad pass."""
    b, t, h, w, c = xs
    dev = torch.device(DEV)
    x5 = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
    g5 = torch.randn((b, t, h, w, co), generator=gen, device=dev).to(torch.bfloat16)
    if kernel == "spatial_conv":
        x, g = x5.reshape(b * t, h, w, c), g5.reshape(b * t, h, w, co)
        wt = (torch.randn((K, K, c, co), generator=gen, device=dev)
              / (K * K * c) ** 0.5).to(torch.bfloat16)
        run, plain = ops.spatial_conv_cuda, ops.spatial_conv_plain
        # dx as the training step runs it: K1's weight layout built straight
        # from the forward weight, the taps read in reverse
        run_dx, plain_dx, w_dx = ops.spatial_conv_dx_cuda, ops.spatial_conv_dx_plain, wt
        w5, pad = wt[None], (0, K // 2, K // 2)
    else:
        x, g = x5.reshape(b, t, h * w, c), g5.reshape(b, t, h * w, co)
        wt = (torch.randn((K, c, co), generator=gen, device=dev)
              / (K * c) ** 0.5).to(torch.bfloat16)
        run, plain = ops.temporal_conv_cuda, ops.temporal_conv_plain
        # dx as the training step runs it: K2's weight layout built straight
        # from the forward weight, the taps read in reverse
        run_dx, plain_dx, w_dx = ops.temporal_conv_dx_cuda, ops.temporal_conv_dx_plain, wt
        w5, pad = wt[:, None, None], (K // 2, 0, 0)
    w_lib = w5.permute(4, 3, 0, 1, 2)  # (Co, C, kt, kh, kw)
    xpad = ops._pad_channels(x) if c % 8 else None
    others = {"fwd": {}, "dx": {}}
    if kernel == "temporal_conv" and c % 8:
        others["fwd"]["prepadded"] = lambda: ops._k2_launch(xpad, wt, False)[0]
        others["fwd"]["F.pad"] = lambda: ops._k2_launch(ops._pad_channels(x), wt, False)[0]
    cases = [
        ("fwd", kernel, lambda: run(x, wt), lambda: plain(x, wt),
         lambda: ops.conv3d_nthwc(x5, w5, (1, 1, 1), pad), bound(kernel, xs, co), others["fwd"]),
        ("dx", kernel, lambda: run_dx(g, w_dx), lambda: plain_dx(g, w_dx),
         lambda: torch.nn.grad.conv3d_input(_ncdhw(x5).shape, w_lib, _ncdhw(g5), padding=pad),
         bound(kernel, (b, t, h, w, co), c), others["dx"]),
    ]
    if kernel == "temporal_conv":
        cases.append(
            ("dw", "temporal_dw", lambda: ops.temporal_dw_cuda(x, g, K),
             lambda: ops.temporal_dw_plain(x, g, K),
             lambda: torch.nn.grad.conv3d_weight(_ncdhw(x5), w_lib.shape, _ncdhw(g5),
                                                 padding=pad),
             bound("temporal_dw", xs, co),
             {"prepadded": lambda: ops.temporal_dw_cuda(xpad, g, K)} if c % 8 else {}))
    return cases


def k2_split(run) -> dict:
    """K2's device time per call by kernel (torch.profiler over 5 calls):
    the weight layout, the pad pass, the GEMM, the reduce."""
    split = dict(layout_ms=0.0, pad_ms=0.0, main_ms=0.0, reduce_ms=0.0)
    for name, ms in breakdown(run, iters=5)["top_kernels_ms_per_iter"]:
        for part, key in (("weight", "layout_ms"), ("pad", "pad_ms"), ("hopper", "main_ms"),
                          ("reduce", "reduce_ms")):
            if f"temporal_conv_{part}_kernel" in name:
                split[key] += ms
    return split


def _lib_as(role: str, out: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The library call's result in the layout of the plain version's."""
    if role == "fwd":
        return out.reshape(ref.shape)
    if role == "dx":  # NCDHW view of an NTHWC gradient
        return out.permute(0, 2, 3, 4, 1).reshape(ref.shape)
    return out.permute(2, 3, 4, 1, 0).reshape(ref.shape)  # (Co,C,kt,1,1) -> (k,C,Co)


def _new_agg():
    return dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, ops_ms=0.0, bytes_ms=0.0)


def phase_kernels(card: str) -> dict:
    print("== phase 3: kernels", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    # sums over the launches of one forward at the serving clip batch, and of
    # one training step (forward + dx, or dw) at the training batch
    agg = {k: dict(max_abs_err=0.0, max_rel_err=0.0, ok=True, serving=_new_agg(),
                   train=_new_agg(), train_roles={}, sites=[]) for k in KERNELS}
    failures = []
    for batch in (CLIP_BATCH, TRAIN_BATCH):
        for site, kernel, xs, co, n in path_sites(batch):
            for role, key, run, plain, lib, (bound_ms, by), others in site_cases(
                    kernel, xs, co, gen):
                tol = DW_TOL if role == "dw" else KERNEL_TOL
                got = run()
                torch.cuda.synchronize()
                ref = plain()
                libout = _lib_as(role, lib(), ref)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                max_abs = (got.float() - ref.float()).abs().max().item()
                max_rel = max_abs / scale
                lib_rel = (libout.float() - ref.float()).abs().max().item() / scale
                ok = bool(torch.isfinite(got).all().item()) and max_rel <= tol
                note, plan, pad_ms, other_ms, split = "", None, None, {}, None
                # the channels the kernel reads and writes, and its work
                cin, cout = (xs[-1], co) if role != "dx" else (co, xs[-1])
                flops, nbytes = work(key, xs[:-1] + (cin,), cout)
                if key == "spatial_conv":  # x as (N, H, W, C)
                    plan = ops.spatial_plan((xs[0] * xs[1], xs[2], xs[3], cin), cout, K)
                    if cin % 8:  # a path site the wrapper would pad
                        ok = False
                        note += " PADDED"
                elif key == "temporal_conv":  # x as (B, T, S, C)
                    plan = ops.temporal_plan((xs[0], xs[1], xs[2] * xs[3], cin), cout, K,
                                             ops._sm_count(torch.device(DEV)))
                elif key == "temporal_dw":
                    plan = ops.temporal_dw_plan((xs[0], xs[1], xs[2] * xs[3], xs[4]), co, K)
                # deterministic: no atomics, partial sums added in a fixed order
                if key == "temporal_dw" or plan.splits > 1:
                    same = torch.equal(got, run())
                    ok = ok and same
                    note += f" two launches bitwise equal={same}"
                for way, other in others.items():  # the other ways agree with the plain version
                    out = other()[tuple(slice(0, n) for n in ref.shape)]  # K3's padded C
                    err = (out.float() - ref.float()).abs().max().item() / scale
                    ok = ok and err <= tol
                    note += f" {way} max_rel_err={err:.3e}"
                del got, ref, libout
                ms = time_ms(run, iters=20)
                plain_ms = time_ms(plain, iters=3, warmup=1)
                library_ms = time_ms(lib, iters=20)
                rate = (f"{flops / ms / 1e9:.1f} TFLOP/s" if by == "operations"
                        else f"{nbytes / ms / 1e6:.1f} GB/s")
                if key in ("spatial_conv", "temporal_conv"):
                    note += (f" plan: BN={plan.bn} x{plan.col_tiles} col tiles x{plan.splits} "
                             f"kappa chunks, {plan.grid} blocks, {plan.blocks_per_sm} a SM, "
                             f"{plan.smem_bytes} B shared; {rate}, {bound_ms / ms:.3f} of the "
                             f"bound")
                else:  # K3: the plan, the rate of what bounds it, the share
                    note += (f" plan: BN={plan.bn} x{plan.c_tiles} c tiles x{plan.co_tiles} co "
                             f"tiles x{plan.tap_groups} tap groups x{plan.chunks} chunks of "
                             f"{plan.steps_per_chunk} slabs of {plan.tile_s} rows, {plan.grid} "
                             f"blocks, {plan.smem_bytes} B shared, x read {plan.x_reads}x, g "
                             f"{plan.g_reads}x; {rate}, {bound_ms / ms:.3f} of the bound")
                # the same call another way: on channels padded beforehand (the
                # pad pass's cost), with F.pad
                other_ms = {way: time_ms(fn, iters=20) for way, fn in others.items()}
                if "prepadded" in other_ms:
                    pad_ms = ms - other_ms["prepadded"]
                    note += f"; of which the channel pad pass {pad_ms:.4f} ms"
                if other_ms:
                    note += "; the same call " + ", ".join(
                        f"{way} {t:.4f} ms" for way, t in other_ms.items())
                if key == "temporal_conv" and batch == CLIP_BATCH:
                    split = k2_split(run)
                    note += ("; device split: " + ", ".join(
                        f"{part[:-3]} {v:.4f}" for part, v in split.items())
                        + f" ms (device {sum(split.values()):.4f} of the call's {ms:.4f})")
                print(f"B={batch:<2d} {site:16s} {role:3s} {key:13s} x={xs} Co={co} x{n}  "
                      f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} (tol {tol}; "
                      f"library vs plain {lib_rel:.3e}){note} kernel={ms:.4f} ms "
                      f"plain={plain_ms:.4f} ms library={library_ms:.4f} ms "
                      f"bound={bound_ms * 1e3:.1f} us ({by}) ok={ok}", flush=True)
                if not ok:
                    failures.append((batch, site, role))
                a = agg[key]
                a["max_abs_err"] = max(a["max_abs_err"], max_abs)
                a["max_rel_err"] = max(a["max_rel_err"], max_rel)
                a["ok"] = a["ok"] and ok
                sums = []
                if batch == CLIP_BATCH and role == "fwd":
                    sums.append(a["serving"])
                if batch == TRAIN_BATCH:
                    sums += [a["train"], a["train_roles"].setdefault(role, _new_agg())]
                for s in sums:
                    for name, v in (("ms", ms), ("plain_ms", plain_ms),
                                    ("library_ms", library_ms), ("bound_ms", bound_ms)):
                        s[name] += n * v
                    s["ops_ms" if by == "operations" else "bytes_ms"] += n * bound_ms
                a["sites"].append(dict(
                    site=site, role=role, batch=batch, x=list(xs), co=co, launches=n,
                    max_abs_err=max_abs, max_rel_err=max_rel, ms=ms, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bound_ms, bound_by=by,
                    plan=plan._asdict(),
                    **({"pad_pass_ms": pad_ms} if pad_ms is not None else {}),
                    **({"other_ways_ms": other_ms} if other_ms else {}),
                    **({"device_split": split} if split else {})))
            torch.cuda.empty_cache()
    print(f"sums over launches ({card}):")
    for key, a in agg.items():
        for what, per in (("serving", f"one forward at clip_batch {CLIP_BATCH}"),
                          ("train", f"one training step at B={TRAIN_BATCH}")):
            s = a[what]
            if not s["ms"]:
                continue  # K3 is not on the serving path
            print(f"  {key} per {per}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
                  f"library {s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms")
        for role, s in a["train_roles"].items():
            print(f"    of which {role}: kernel {s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, "
                  f"library {s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms")
    if failures:
        raise SystemExit(f"kernel disagrees with its plain version at {failures}")
    return agg


def _grads(fn, x, w, gy):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    fn(x, w).backward(gy)
    return x.grad, w.grad


def phase_functions() -> None:
    """dx and dw of the two autograd Functions (kernels on the card)
    against autograd through the plain versions, at every site."""
    print("== phase 3b: autograd Functions", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
    dev = torch.device(DEV)
    failures = []
    for site, kernel, xs, co, _ in path_sites(CLIP_BATCH):
        b, t, h, w, c = xs
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        gy = torch.randn((b, t, h, w, co), generator=gen, device=dev).to(torch.bfloat16)
        if kernel == "spatial_conv":
            wt = (torch.randn((K, K, c, co), generator=gen, device=dev)
                  / (K * K * c) ** 0.5).to(torch.bfloat16)
            fn = ops.spatial_conv

            def plain(x, wt):
                return ops.spatial_conv_plain(x.reshape(b * t, h, w, c), wt).reshape(b, t, h, w, -1)
        else:
            wt = (torch.randn((K, c, co), generator=gen, device=dev)
                  / (K * c) ** 0.5).to(torch.bfloat16)
            fn = ops.temporal_conv

            def plain(x, wt):
                return ops.temporal_conv_plain(x.reshape(b, t, h * w, c), wt).reshape(b, t, h, w, -1)
        dx, dw = _grads(fn, x, wt, gy)
        # the reference in f32 end to end (autograd through bf16 leaves would
        # add up the taps' dx in bf16)
        rdx, rdw = _grads(plain, x.float(), wt.float(), gy.float())
        torch.cuda.synchronize()
        errs = {}
        for name, got, ref in (("dx", dx, rdx), ("dw", dw, rdw)):
            errs[name] = ((got.float() - ref.float()).abs().max().item()
                          / ref.float().abs().max().item())
        ok = (dx.dtype == dw.dtype == torch.bfloat16
              and all(e <= KERNEL_TOL for e in errs.values()))
        print(f"{site:16s} {fn.__name__:13s} x={xs} Co={co}  dx max_rel_err={errs['dx']:.3e} "
              f"dw max_rel_err={errs['dw']:.3e} (tol {KERNEL_TOL}) ok={ok}", flush=True)
        if not ok:
            failures.append(site)
        del x, gy, wt, dx, dw, rdx, rdw
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"autograd Function disagrees with the plain versions at {failures}")


def fused_sites(b: int = CLIP_BATCH):
    """r2plus1d_18's stride-1 (2+1)D pairs at 16x112x112, K4's sites:
    (site, x shape (B,T,H,W,C), M, Co, launches/forward)."""
    sites, t, hw = [], 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        n = 4 if stage == 0 else 3  # each stage's entry pair is strided
        sites.append((f"stage{stage + 1}", (b, t, hw, hw, c), r2plus1d_mid_channels(c, c), c, n))
    return sites


def fused_flops(x_shape, m: int, co: int, k: int = K) -> float:
    """Operations of K4's two GEMMs over the taps that fall inside the frame
    (spatial) and inside [0, T) (temporal)."""
    b, t, h, w, c = x_shape
    return 2.0 * (b * t * tap_pairs(h, k) * tap_pairs(w, k) * c * m
                  + b * h * w * tap_pairs(t, k) * m * co)


def fused_bound(x_shape, m: int, co: int, k: int = K):
    """K4's least time (ms) and what bounds it: ``fused_flops`` against x,
    y, the weights and the folded BN read or written once (mid stays on
    chip, which is the kernel's point)."""
    b, t, h, w, c = x_shape
    rows = b * t * h * w
    nbytes = 2.0 * (rows * (c + co) + k * k * c * m + k * m * co) + 8.0 * m
    return _min_time(fused_flops(x_shape, m, co, k), nbytes)


def k4_split(run) -> dict:
    """K4's device time per call by kernel (torch.profiler over 5 calls):
    the weight layouts, the fused kernel and, with several groups, the
    reduce of the partials."""
    split = dict(layout_ms=0.0, main_ms=0.0, reduce_ms=0.0)
    for name, ms in breakdown(run, iters=5)["top_kernels_ms_per_iter"]:
        for part, key in (("weight", "layout_ms"), ("hopper", "main_ms"), ("reduce", "reduce_ms")):
            if f"fused_block_{part}_kernel" in name:
                split[key] += ms
    return split


def k4_alternatives(xs, m: int, co: int, args, chosen) -> list:
    """Every other tiling the plan chose among (rows per block x mid
    channels per group, the same Co tile), each timed on the same inputs:
    the plan's choice, measured."""
    out = []
    for bm in fused._K4_BMS:
        for mg in fused._K4_MGS:
            plan = fused._make_plan(xs, K, m, co, ops._sm_count(torch.device(DEV)), bm, mg,
                                    chosen.ct)
            if plan is None or (bm, mg) == (chosen.bm, chosen.mg):
                continue
            ms = time_ms(lambda plan=plan: fused.fused_block_cuda(*args, plan=plan), iters=10)
            out.append(dict(bm=bm, mg=mg, groups=plan.groups, blocks=plan.grid, ms=ms))
    return out


def phase_fused_kernel(card: str) -> dict:
    """K4 at its four sites (clip_batch 8) against its plain version, with
    the library chain and the port's unfused chain for the same function,
    its plan, rate, share of the bound, the split of its time between its
    kernels, and the tilings the plan did not choose."""
    print("== phase 3c: K4 (fused block)", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 3)
    dev = torch.device(DEV)
    sums = dict(ms=0.0, plain_ms=0.0, library_chain_ms=0.0, unfused_chain_ms=0.0, bound_ms=0.0,
                ops_ms=0.0, bytes_ms=0.0, layout_ms=0.0, reduce_ms=0.0)
    agg = dict(max_abs_err=0.0, max_rel_err=0.0, ok=True, serving=sums, sites=[])
    failures = []
    for site, xs, m, co, n in fused_sites():
        b, t, h, w, c = xs
        x = torch.randn(xs, generator=gen, device=dev).to(torch.bfloat16)
        w_sp = (torch.randn((K, K, c, m), generator=gen, device=dev)
                / (K * K * c) ** 0.5).to(torch.bfloat16)
        w_tmp = (torch.randn((K, m, co), generator=gen, device=dev) / (K * m) ** 0.5).to(torch.bfloat16)
        scale, bias = fused.fold_bn(torch.rand(m, generator=gen, device=dev) + 0.5,
                                    torch.randn(m, generator=gen, device=dev) * 0.1,
                                    torch.randn(m, generator=gen, device=dev) * 0.1,
                                    torch.rand(m, generator=gen, device=dev) + 0.5)

        def run():
            return fused.fused_block_cuda(x, w_sp, scale, bias, w_tmp)

        def plain():
            return fused.fused_block_plain(x, w_sp, scale, bias, w_tmp)

        def library():
            mid = ops.conv3d_nthwc(x, w_sp[None], (1, 1, 1), (0, K // 2, K // 2))
            mid = torch.relu(mid.float() * scale + bias).to(torch.bfloat16)
            return ops.conv3d_nthwc(mid, w_tmp[:, None, None], (1, 1, 1), (K // 2, 0, 0))

        def unfused():
            mid = ops.spatial_conv_cuda(x.reshape(b * t, h, w, c), w_sp)
            mid = torch.relu(mid.float() * scale + bias).to(torch.bfloat16)
            return ops.temporal_conv_cuda(mid.reshape(b, t, h * w, m), w_tmp).reshape(b, t, h, w, co)

        got = run()
        again = run()
        torch.cuda.synchronize()
        ref = plain()
        lib_out, unf_out = library(), unfused()
        torch.cuda.synchronize()
        ref_max = ref.float().abs().max().item()
        max_abs = (got.float() - ref.float()).abs().max().item()
        max_rel = max_abs / ref_max
        lib_rel = (lib_out.float() - ref.float()).abs().max().item() / ref_max
        unf_rel = (unf_out.float() - ref.float()).abs().max().item() / ref_max
        same = torch.equal(got, again)
        ok = bool(torch.isfinite(got).all().item()) and max_rel <= KERNEL_TOL and same
        del got, again, ref, lib_out, unf_out
        ms = time_ms(run, iters=20)
        plain_ms = time_ms(plain, iters=3, warmup=1)
        lib_ms = time_ms(library, iters=20)
        unf_ms = time_ms(unfused, iters=20)
        bound_ms, by = fused_bound(xs, m, co)
        plan = fused.fused_plan(xs, K, m, co, ops._sm_count(dev))
        split = k4_split(run)
        alts = k4_alternatives(xs, m, co, (x, w_sp, scale, bias, w_tmp), plan)
        tflops = fused_flops(xs, m, co) / (ms * 1e-3) / 1e12
        print(f"B={b} {site} fused_block x={xs} M={m} Co={co} x{n} (plan: {plan.bm} rows x "
              f"{plan.mg} mid channels x {plan.groups} groups, Co tile {plan.ct} x "
              f"{plan.co_passes}, {plan.stages} slices, {plan.grid} blocks, {plan.waves} "
              f"wave(s), {plan.smem_bytes} B shared)  max_abs_err={max_abs:.3e} "
              f"max_rel_err={max_rel:.3e} (tol {KERNEL_TOL}; library chain vs plain "
              f"{lib_rel:.3e}, unfused chain vs plain {unf_rel:.3e}) two launches bitwise "
              f"equal={same} kernel={ms:.4f} ms ({tflops:.1f} TFLOP/s, "
              f"{bound_ms / ms:.3f} of the bound; device split: weight layout "
              f"{split['layout_ms']:.4f}, fused {split['main_ms']:.4f}, reduce "
              f"{split['reduce_ms']:.4f} ms) plain={plain_ms:.4f} ms library "
              f"chain={lib_ms:.4f} ms unfused K1+K2 chain={unf_ms:.4f} ms "
              f"bound={bound_ms * 1e3:.1f} us ({by}) ok={ok}", flush=True)
        print("    other tilings: " + ", ".join(
            f"{a['bm']}x{a['mg']} ({a['groups']} groups, {a['blocks']} blocks) {a['ms']:.4f} ms"
            for a in alts), flush=True)
        if not ok:
            failures.append(site)
        agg["max_abs_err"] = max(agg["max_abs_err"], max_abs)
        agg["max_rel_err"] = max(agg["max_rel_err"], max_rel)
        agg["ok"] = agg["ok"] and ok
        for name, v in (("ms", ms), ("plain_ms", plain_ms), ("library_chain_ms", lib_ms),
                        ("unfused_chain_ms", unf_ms), ("bound_ms", bound_ms)):
            sums[name] += n * v
        sums["ops_ms" if by == "operations" else "bytes_ms"] += n * bound_ms
        sums["layout_ms"] += n * split["layout_ms"]
        sums["reduce_ms"] += n * split["reduce_ms"]
        agg["sites"].append(dict(
            site=site, batch=b, x=list(xs), m=m, co=co, launches=n, plan=plan._asdict(),
            blocks=plan.grid, tflops=tflops, share_of_bound=bound_ms / ms, split=split,
            other_tilings=alts, max_abs_err=max_abs, max_rel_err=max_rel, ms=ms,
            plain_ms=plain_ms, library_chain_ms=lib_ms, unfused_chain_ms=unf_ms,
            bound_ms=bound_ms, bound_by=by))
        del x, w_sp, w_tmp
        torch.cuda.empty_cache()
    print(f"  fused_block per one forward at clip_batch {CLIP_BATCH} (13 launches; {card}): "
          f"kernel {sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, library chain "
          f"{sums['library_chain_ms']:.4f} ms, unfused K1+K2 chain "
          f"{sums['unfused_chain_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms; of K4's device "
          f"time the weight layouts take {sums['layout_ms']:.4f} ms and the reduces "
          f"{sums['reduce_ms']:.4f} ms")
    if failures:
        raise SystemExit(f"K4 disagrees with its plain version at {failures}")
    return agg


def micro_cases(x, w, g):
    """The calls of phase 3d on x (B, T, S, C), w (k, C, Co), g (B, T, S,
    Co): (label as in the micro-benchmark, launch-count key, run, plain,
    library, role, plan as a string)."""
    b, t, s, c = x.shape
    co = w.shape[-1]

    def lib_fwd():
        return kernel_micro.library_temporal(x, w)

    def lib_dw():
        return kernel_micro.library_temporal_dw(x, w, g)

    def fwd_plan(tile_s, c_out=co):
        p = micro.forward_plan((b, t, s, c), c_out, tile_s)
        return (f"{p.slabs} slabs of {tile_s} columns x {p.row_tiles} row tiles x "
                f"{p.co_tiles} Co tiles = {p.grid} blocks")

    def dw_plan(tile_s):
        p = micro.dw_plan((b, t, s, c), co, tile_s, micro._sms(x))
        return (f"{p.steps} steps of {tile_s} columns in {p.chunks} chunks of "
                f"{p.steps_per_chunk}, {K * p.c_tiles * p.co_tiles * p.chunks} blocks")

    halved = micro._halved_tile(s)
    cases = [("v2 fwd", "v2", lambda: micro.temporal_v2_cuda(x, w, K),
              lambda: micro.temporal_v2_plain(x, w, K), lib_fwd, "fwd", fwd_plan(halved))]
    for mt in (448, 224):
        cases.append((f"v3 fwd tile<={mt}", "v3",
                      lambda mt=mt: micro.temporal_v3_cuda(x, w, K, mt),
                      lambda mt=mt: micro.temporal_v3_plain(x, w, K, mt), lib_fwd, "fwd",
                      fwd_plan(micro._pick_tile(s, mt))))
    cases += [("v3 dx", "v3", lambda: micro.temporal_dx_v3_cuda(g, w, K),
               lambda: micro.temporal_dx_v3_plain(g, w, K),
               lambda: kernel_micro.library_temporal_dx(g, w), "dx",
               fwd_plan(micro._pick_tile(s, 448), c)),
              ("dw v3", "dw_v3", lambda: micro.temporal_dw_v3_cuda(x, g, K),
               lambda: micro.temporal_dw_v3_plain(x, g, K), lib_dw, "dw",
               dw_plan(micro._pick_tile(s, 448)))]
    for mt in (448, 224):
        cases.append((f"v3p fwd tile<={mt}", "v3p",
                      lambda mt=mt: micro.temporal_v3p_cuda(x, w, K, mt),
                      lambda mt=mt: micro.temporal_v3p_plain(x, w, K, mt), lib_fwd, "fwd",
                      fwd_plan(micro._pick_tile(s, mt))))
    cases.append(("dw v2", "dw_v2", lambda: micro.temporal_dw_v2_cuda(x, g, K),
                  lambda: micro.temporal_dw_v2_plain(x, g, K), lib_dw, "dw", dw_plan(halved)))
    return cases


def micro_split(run) -> dict:
    """A micro design's device time per call by kernel (torch.profiler over
    5 calls): the pad pass, the GEMM, the reduce of the dw partials, and
    anything else (the dx's weight flip)."""
    split = dict(pad_ms=0.0, main_ms=0.0, reduce_ms=0.0, other_ms=0.0)
    for name, ms in breakdown(run, iters=5)["top_kernels_ms_per_iter"]:
        part = ("pad_ms" if "micro_pad_kernel" in name else
                "reduce_ms" if "micro_reduce_kernel" in name else
                "main_ms" if "micro_" in name else "other_ms")
        split[part] += ms
    return split


def phase_micro(card: str) -> dict:
    """K5-K9 at the micro-benchmark's three shapes against their plain
    versions, timed beside the plain version, the library call and the
    bound, with K2 / K3 at the same shapes; then the micro-benchmark itself
    at tpu1, its launches counted from 0."""
    print("== phase 3d: micro kernels (K5-K9)", flush=True)
    t0 = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    dev = torch.device(DEV)
    agg = {key: dict(max_abs_err=0.0, max_rel_err=0.0, ok=True, sites=[])
           for key in MICRO_KERNELS}
    failures = []
    for shape, (b, t, s, c, co) in kernel_micro.SHAPES.items():
        x = torch.randn((b, t, s, c), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((K, c, co), generator=gen, device=dev) * 0.05).to(torch.bfloat16)
        g = torch.randn((b, t, s, co), generator=gen, device=dev).to(torch.bfloat16)
        xs = (b, t, s, 1, c)  # S as H x W = S x 1 for the bounds
        bounds = {"fwd": bound("temporal_conv", xs, co), "dx": bound("temporal_conv",
                  (b, t, s, 1, co), c), "dw": bound("temporal_dw", xs, co)}
        for label, key, run, plain, lib, role, plan in micro_cases(x, w, g):
            tol = DW_TOL if role == "dw" else KERNEL_TOL
            got = run()
            torch.cuda.synchronize()
            ref = plain()
            torch.cuda.synchronize()
            scale = ref.float().abs().max().item()
            max_abs = (got.float() - ref.float()).abs().max().item()
            ok = bool(torch.isfinite(got).all().item()) and max_abs <= tol * scale
            note = ""
            if role == "dw":  # partials added in chunk order, no atomics
                same = torch.equal(got, run())
                ok = ok and same
                note = f" two launches bitwise equal={same}"
            del got, ref
            ms = time_ms(run, iters=10)
            plain_ms = time_ms(plain, iters=2, warmup=1)
            library_ms = time_ms(lib, iters=10)
            split = micro_split(run)
            note += "; device split: " + ", ".join(f"{part[:-3]} {v:.4f}"
                                                  for part, v in split.items() if v) + " ms"
            bound_ms, by = bounds[role]
            print(f"{shape:9s} {label:18s} {key:5s} x=({b},{t},{s},{c}) Co={co} (plan: {plan}) "
                  f"max_abs_err={max_abs:.3e} max_rel_err={max_abs / scale:.3e} (tol {tol})"
                  f"{note} kernel={ms:.4f} ms plain={plain_ms:.4f} ms library={library_ms:.4f} "
                  f"ms bound={bound_ms:.4f} ms ({by}) share={bound_ms / ms:.3f} ok={ok}",
                  flush=True)
            if not ok:
                failures.append((shape, label))
            a = agg[key]
            a["max_abs_err"] = max(a["max_abs_err"], max_abs)
            a["max_rel_err"] = max(a["max_rel_err"], max_abs / scale)
            a["ok"] = a["ok"] and ok
            a["sites"].append(dict(shape=shape, call=label, role=role, x=[b, t, s, c], co=co,
                                   plan=plan, max_abs_err=max_abs,
                                   max_rel_err=max_abs / scale, ms=ms, device_split=split,
                                   plain_ms=plain_ms, library_ms=library_ms,
                                   bound_ms=bound_ms, bound_by=by))
        # the production kernels at the same shape, for the designs' comparison
        prod = {"K2 fwd": lambda: ops.temporal_conv_cuda(x, w),
                "K2 dx": lambda: ops.temporal_conv_dx_cuda(g, w),
                "K3 dw": lambda: ops.temporal_dw_cuda(x, g, K)}
        print(f"{shape:9s} production kernels: " + ", ".join(
            f"{name} {time_ms(fn, iters=10):.4f} ms" for name, fn in prod.items())
            + f" ({card})", flush=True)
        del x, w, g
        torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"a micro kernel disagrees with its plain version at {failures}")
    # the path: the micro-benchmark's entry point, its launches from 0
    micro.reset_launch_counts()
    bench = kernel_micro.main(["--shape", "tpu1"])
    launches = dict(micro.launch_counts)
    print(f"launches of kernel_micro.main(['--shape', 'tpu1']): {launches}", flush=True)
    if not all(launches.values()):
        raise SystemExit(f"a micro kernel was not launched by the micro-benchmark: {launches}")
    torch.cuda.empty_cache()
    print(f"phase 3d took {time.perf_counter() - t0:.1f} s", flush=True)
    return dict(agg=agg, launches=launches, bench=bench)


def _cfg(kernels: str, compute_dtype: str = "bfloat16") -> ExperimentConfig:
    return ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=400, multilabel=True,
                          kernels=kernels, compute_dtype=compute_dtype),
        data=DataConfig(sampler=ClipSamplerConfig(clip_len=16, eval_mode="dense")),
    )


def phase_path(card: str) -> dict:
    print("== phase 4: path", flush=True)
    g = torch.Generator().manual_seed(SEED)
    state = get_model("r2plus1d_18", num_classes=400, device="cpu",
                      generator=g).state_dict()
    frames = make_frames(3, num_frames=160, height=128, width=171, seed=SEED)

    def read_frames(idx):
        return frames[idx]

    n_clips = 160 // 16
    chunks = -(-n_clips // CLIP_BATCH)
    cuda_tagger = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, device=DEV)
    torch_tagger = Tagger(_cfg("torch"), state, clip_batch=CLIP_BATCH, device=DEV)

    ops.reset_launch_counts()
    scores = cuda_tagger.scores_from(read_frames, len(frames))
    launches = dict(ops.launch_counts)
    print(f"launches over {chunks} chunks: {launches}")
    want = {k: n * chunks for k, n in FORWARD_LAUNCHES["cuda"].items()}
    if launches != want:
        raise SystemExit(f"launch counts {launches} != {want}")
    if scores.shape != (400,) or not np.isfinite(scores).all():
        raise SystemExit(f"bad scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    ref_scores = torch_tagger.scores_from(read_frames, len(frames))
    score_err = float(np.abs(scores - ref_scores).max())
    print(f"scores: cuda vs torch tagger max abs diff {score_err:.3e} (tol {PATH_TOL}); "
          f"top-5 cuda {np.argsort(-scores)[:5].tolist()} torch {np.argsort(-ref_scores)[:5].tolist()}")
    if score_err > PATH_TOL:
        raise SystemExit("scores of the kernels='cuda' tagger disagree with kernels='torch'")

    # Logits of one chunk: both bf16 paths against an f32 reference forward
    # (F.conv3d, TF32 off).
    torch.backends.cudnn.allow_tf32 = False
    clip_idx = np.arange(CLIP_BATCH * 16).reshape(CLIP_BATCH, 16)
    clips_u8 = torch.from_numpy(frames[clip_idx]).to(DEV)
    d = cuda_tagger.cfg.data
    f32_model = get_model("r2plus1d_18", num_classes=400, device=DEV, backend="torch",
                          dtype=torch.float32)
    f32_model.load_state_dict(state)
    with torch.inference_mode():
        x32 = preprocess_eval_clip(clips_u8, d.resize_hw, d.crop_hw, d.mean, d.std,
                                   out_dtype=torch.float32)
        ref = f32_model(x32)
        lc = cuda_tagger.model(x32.to(torch.bfloat16))
        lt = torch_tagger.model(x32.to(torch.bfloat16))
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err_cuda = (lc - ref).abs().max().item() / scale
        err_torch = (lt - ref).abs().max().item() / scale
        err_ct = (lc - lt).abs().max().item() / scale
        fwd_ms = {name: time_ms(lambda m=m: m(x32.to(torch.bfloat16)), iters=10)
                  for name, m in (("cuda", cuda_tagger.model), ("torch", torch_tagger.model))}
    print(f"logits (8 clips): max|logit| {scale:.3f}; max abs err / max|logit| vs the f32 "
          f"reference: kernels='cuda' {err_cuda:.3e}, kernels='torch' {err_torch:.3e}; "
          f"cuda vs torch {err_ct:.3e} (tol {PATH_TOL})")
    if not (err_ct <= PATH_TOL and err_cuda <= PATH_TOL):
        raise SystemExit("logits of the kernels='cuda' model disagree")

    rates = {}
    for name, tagger in (("cuda", cuda_tagger), ("torch", torch_tagger)):
        runs = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tagger.scores_from(read_frames, len(frames))
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        rates[name] = n_clips / float(np.median(runs))
        print(f"kernels='{name}': {rates[name]:.2f} clips/s through scores_from "
              f"({n_clips} clips, {chunks} chunks of {CLIP_BATCH}, median of 5), "
              f"forward of 8 clips {fwd_ms[name]:.3f} ms (CUDA events) on {card}")
    return launches


def _train_batch(cfg: ExperimentConfig) -> dict:
    """One seeded synthetic training batch: 128x171 uint8 clips whose content
    encodes the label, random crops and flips."""
    d, b = cfg.data, cfg.train.batch_size
    rng = np.random.default_rng(SEED)
    labels = np.arange(b) % cfg.model.num_classes
    rh, rw = d.resize_hw
    frames = np.stack([make_frames(int(label), num_frames=d.sampler.clip_len, height=rh,
                                   width=rw, seed=SEED + i) for i, label in enumerate(labels)])
    return {
        "frames": frames,
        "labels": labels.astype(np.int32),
        "crop_tops": rng.integers(0, rh - d.crop_hw[0] + 1, size=b).astype(np.int32),
        "crop_lefts": rng.integers(0, rw - d.crop_hw[1] + 1, size=b).astype(np.int32),
        "flips": rng.uniform(size=b) < 0.5,
        "weights": np.ones(b, np.float32),
    }


def _first_step_by_hand(state, cfg: ExperimentConfig, batch: dict):
    """Loss, logits and gradients of the state's model on ``batch`` in train
    mode (what the train step computes before its update); the gradients
    are dropped from the parameters again."""
    d = cfg.data
    model = state.model
    clips = preprocess_batch(batch["frames"], batch["crop_tops"], batch["crop_lefts"],
                             batch["flips"], d.mean, d.std, resize_hw=d.resize_hw,
                             crop_hw=d.crop_hw,
                             out_dtype=getattr(torch, cfg.model.compute_dtype))
    logits = model.train()(clips, generator=torch.Generator(device=DEV).manual_seed(SEED))
    loss = heads.softmax_cross_entropy(logits, batch["labels"], batch["weights"])
    loss.backward()
    grads = {name: p.grad.detach().clone() for name, p in model.named_parameters()}
    state.optimizer.zero_grad(set_to_none=True)
    return loss.detach(), logits.detach(), grads


def phase_train(card: str) -> dict:
    print("== phase 5: train", flush=True)
    cfgs = {"cuda": PRESETS["r2plus1d18_ucf101"]}
    cfgs["torch"] = dataclasses.replace(
        cfgs["cuda"], model=dataclasses.replace(cfgs["cuda"].model, kernels="torch"))
    cfg = cfgs["cuda"]
    m, t = cfg.model, cfg.train
    print(f"preset r2plus1d18_ucf101: {m.name}, {m.num_classes} classes, B={t.batch_size}, "
          f"{m.compute_dtype}, norm={m.norm}, dropout={m.dropout}, lr={t.base_lr}, "
          f"momentum={t.momentum}, weight_decay={t.weight_decay}")
    if t.batch_size != TRAIN_BATCH:
        raise SystemExit(f"the preset's batch size is {t.batch_size}, not {TRAIN_BATCH}")
    host_batch = _train_batch(cfg)
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in host_batch.items()}
    init = None
    first, result, launches = {}, {}, None
    for route in ("cuda", "torch"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(cfgs[route], steps_per_epoch=100, device=DEV,
                                   generator=torch.Generator().manual_seed(SEED))
        if init is None:
            init = {k: v.clone() for k, v in state.model.state_dict().items()}
        else:  # the same weights, whatever the init drew
            state.model.load_state_dict(init)
        first[route] = _first_step_by_hand(state, cfgs[route], batch)
        state.model.load_state_dict(init)  # undo the BN statistics' first move
        step = make_train_step(state.model, cfgs[route])
        gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        state, metrics = step(state, batch, gen)
        counts = dict(ops.launch_counts)
        losses = [metrics["loss"]]
        if route == "cuda":
            launches = counts
            print(f"launches of one training step: {counts}")
            if counts != TRAIN_STEP_LAUNCHES:
                raise SystemExit(f"launch counts {counts} != {TRAIN_STEP_LAUNCHES}")
        elif any(counts.values()):
            raise SystemExit(f"the kernels='torch' step launched hand kernels: {counts}")
        # the remaining steps on the repeated batch, without a host sync:
        # the losses are read after the last one
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        for _ in range(TRAIN_STEPS - 1):
            state, metrics = step(state, batch, gen)
            losses.append(metrics["loss"])
        end.record()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / (TRAIN_STEPS - 1)
        event_ms = start.elapsed_time(end) / (TRAIN_STEPS - 1)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(x) for x in losses]
        moved = max((state.model.state_dict()[k] - init[k]).abs().max().item()
                    for k in init if k.endswith((".mean", ".var")))
        finite = all(np.isfinite(losses))
        print(f"kernels='{route}': losses {['%.4f' % x for x in losses]} "
              f"top1 {float(metrics['top1']):.3f}; BN statistics moved by up to {moved:.3e}; "
              f"step {state.step}")
        print(f"kernels='{route}': {event_ms:.2f} ms/step (CUDA events), {wall_ms:.2f} ms/step "
              f"(wall, {TRAIN_STEPS - 1} steps, one sync at the end), "
              f"{TRAIN_BATCH / wall_ms * 1e3:.1f} clips/s at B={TRAIN_BATCH}, "
              f"peak memory {peak_gb:.2f} GB on {card}")
        if not finite:
            raise SystemExit(f"kernels='{route}': the loss is not finite")
        if not np.mean(losses[-3:]) < losses[0]:
            raise SystemExit(f"kernels='{route}': the loss did not fall on the repeated batch")
        if not moved > 0 or state.step != TRAIN_STEPS:
            raise SystemExit(f"kernels='{route}': BN statistics or the step count did not move")
        result[route] = dict(ms_per_step=event_ms, wall_ms_per_step=wall_ms,
                             clips_per_s=TRAIN_BATCH / wall_ms * 1e3, peak_memory_gb=peak_gb,
                             first_loss=losses[0], last_loss=losses[-1])
        del state, step
    # the f32 reference: F.conv3d everywhere, TF32 off, same weights and mask
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfgs["torch"], model=dataclasses.replace(
        cfgs["torch"].model, compute_dtype="float32"))
    state = create_train_state(cfg32, steps_per_epoch=100, device=DEV,
                               generator=torch.Generator().manual_seed(SEED))
    state.model.load_state_dict(init)
    l32, g32, d32 = _first_step_by_hand(state, cfg32, batch)
    del state
    torch.cuda.empty_cache()
    (lc, gc, dc), (lt, gt, dt) = first["cuda"], first["torch"]
    scale = gt.abs().max().item()
    logit_err = (gc - gt).abs().max().item() / scale
    loss_err = abs(lc.item() - lt.item()) / abs(lt.item())
    print(f"step 0, same weights and dropout mask: loss cuda {lc.item():.5f} torch "
          f"{lt.item():.5f} (relative diff {loss_err:.3e}); logits max abs diff / max|logit| "
          f"{logit_err:.3e} (max|logit| {scale:.3f}; tol {PATH_TOL})")
    print(f"step 0 against the f32 reference: loss {l32.item():.5f}; logits max abs diff / "
          f"max|logit|: cuda {(gc - g32).abs().max().item() / scale:.3e}, "
          f"torch {(gt - g32).abs().max().item() / scale:.3e}")

    def distance(a, ref):
        num = sum((a[k].float() - ref[k]).pow(2).sum().item() for k in ref) ** 0.5
        den = sum(ref[k].pow(2).sum().item() for k in ref) ** 0.5
        per = sorted((((a[k].float() - ref[k]).norm().item()
                       / max(ref[k].norm().item(), 1e-30), k) for k in ref), reverse=True)
        return num / den, per

    err_c, per_c = distance(dc, d32)
    err_t, per_t = distance(dt, d32)
    err_ct, _ = distance(dc, {k: v.float() for k, v in dt.items()})
    limit = GRAD_FACTOR * err_t + GRAD_SLACK
    print(f"step-0 gradients, ||g - g_f32|| / ||g_f32|| over all parameters: cuda {err_c:.3e}, "
          f"torch {err_t:.3e} (cuda may reach {limit:.3e}); cuda vs torch {err_ct:.3e}")
    for name, per in (("cuda", per_c), ("torch", per_t)):
        print(f"  kernels='{name}' per tensor: worst "
              + ", ".join(f"{k} {e:.3e}" for e, k in per[:3])
              + f"; median {per[len(per) // 2][0]:.3e}; best {per[-1][1]} {per[-1][0]:.3e}")
    if not (torch.isfinite(gc).all() and loss_err <= PATH_TOL and logit_err <= PATH_TOL):
        raise SystemExit("step-0 loss or logits of the kernels='cuda' route disagree")
    if not err_c <= limit:
        raise SystemExit("step-0 gradients of the kernels='cuda' route are further from the "
                         "f32 reference than the kernels='torch' route's allow")
    result["step0"] = dict(loss_cuda=lc.item(), loss_torch=lt.item(), loss_f32=l32.item(),
                           logits_cuda_vs_torch=logit_err, grad_dist_cuda_vs_f32=err_c,
                           grad_dist_torch_vs_f32=err_t, grad_dist_cuda_vs_torch=err_ct)
    return dict(launches=launches, routes=result)


def _eval_items():
    """The eval pack's videos: seeded synthetic frames at 128x171, each with
    a tag set of three of the 400 tags (its label first)."""
    rng = np.random.default_rng(SEED + 4)
    for i in range(EVAL_VIDEOS):
        tags = [int(v) for v in rng.choice(EVAL_CLASSES, size=3, replace=False)]
        frames = make_frames(tags[0], num_frames=EVAL_FRAMES, height=128, width=171,
                             seed=SEED + 10 + i)
        yield f"video{i}.mp4", tags[0], tags, frames


def _fused_apply(state, clips):
    return heads.predict_scores(r2plus1d_fused_infer(state, clips), True)


def phase_eval(card: str) -> dict:
    print("== phase 6: eval", flush=True)
    cfgs = {k: _cfg(k) for k in ("cuda", "torch")}
    g = torch.Generator().manual_seed(SEED + 2)
    state = get_model("r2plus1d_18", num_classes=EVAL_CLASSES, device="cpu",
                      generator=g).state_dict()
    rng = torch.Generator().manual_seed(SEED + 5)
    for name, v in state.items():  # BN statistics off the identity, so folding matters
        if name.endswith(".mean"):
            v += (torch.rand(v.shape, generator=rng) - 0.5) * 0.2
        elif name.endswith(".var"):
            v *= 0.8 + 0.4 * torch.rand(v.shape, generator=rng)
    state = {k: v.to(DEV) for k, v in state.items()}
    models = {}
    for k, cfg in cfgs.items():
        models[k] = get_model(cfg.model.name, num_classes=EVAL_CLASSES, device=DEV,
                              backend=cfg.model.kernels)
        models[k].load_state_dict(state)
    engines = {"cuda": (models["cuda"], cfgs["cuda"], None),
               "torch": (models["torch"], cfgs["torch"], None),
               "fused": (models["cuda"], cfgs["cuda"], _fused_apply)}
    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "eval.fvtpack")
        t0 = time.perf_counter()
        summary = write_pack_from_arrays(_eval_items(), path, (128, 171), num_tags=EVAL_CLASSES)
        ds = open_dataset(path, cfgs["cuda"].data, mode="eval")
        n_clips = sum(len(ds.get_eval_clips(i)[0]) for i in range(len(ds)))
        chunks = sum(-(-len(ds.get_eval_clips(i)[0]) // CLIP_BATCH) for i in range(len(ds)))
        print(f"pack: {summary['videos']} videos, {summary['frames']} frames, "
              f"{summary['bytes'] / 1e6:.1f} MB, written in {time.perf_counter() - t0:.2f} s; "
              f"{n_clips} dense clips in {chunks} chunks of {CLIP_BATCH}; num_tags {ds.num_tags}")
        scores = {}
        for name, (model, cfg, apply_fn) in engines.items():
            # the counted pass: video scores, as evaluate() aggregates them
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            s, records = evaluation.evaluate_video_scores(model, state, ds, cfg, CLIP_BATCH,
                                                          apply_fn=apply_fn)
            counts = dict(ops.launch_counts)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            want = {k: n * chunks for k, n in FORWARD_LAUNCHES[name].items()}
            print(f"{name}: launches over {chunks} chunks {counts}")
            if counts != want:
                raise SystemExit(f"{name}: launch counts {counts} != {want}")
            if s.shape != (EVAL_VIDEOS, EVAL_CLASSES) or not np.isfinite(s).all():
                raise SystemExit(f"{name}: bad video scores, shape {s.shape}")
            scores[name] = s
            # the timed passes: evaluate() end to end, metrics from the first
            runs, metrics = [], None
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = evaluation.evaluate(model, state, ds, cfg, CLIP_BATCH, apply_fn=apply_fn)
                torch.cuda.synchronize()
                runs.append(time.perf_counter() - t0)
                metrics = metrics or m
            print(f"{name}: metrics {metrics}")
            if metrics["num_videos"] != EVAL_VIDEOS or not np.isfinite(metrics["mAP"]):
                raise SystemExit(f"{name}: bad metrics {metrics}")
            result[name] = dict(metrics=metrics, launches=counts, peak_memory_gb=peak_gb,
                                clips_per_s=n_clips / float(np.median(runs)))
            print(f"{name}: top-5 tags of video 0 {np.argsort(-s[0])[:5].tolist()} "
                  f"(its tags {list(records[0].tags)})")
        fused_err = float(np.abs(scores["fused"] - scores["cuda"]).max())
        torch_err = float(np.abs(scores["torch"] - scores["cuda"]).max())
        print(f"video scores: fused vs kernels='cuda' max abs diff {fused_err:.3e}, torch vs "
              f"cuda {torch_err:.3e} (tol {PATH_TOL})")
        if fused_err > PATH_TOL:
            raise SystemExit("the fused engine's video scores disagree with kernels='cuda'")
        result["scores_fused_vs_cuda"] = fused_err
        result["scores_torch_vs_cuda"] = torch_err

        # One chunk of video 0: logits of the three engines against an f32
        # reference forward (F.conv3d, TF32 off), and forward ms.
        d = cfgs["cuda"].data
        clips_u8 = torch.from_numpy(ds.get_eval_clips(0)[0][:CLIP_BATCH]).to(DEV)
    torch.backends.cudnn.allow_tf32 = False
    f32_model = get_model("r2plus1d_18", num_classes=EVAL_CLASSES, device=DEV, backend="torch",
                          dtype=torch.float32)
    f32_model.load_state_dict(state)
    applies = {"cuda": evaluation._make_apply(models["cuda"], True),
               "torch": evaluation._make_apply(models["torch"], True),
               "fused": _fused_apply}
    with torch.inference_mode():
        x32 = preprocess_eval_clip(clips_u8, d.resize_hw, d.crop_hw, d.mean, d.std,
                                   out_dtype=torch.float32)
        xb = x32.to(torch.bfloat16)
        ref = f32_model(x32)
        logits = {"cuda": models["cuda"](xb), "torch": models["torch"](xb),
                  "fused": r2plus1d_fused_infer(state, x32)}
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        errs = {k: (v.float() - ref).abs().max().item() / scale for k, v in logits.items()}
        for name, apply in applies.items():
            result[name]["forward_ms"] = time_ms(lambda a=apply: a(state, xb), iters=10)
            result[name]["logits_vs_f32"] = errs[name]
    print(f"logits ({CLIP_BATCH} clips): max|logit| {scale:.3f}; max abs err / max|logit| vs "
          f"the f32 reference: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {PATH_TOL})")
    if errs["fused"] > PATH_TOL:
        raise SystemExit("the fused engine's logits disagree with the f32 reference")
    for name in engines:
        r = result[name]
        print(f"{name}: {r['clips_per_s']:.2f} clips/s through evaluate ({n_clips} clips, "
              f"median of 3), forward of {CLIP_BATCH} clips {r['forward_ms']:.3f} ms "
              f"(CUDA events), peak memory of an evaluate {r['peak_memory_gb']:.2f} GB "
              f"(both models' weights resident) on {card}")
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    card = phase_card()
    phase_build()
    agg = phase_kernels(card)
    phase_functions()
    k4 = phase_fused_kernel(card)
    micro_run = phase_micro(card)
    serving = phase_path(card)
    train = phase_train(card)
    ev = phase_eval(card)
    entries = []
    for kernel, meta in KERNELS.items():
        runs = {"serving": serving[kernel], "train_step": train["launches"][kernel],
                **{f"eval_{e}": ev[e]["launches"][kernel] for e in FORWARD_LAUNCHES}}
        if kernel == "fused_block":  # inference only: times per serving forward
            a, s = k4, k4["serving"]
            extra = dict(
                library_chain_ms=s["library_chain_ms"], unfused_chain_ms=s["unfused_chain_ms"],
                per=f"one r2plus1d_18 forward at clip_batch {CLIP_BATCH} (sum over its 13 "
                    f"launches); no single PyTorch call computes K4: library_chain_ms is "
                    f"F.conv3d -> affine -> ReLU -> F.conv3d")
        else:
            a = agg[kernel]
            s = a["train"]
            extra = dict(
                per=f"one r2plus1d_18 training step at B={TRAIN_BATCH} (sum over its launches)",
                train_step_by_role=a["train_roles"],
                serving_forward=dict(a["serving"], per=f"one forward at clip_batch {CLIP_BATCH}")
                if a["serving"]["ms"] else None)
        entries.append(dict(
            meta, launches=sum(runs.values()), launches_by_run=runs,
            max_abs_err=a["max_abs_err"], max_rel_err=a["max_rel_err"], ms=s["ms"],
            plain_ms=s["plain_ms"], bound_ms=s["bound_ms"],
            bound_by="operations" if s["ops_ms"] >= s["bytes_ms"] else "bytes",
            library_ms=s.get("library_ms"), ok=a["ok"], **extra, sites=a["sites"]))
    for key, meta in MICRO_KERNELS.items():  # K5-K9: the micro-benchmark's run
        a = micro_run["agg"][key]
        head = next(site for site in a["sites"]
                    if site["shape"] == "tpu1" and site["call"] == MICRO_HEADLINE[key])
        entries.append(dict(
            meta, launches=micro_run["launches"][key],
            launches_by_run={"micro": micro_run["launches"][key]},
            max_abs_err=a["max_abs_err"], max_rel_err=a["max_rel_err"], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], ok=a["ok"],
            per=f"one {MICRO_HEADLINE[key]} call at the micro-benchmark's tpu1 shape",
            sites=a["sites"]))
    print(json.dumps({"train": train["routes"], "eval": ev, "micro": micro_run["bench"],
                      "card": card}))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
