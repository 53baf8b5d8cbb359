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
            reference forward, metrics, clips/s and forward ms;
7. fit    — the loader-fed training path through its entry point,
            ``cli.train.main``, with the ``r2plus1d18_ucf101`` preset on a
            seeded ``.fvtpack`` (64 synthetic videos x 40 frames at 128x171,
            101 classes: 2 steps an epoch) and a 4-video val pack (an eval
            after each epoch): run A (2 epochs, checkpoints), run B (A's
            directory, ``--resume`` to 3 epochs), run C (3 epochs unbroken)
            and run L (run A on a 320-video pack, 10 steps an epoch, for
            the loader's steady state). Launches of each run (steps x (26,
            28, 14) plus eval chunks x (13, 14, 0)), finite losses, steps,
            epochs, evals and checkpoint saves per run; a restore of A's
            last checkpoint bitwise equal to A's final state; B's batches
            equal to C's (sha256, hashed after the runs); B's and C's final
            weights bitwise or within 1e-2 of each tensor's largest |value|
            (which of the two is printed); ms per step, clips/s and
            ``data_wait_frac`` from the metrics lines and the loader's time
            per batch, on run L's steps that pull a batch from a running
            loader, against phase 5; checkpoint save ms and size, peak
            memory;
8. entry points and knobs, on phase 7's packs with the same preset:
            (a) ``cli.train.main --cache-on-device`` on run L's pack (the
            pack copied to the card once, batches of cache rows gathered
            there): build seconds and bytes, ms per step of steps 2-10 of
            each epoch against run L's and phase 5's, ``data_wait_frac``,
            its first batch gathered on the card bitwise equal to
            ``train_batches``' first; (b) ``--grad-accum 2 --batch-size 16``
            (4 micro steps): ms per update, the parameters unchanged after
            micro step 1 and changed after micro step 2; (c) each remat
            policy ('full', 'dots', 'mid', 'conv') against 'none' on phase
            5's batch and weights: step-0 loss, gradients and BN statistics
            against 'none''s, ms per step, peak memory, K1-K3 launches per
            step (the recompute relaunches the forwards); (d)
            ``cli.evaluate`` on the val pack from (a)'s checkpoint
            directory, equal to ``evaluate()`` with the same weights; (e)
            ``cli.tag`` on the val pack from an ``export_weights`` file,
            equal to ``iter_pack_tags``; each run's launches counted; (f)
            K1-K3 (forward, dx, dw) against their plain versions at the
            hard accuracy benchmark's sites (B = 64, 8x32x32 clips, every
            stage, K2 and K3 at T = 1 included);
9. the zoo's other backbones: (a) one bf16 forward of each of c3d,
            p3d_63 / 131 / 199, r3d_18, mc3_18, s3d, s3d_g, i3d and both
            SlowFast variants (400 classes, seeded) at its serving clip
            (``ZOO_CLIPS``) and clip_batch 8, both routes: K1 / K2 launches
            against the count the routing gives (forward pre-hooks; P3D-63
            16 / 16), scores of 'cuda' against 'torch', ms per forward,
            clips/s, peak memory; (b) ``cli.evaluate --preset
            p3d63_kinetics`` equal to ``evaluate()`` and ``cli.tag --model
            c3d`` equal to ``Tagger``, on a pack of 256x342 frames; (c)
            ``cli.train --preset c3d_ucf101_smoke`` (B = 1), P3D-63 at
            32x224x224 (B = 8: launches per step 32 / 32 / 16, step-0 loss
            against 'torch', a falling loss, ms per step, peak memory) and
            ``cli.train --pretrained`` from an export of that state onto 51
            classes (the head re-initialized, every other tensor loaded
            bitwise); (d) K1-K3 (forward, dx, dw) against their plain
            versions at the K1 / K2 sites of (a)'s P3D-63 and S3D forwards,
            timed beside the bound and cuDNN.

The device splits of phases 3, 3c and 3d come from torch.profiler. Where it
records no device activity in three traces, a split is printed as not
measured: no check and no time in the ``kernels`` line depends on one.

The line before the last is a JSON object with one entry per kernel. Its
``launches`` is the kernel's launches over the main path's runs, phases 4 to
9 (each run counted from 0 just before it and read just after), and
``launches_by_run`` splits them by run; its times are per training step for
K1-K3 and per serving forward for K4 (inference only). K5-K9's path is the
micro-benchmark's run in phase 3d (``launches_by_run`` {"micro": n}); their
times are one call at the tpu1 shape (K6, K8 at tiles <= 448). The last
line is ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when no CUDA device is present.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
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
from fastvideotagging_tpu_torch.cli import evaluate as cli_evaluate
from fastvideotagging_tpu_torch.cli import tag as cli_tag
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.config import (
    PRESETS,
    ClipSamplerConfig,
    DataConfig,
    ExperimentConfig,
    ModelConfig,
)
from fastvideotagging_tpu_torch.data.device_cache import train_index_batches
from fastvideotagging_tpu_torch.data.packed import open_dataset, write_pack_from_arrays
from fastvideotagging_tpu_torch.data.pipeline import train_batches
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.evaluation import evaluate as evaluation
from fastvideotagging_tpu_torch.evaluation.tagger import iter_pack_tags
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as fused
from fastvideotagging_tpu_torch.ops import temporal_micro as micro
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_batch, preprocess_eval_clip
from fastvideotagging_tpu_torch.train import fit as fit_module
from fastvideotagging_tpu_torch.train.checkpoint import (
    CheckpointManager,
    export_weights,
    load_weights,
)
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
# phase 7: the train pack (64 videos = 2 steps an epoch at B = 32) and the
# val pack, 101 classes; run A trains 2 epochs, B resumes A to 3, C trains 3
FIT_VIDEOS, FIT_VAL_VIDEOS, FIT_FRAMES, FIT_CLASSES = 64, 4, 40, 101
FIT_EPOCHS_A, FIT_EPOCHS = 2, 3
# run L: run A on a pack of 5 copies of the train pack's videos (10 steps an
# epoch, 5x the prefetch depth), so most steps find the loader steady
FIT_LOADER_COPIES = 5
# B's and C's final weights when the step is not bitwise repeatable on the
# card: within 1e-2 of each tensor's largest |value|
FIT_TOL = 1e-2
# phase 8: gradient accumulation's micro batch and k (B = 16 x 2 = one
# update of the preset's 32 clips), the remat policies against 'none' (3
# steps each on phase 5's batch), the accuracy run's batch and clip
ACCUM_BATCH, ACCUM_K = 16, 2
REMAT_STEPS = 3
ACC_BATCH, ACC_T, ACC_HW = 64, 8, 32
# remat against 'none': the same math recomputed, so the step-0 loss, the
# gradients (||g - g_none|| / ||g_none||) and the BN statistics agree
# within PATH_TOL; the BN statistics within 1e-6 of their largest |value|
BN_TOL = 1e-6
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


def traced_kernels_ms(run, attempts: int = 3):
    """Device time per call of each kernel that ``run`` launches
    (torch.profiler over 5 calls), or None when the profiler records no
    device activity in any of ``attempts`` traces: the splits it feeds are
    then printed as not measured, and the checks and CUDA-event times that
    decide the run do not depend on them."""
    for _ in range(attempts):
        try:
            return breakdown(run, iters=5)["top_kernels_ms_per_iter"]
        except RuntimeError as e:
            if "no device activity" not in str(e):
                raise
    print(f"    the profiler recorded no device activity in {attempts} traces: "
          "device split not measured", flush=True)
    return None


def _split_note(split: dict | None, ms: float | None = None) -> str:
    """A split for a kernel's line; with ``ms``, every part and the device's
    sum against the call's time, else the parts that ran."""
    if split is None:
        return "; device split not measured"
    parts = ", ".join(f"{part[:-3]} {v:.4f}" for part, v in split.items() if v or ms)
    total = f" (device {sum(split.values()):.4f} of the call's {ms:.4f})" if ms else ""
    return f"; device split: {parts} ms{total}"


def k2_split(run) -> dict | None:
    """K2's device time per call by kernel (torch.profiler over 5 calls):
    the weight layout, the pad pass, the GEMM, the reduce."""
    kernels = traced_kernels_ms(run)
    if kernels is None:
        return None
    split = dict(layout_ms=0.0, pad_ms=0.0, main_ms=0.0, reduce_ms=0.0)
    for name, ms in kernels:
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
                    note += _split_note(split, ms)
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


def k4_split(run) -> dict | None:
    """K4's device time per call by kernel (torch.profiler over 5 calls):
    the weight layouts, the fused kernel and, with several groups, the
    reduce of the partials."""
    kernels = traced_kernels_ms(run)
    if kernels is None:
        return None
    split = dict(layout_ms=0.0, main_ms=0.0, reduce_ms=0.0)
    for name, ms in kernels:
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
              f"{bound_ms / ms:.3f} of the bound{_split_note(split)}) plain={plain_ms:.4f} "
              f"ms library chain={lib_ms:.4f} ms unfused K1+K2 chain={unf_ms:.4f} ms "
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
        for part in ("layout_ms", "reduce_ms"):  # None once a split is not measured
            sums[part] = None if split is None or sums[part] is None else (
                sums[part] + n * split[part])
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
          + ("time the weight layouts and the reduces: not measured"
             if sums["layout_ms"] is None else
             f"time the weight layouts take {sums['layout_ms']:.4f} ms and the reduces "
             f"{sums['reduce_ms']:.4f} ms"))
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


def micro_split(run) -> dict | None:
    """A micro design's device time per call by kernel (torch.profiler over
    5 calls): the pad pass, the GEMM, the reduce of the dw partials, and
    anything else (the dx's weight flip)."""
    kernels = traced_kernels_ms(run)
    if kernels is None:
        return None
    split = dict(pad_ms=0.0, main_ms=0.0, reduce_ms=0.0, other_ms=0.0)
    for name, ms in kernels:
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
            note += _split_note(split)
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
    return dict(launches=launches, routes=result, batch=host_batch, init=init)


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


def _fit_items(n: int, seed: int):
    """Seeded synthetic videos at 128x171 for a pack, labels over the 101
    classes."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        label = int(rng.integers(FIT_CLASSES))
        yield (f"video{i}.mp4", label, (),
               make_frames(label, num_frames=FIT_FRAMES, height=128, width=171, seed=seed + i))


def _batch_digest(batch: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(batch):
        h.update(k.encode())
        h.update(np.ascontiguousarray(batch[k]).tobytes())
    return h.hexdigest()


def _fit_state(state):
    """Model state_dict and momentum buffers of a TrainState (on the card)."""
    opt = state.optimizer.state_dict()["state"]
    return ({k: v.detach().clone() for k, v in state.model.state_dict().items()},
            {i: s["momentum_buffer"].clone() for i, s in opt.items()})


def phase_fit(card: str, train_result: dict, tmp: str) -> dict:
    """The loader-fed training path through its entry point,
    ``cli.train.main``: the r2plus1d18_ucf101 preset on a .fvtpack, run A
    (2 epochs, checkpoints, an eval after each epoch), B (A resumed to 3
    epochs), C (3 epochs unbroken) and L (A's run on a pack of 5x the
    videos: the loader in its steady state). The packs stay in ``tmp`` for
    phase 8."""
    print("== phase 7: fit", flush=True)
    t_phase = time.perf_counter()
    saves, kept, pulls = [], {}, {}
    orig_batches = fit_module.train_batches

    class TimedCheckpoints(CheckpointManager):
        def save(self, step, state, extra=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            super().save(step, state, extra)
            ms = (time.perf_counter() - t0) * 1e3
            saves.append(dict(dir=os.path.basename(self._dir), step=step,
                              epoch=extra["epoch"], ms=ms,
                              bytes=os.path.getsize(self._path(step))))

    def recorded_batches(run):
        """train_batches, timing each pull (the pool's wait and the
        collate, on device_prefetch's thread) and keeping B's and C's
        shared epoch by reference: they are hashed after the runs, off the
        timed path."""
        def batches(dataset, batch_size, epoch, **kw):
            source = orig_batches(dataset, batch_size, epoch, **kw)
            try:
                while True:
                    t0 = time.perf_counter()
                    b = next(source, None)
                    if b is None:
                        return
                    pulls.setdefault(run, []).append((time.perf_counter() - t0) * 1e3)
                    if epoch == FIT_EPOCHS - 1:
                        kept.setdefault(run, []).append(b)
                    yield b
            finally:
                source.close()
        return batches

    result = {}
    cfg = PRESETS["r2plus1d18_ucf101"]
    batch, depth = cfg.train.batch_size, cfg.data.prefetch_depth
    train, val = os.path.join(tmp, "train.fvtpack"), os.path.join(tmp, "val.fvtpack")
    loader = os.path.join(tmp, "loader.fvtpack")
    t0 = time.perf_counter()
    items = list(_fit_items(FIT_VIDEOS, SEED + 100))
    summary = write_pack_from_arrays(items, train, (128, 171))
    big = write_pack_from_arrays(
        ((f"copy{c}_{name}", label, tags, frames) for c in range(FIT_LOADER_COPIES)
         for name, label, tags, frames in items), loader, (128, 171))
    del items
    write_pack_from_arrays(_fit_items(FIT_VAL_VIDEOS, SEED + 300), val, (128, 171))
    val_ds = open_dataset(val, cfg.data, mode="eval")
    eval_chunks = sum(-(-len(val_ds.get_eval_clips(i)[0]) // CLIP_BATCH)
                      for i in range(len(val_ds)))
    print(f"train pack: {summary['videos']} videos x {FIT_FRAMES} frames at 128x171, "
          f"{summary['bytes'] / 1e6:.1f} MB; run L's pack {big['videos']} videos "
          f"({FIT_LOADER_COPIES} copies), {big['bytes'] / 1e6:.1f} MB; written in "
          f"{time.perf_counter() - t0:.2f} s; val pack {FIT_VAL_VIDEOS} videos, "
          f"{eval_chunks} eval chunks of {CLIP_BATCH}; B={batch}, prefetch depth {depth}")
    base = ["--preset", "r2plus1d18_ucf101", "--val-list", val, "--log-every", "1"]
    runs = {  # argv, first and last epoch, videos of the pack
        "A": (base + ["--train-list", train, "--epochs", str(FIT_EPOCHS_A),
                      "--checkpoint-dir", os.path.join(tmp, "a")],
              0, FIT_EPOCHS_A, FIT_VIDEOS),
        "B": (base + ["--train-list", train, "--epochs", str(FIT_EPOCHS),
                      "--checkpoint-dir", os.path.join(tmp, "a"), "--resume"],
              FIT_EPOCHS_A, FIT_EPOCHS, FIT_VIDEOS),
        "C": (base + ["--train-list", train, "--epochs", str(FIT_EPOCHS),
                      "--checkpoint-dir", os.path.join(tmp, "c")],
              0, FIT_EPOCHS, FIT_VIDEOS),
        "L": (base + ["--train-list", loader, "--epochs", str(FIT_EPOCHS_A),
                      "--checkpoint-dir", os.path.join(tmp, "l")],
              0, FIT_EPOCHS_A, FIT_VIDEOS * FIT_LOADER_COPIES),
    }
    states, launches = {}, {}
    fit_module.CheckpointManager = TimedCheckpoints
    try:
        for name, (argv, first_epoch, last_epoch, videos) in runs.items():
            metrics_path = os.path.join(tmp, f"{name}.jsonl")
            fit_module.train_batches = recorded_batches(name)
            n_saves = len(saves)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            state = cli_train.main(argv + ["--metrics-jsonl", metrics_path])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ops.launch_counts)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            with open(metrics_path) as f:
                lines = [json.loads(line) for line in f if line.strip()]
            steps = [r for r in lines if "loss" in r]
            evals = [r for r in lines if "eval_top1" in r]
            steps_per_epoch = videos // batch
            epochs = last_epoch - first_epoch
            n_steps = epochs * steps_per_epoch
            want = {"spatial_conv": 26 * n_steps + 13 * eval_chunks * epochs,
                    "temporal_conv": 28 * n_steps + 14 * eval_chunks * epochs,
                    "temporal_dw": 14 * n_steps, "fused_block": 0}
            step_ms = [batch / r["samples_per_sec"] * 1e3 for r in steps]
            print(f"run {name}: {' '.join(argv[argv.index('--epochs'):])}: "
                  f"{steps_per_epoch} steps an epoch, step {state.step}, {wall:.2f} s; "
                  f"launches {counts}")
            print(f"run {name}: losses {[round(r['loss'], 4) for r in steps]}, epochs "
                  f"{[r['epoch'] for r in steps]}; eval top1 "
                  f"{[r['eval_top1'] for r in evals]}")
            print(f"run {name}: ms per step {[round(x, 2) for x in step_ms]}, clips/s "
                  f"{[round(r['samples_per_sec'], 2) for r in steps]}, data_wait_frac "
                  f"{[r['data_wait_frac'] for r in steps]}; loader pull ms "
                  f"{[round(x, 2) for x in pulls[name]]}; peak memory {peak_gb:.2f} GB "
                  f"on {card}")
            for sv in saves[n_saves:]:
                print(f"run {name}: checkpoint step {sv['step']} (epoch {sv['epoch']}) "
                      f"{sv['bytes'] / 1e6:.1f} MB in {sv['ms']:.1f} ms")
            if counts != want:
                raise SystemExit(f"run {name}: launch counts {counts} != {want}")
            if not all(np.isfinite(r["loss"]) for r in steps):
                raise SystemExit(f"run {name}: a loss is not finite")
            want_epochs = [e for e in range(first_epoch, last_epoch)
                           for _ in range(steps_per_epoch)]
            want_saves = [((e + 1) * steps_per_epoch, e)
                          for e in range(first_epoch, last_epoch)]
            got_saves = [(sv["step"], sv["epoch"]) for sv in saves[n_saves:]]
            if (state.step != last_epoch * steps_per_epoch
                    or [r["epoch"] for r in steps] != want_epochs
                    or [r["step"] for r in steps] != list(range(
                        first_epoch * steps_per_epoch + 1, state.step + 1))
                    or len(evals) != epochs or got_saves != want_saves):
                raise SystemExit(f"run {name}: steps, epochs, evals or saves are wrong: "
                                 f"step {state.step}, saves {got_saves}")
            launches[name] = counts
            result[name] = dict(
                steps=len(steps), steps_per_epoch=steps_per_epoch, wall_s=wall,
                losses=[r["loss"] for r in steps], ms_per_step=step_ms,
                clips_per_s=[r["samples_per_sec"] for r in steps],
                data_wait_frac=[r["data_wait_frac"] for r in steps],
                loader_pull_ms=pulls[name],
                eval_top1=[r["eval_top1"] for r in evals], peak_memory_gb=peak_gb,
                saves=saves[n_saves:])
            if name == "A":
                # what a resume of A restores, on the card, against A's
                # final state (the one its last checkpoint saved)
                fresh = create_train_state(cfg, steps_per_epoch, device=DEV)
                _, extra = CheckpointManager(os.path.join(tmp, "a")).restore(fresh)
                (sd_a, opt_a), (sd_r, opt_r) = _fit_state(state), _fit_state(fresh)
                same = (fresh.step == state.step and extra["epoch"] == FIT_EPOCHS_A - 1
                        and all(torch.equal(sd_r[k], v) for k, v in sd_a.items())
                        and set(opt_r) == set(opt_a)
                        and all(torch.equal(opt_r[i], v) for i, v in opt_a.items()))
                print(f"restore of A's last checkpoint (step {fresh.step}, epoch "
                      f"{extra['epoch']}) equals A's final state bitwise: {same}")
                if not same:
                    raise SystemExit("the restored state differs from A's final state")
                del fresh, sd_a, opt_a, sd_r, opt_r
            elif name in ("B", "C"):
                states[name] = _fit_state(state)
            del state
    finally:
        fit_module.CheckpointManager = CheckpointManager
        fit_module.train_batches = orig_batches
    digests = {run: [_batch_digest(b) for b in kept.get(run, [])] for run in ("B", "C")}
    del kept
    if not digests["B"] or digests["B"] != digests["C"]:
        raise SystemExit("run B's batches differ from run C's at the same steps")
    print(f"B's {len(digests['B'])} batches equal C's (sha256 of every array, "
          f"hashed after the runs)")
    (sd_b, opt_b), (sd_c, opt_c) = states["B"], states["C"]
    per = sorted((((sd_b[k].float() - v.float()).abs().max().item(), k,
                   v.float().abs().max().item()) for k, v in sd_c.items()), reverse=True)
    bitwise = all(torch.equal(sd_b[k], v) for k, v in sd_c.items()) and all(
        torch.equal(opt_b[i], v) for i, v in opt_c.items())
    worst = max(d / max(m, 1e-30) for d, _, m in per)
    print(f"B vs C final weights: max abs diff per tensor, largest first: "
          + ", ".join(f"{k} {d:.3e}" for d, k, _ in per[:5])
          + f"; worst / max|value| {worst:.3e}")
    held = "bitwise" if bitwise else f"within {FIT_TOL} of each tensor's largest |value|"
    if not bitwise and worst > FIT_TOL:
        raise SystemExit("runs B and C end with different weights")
    print(f"B and C agree {held}")
    run_l = result["L"]
    n = run_l["steps_per_epoch"]
    # run L's steady steps: device_prefetch's thread gathers up to depth + 1
    # batches ahead, so at most the first `depth` steps of an epoch wait for the
    # loader's start and in the last `depth` the epoch's batches are all
    # gathered; the steps between find the loader running
    idx = [e * n + k - 1 for e in range(FIT_EPOCHS_A) for k in range(depth + 1, n - depth + 1)]
    steady = dict(
        steps=[i + 1 for i in idx], ms_per_step=[run_l["ms_per_step"][i] for i in idx],
        data_wait_frac=[run_l["data_wait_frac"][i] for i in idx],
        data_wait_ms=[run_l["data_wait_frac"][i] * run_l["ms_per_step"][i] for i in idx],
        loader_pull_ms=[run_l["loader_pull_ms"][i] for i in idx])
    med = float(np.median(steady["ms_per_step"]))
    firsts = {r: [v["data_wait_frac"][i] for i in range(0, v["steps"], v["steps_per_epoch"])]
              for r, v in result.items()}
    saves_ms = [sv["ms"] for r in result.values() for sv in r["saves"]]
    print(f"fit, steady state (run L, {n} steps an epoch, steps {depth + 1}-{n - depth} of "
          f"each): {med:.2f} ms per step median ({min(steady['ms_per_step']):.2f}-"
          f"{max(steady['ms_per_step']):.2f}), {batch / med * 1e3:.1f} clips/s; "
          f"data_wait_frac {steady['data_wait_frac']} = "
          f"{[round(x, 2) for x in steady['data_wait_ms']]} ms; the loader's pull (pool "
          f"wait and collate, on device_prefetch's thread) of those batches "
          f"{[round(x, 2) for x in steady['loader_pull_ms']]} ms; "
          f"each epoch's first step's data_wait_frac {firsts}; phase 5, frames on the card: "
          f"{train_result['cuda']['wall_ms_per_step']:.2f} ms per step (wall), "
          f"{train_result['cuda']['ms_per_step']:.2f} (CUDA events); checkpoint save "
          f"{float(np.median(saves_ms)):.1f} ms median of {len(saves_ms)}, "
          f"{saves[0]['bytes'] / 1e6:.1f} MB; on {card}")
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches={k: sum(launches[r][k] for r in launches) for k in KERNELS},
                runs=result, bitwise_b_vs_c=bitwise, b_vs_c_worst=worst,
                steady=steady, steady_ms_per_step=med,
                packs=dict(train=train, loader=loader, val=val, eval_chunks=eval_chunks))


def _quiet(fn, *args):
    """``fn(*args)`` and what it printed to stdout, kept off the script's."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def _counted(fn, *args):
    """``fn(*args)`` with the kernels' launches counted from 0, and its
    wall seconds (to the card's last op)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, dict(ops.launch_counts), time.perf_counter() - t0


def _step_ms(metrics_path: str, batch: int) -> tuple[list, list]:
    with open(metrics_path) as f:
        steps = [r for r in map(json.loads, f) if "loss" in r]
    return [batch / r["samples_per_sec"] * 1e3 for r in steps], steps


def _train_want(steps: int, eval_chunks: int = 0) -> dict:
    return {"spatial_conv": 26 * steps + 13 * eval_chunks,
            "temporal_conv": 28 * steps + 14 * eval_chunks,
            "temporal_dw": 14 * steps, "fused_block": 0}


def phase_entry_points(card: str, tmp: str, train: dict, fit_run: dict) -> dict:
    """Phase 8: the train step's knobs and the entry points of the last
    slice, on phase 7's packs with the r2plus1d18_ucf101 preset: (a) the
    device cache through ``cli.train.main``, (b) gradient accumulation,
    (c) each remat policy against 'none', (d) ``cli.evaluate`` against
    ``evaluate()``, (e) ``cli.tag`` against ``iter_pack_tags``."""
    print("== phase 8: entry points and knobs", flush=True)
    t_phase = time.perf_counter()
    cfg = PRESETS["r2plus1d18_ucf101"]
    packs, b = fit_run["packs"], cfg.train.batch_size
    launches, result = {}, {}
    base = ["--preset", "r2plus1d18_ucf101", "--log-every", "1"]

    # (a) the device cache: run L's pack and epochs with --cache-on-device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    built, firsts = [], []
    orig_build, orig_index = fit_module.build_cache, fit_module.train_index_batches

    def timed_build(dataset, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = orig_build(dataset, **kw)
        torch.cuda.synchronize()
        built.append((time.perf_counter() - t0, cache))
        return cache

    def first_batch(dataset, cache, batch_size, epoch, **kw):
        for i, batch in enumerate(orig_index(dataset, cache, batch_size, epoch, **kw)):
            if epoch == 0 and i == 0:
                firsts.append({k: v.copy() for k, v in batch.items()})
            yield batch

    ckpt_a = os.path.join(tmp, "cache")
    metrics = os.path.join(tmp, "cache.jsonl")
    fit_module.build_cache, fit_module.train_index_batches = timed_build, first_batch
    try:
        state, counts, wall = _counted(cli_train.main, base + [
            "--train-list", packs["loader"], "--epochs", str(FIT_EPOCHS_A),
            "--checkpoint-dir", ckpt_a, "--cache-on-device", "--metrics-jsonl", metrics])
    finally:
        fit_module.build_cache, fit_module.train_index_batches = orig_build, orig_index
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n = FIT_VIDEOS * FIT_LOADER_COPIES // b
    ms, steps = _step_ms(metrics, b)
    launches["cache"] = counts
    build_s, cache = built[0]
    later = [ms[e * n + k] for e in range(FIT_EPOCHS_A) for k in range(1, n)]
    run_l = fit_run["runs"]["L"]["ms_per_step"]
    later_l = [run_l[e * n + k] for e in range(FIT_EPOCHS_A) for k in range(1, n)]
    p5 = train["routes"]["cuda"]["wall_ms_per_step"]
    print(f"(a) --cache-on-device on run L's pack: cache {cache.nbytes / 1e6:.1f} MB built in "
          f"{build_s:.3f} s; {len(steps)} steps in {wall:.2f} s; launches {counts}; peak "
          f"memory {peak_gb:.2f} GB on {card}")
    print(f"(a) ms per step, steps 2-{n} of each epoch: median {np.median(later):.2f} "
          f"({min(later):.2f}-{max(later):.2f}) against run L's loader-fed "
          f"{np.median(later_l):.2f} ({min(later_l):.2f}-{max(later_l):.2f}) and phase 5's "
          f"{p5:.2f} (wall, frames on the card); all steps {[round(x, 2) for x in ms]}; "
          f"data_wait_frac {[r['data_wait_frac'] for r in steps]}")
    if counts != _train_want(len(steps)) or len(steps) != FIT_EPOCHS_A * n:
        raise SystemExit(f"(a) steps {len(steps)} or launches {counts} are wrong")
    if not all(np.isfinite(r["loss"]) for r in steps) or state.step != FIT_EPOCHS_A * n:
        raise SystemExit("(a) a loss is not finite or the step count is wrong")
    # its first batch, gathered on the card, against the loader's first batch
    ds = open_dataset(packs["loader"], cfg.data, mode="train", seed=cfg.train.seed)
    want = next(iter(train_batches(ds, b, 0, num_workers=cfg.data.num_workers)))
    got = firsts[0]
    frames = cache.frames[torch.as_tensor(got["rows"], device=DEV).long()].cpu().numpy()
    same = np.array_equal(frames, want["frames"]) and all(
        np.array_equal(got[k], want[k]) for k in want if k != "frames")
    print(f"(a) the first batch gathered on the card equals train_batches' first batch "
          f"(seed {cfg.train.seed}, epoch 0) bitwise: {same}")
    if not same:
        raise SystemExit("(a) the device cache's batch differs from the loader's")
    result["cache"] = dict(build_s=build_s, bytes=cache.nbytes, ms_per_step=ms,
                           data_wait_frac=[r["data_wait_frac"] for r in steps],
                           median_ms_steps_2_on=float(np.median(later)),
                           run_l_median_ms_steps_2_on=float(np.median(later_l)),
                           phase5_wall_ms=p5, peak_memory_gb=peak_gb)
    del cache, built, state
    torch.cuda.empty_cache()

    # (b) gradient accumulation: 2 epochs of 4 micro steps of 16 at k = 2 on
    # the train pack (the first update takes the B = 16 shapes' first calls)
    snaps, orig_step = [], fit_module.make_train_step

    def snapshot_step(model, cfg_, **kw):
        step = orig_step(model, cfg_, **kw)

        def run(state_, batch, gen, *rest):
            if not snaps:
                snaps.append([p.detach().clone() for p in model.parameters()])
            out = step(state_, batch, gen, *rest)
            if len(snaps) < 3:
                snaps.append([p.detach().clone() for p in model.parameters()])
            return out
        return run

    metrics = os.path.join(tmp, "accum.jsonl")
    fit_module.make_train_step = snapshot_step
    try:
        torch.cuda.reset_peak_memory_stats()
        state, counts, wall = _counted(cli_train.main, base + [
            "--train-list", packs["train"], "--epochs", "2", "--checkpoint-dir", "",
            "--batch-size", str(ACCUM_BATCH), "--grad-accum", str(ACCUM_K),
            "--metrics-jsonl", metrics])
    finally:
        fit_module.make_train_step = orig_step
    ms, steps = _step_ms(metrics, ACCUM_BATCH)
    micro = 2 * FIT_VIDEOS // ACCUM_BATCH
    launches["grad_accum"] = counts
    frozen = all(torch.equal(a, c) for a, c in zip(snaps[0], snaps[1]))
    moved = any(not torch.equal(a, c) for a, c in zip(snaps[1], snaps[2]))
    updates = [ms[i] + ms[i + 1] for i in range(0, len(ms) - 1, ACCUM_K)]
    print(f"(b) --grad-accum {ACCUM_K} --batch-size {ACCUM_BATCH}: {len(steps)} micro steps, "
          f"state.step {state.step}, launches {counts}; ms per micro step "
          f"{[round(x, 2) for x in ms]}, per update {[round(x, 2) for x in updates]} (median "
          f"of the later {float(np.median(updates[1:])):.2f}) against phase 5's {p5:.2f} for "
          f"one step of {b}; params unchanged after micro step 1: {frozen}, changed after "
          f"micro step 2: {moved}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if counts != _train_want(micro) or state.step != micro or not (frozen and moved):
        raise SystemExit("(b) gradient accumulation: launches, steps or the update are wrong")
    if not all(np.isfinite(r["loss"]) for r in steps):
        raise SystemExit("(b) a loss is not finite")
    result["grad_accum"] = dict(ms_per_micro_step=ms, ms_per_update=updates,
                                median_ms_per_later_update=float(np.median(updates[1:])),
                                frozen_after_micro_1=frozen, moved_after_micro_2=moved)
    del snaps, state
    torch.cuda.empty_cache()

    # (c) remat: each policy against 'none' on phase 5's batch and weights
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in train["batch"].items()}
    ref, remat, launches["remat"] = None, {}, {k: 0 for k in KERNELS}
    for policy in ("none", "full", "dots", "mid", "conv"):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, remat=policy))
        state = create_train_state(rcfg, steps_per_epoch=100, device=DEV)
        state.model.load_state_dict(train["init"])
        loss, _logits, grads = _first_step_by_hand(state, rcfg, batch)
        stats = {k: v.clone() for k, v in state.model.state_dict().items()
                 if k.endswith((".mean", ".var"))}
        state.model.load_state_dict(train["init"])
        step = make_train_step(state.model, rcfg)
        gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
        step(state, batch, gen)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REMAT_STEPS):
            state, m = step(state, batch, gen)
        end.record()
        torch.cuda.synchronize()
        counts = dict(ops.launch_counts)
        for k in KERNELS:
            launches["remat"][k] += counts[k]
        r = dict(ms_per_step=start.elapsed_time(end) / REMAT_STEPS,
                 peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                 launches_per_step={k: v / REMAT_STEPS for k, v in counts.items()},
                 loss=loss.item(), last_loss=float(m["loss"]))
        if ref is None:
            ref = (loss, grads, stats)
        else:
            num = sum((grads[k].float() - ref[1][k].float()).pow(2).sum().item() for k in grads)
            den = sum(ref[1][k].float().pow(2).sum().item() for k in grads)
            r["loss_rel_diff"] = abs(loss.item() - ref[0].item()) / abs(ref[0].item())
            r["grad_dist"] = (num / den) ** 0.5
            r["bn_max_rel"] = max((stats[k] - v).abs().max().item() / v.abs().max().item()
                                  for k, v in ref[2].items())
            r["bitwise"] = (torch.equal(loss, ref[0]) and all(
                torch.equal(grads[k], ref[1][k]) for k in grads) and all(
                torch.equal(stats[k], v) for k, v in ref[2].items()))
        remat[policy] = r
        print(f"(c) remat={policy!r}: {r['ms_per_step']:.2f} ms per step, peak memory "
              f"{r['peak_memory_gb']:.2f} GB, K1 / K2 / K3 launches per step "
              f"{counts['spatial_conv'] / REMAT_STEPS:g} / "
              f"{counts['temporal_conv'] / REMAT_STEPS:g} / "
              f"{counts['temporal_dw'] / REMAT_STEPS:g}; step-0 loss {r['loss']:.5f}"
              + ("" if policy == "none" else
                 f", against 'none': loss {r['loss_rel_diff']:.3e}, gradients "
                 f"{r['grad_dist']:.3e}, BN statistics {r['bn_max_rel']:.3e} (tol {PATH_TOL}, "
                 f"BN {BN_TOL}), bitwise {r['bitwise']}"), flush=True)
        if policy != "none" and not (r["loss_rel_diff"] <= PATH_TOL and r["grad_dist"] <= PATH_TOL
                                     and r["bn_max_rel"] <= BN_TOL):
            raise SystemExit(f"(c) remat={policy!r} differs from 'none'")
        if not np.isfinite(r["last_loss"]):
            raise SystemExit(f"(c) remat={policy!r}: the loss is not finite")
        del state, step, grads, stats
        torch.cuda.empty_cache()
    result["remat"] = remat
    del ref, batch

    # (d) cli.evaluate from (a)'s checkpoint directory against evaluate()
    argv = ["--preset", "r2plus1d18_ucf101", "--val-list", packs["val"],
            "--checkpoint-dir", ckpt_a]
    (out, printed), counts, wall = _counted(_quiet, cli_evaluate.main, argv)
    launches["cli_evaluate"] = counts
    sd, _ = CheckpointManager(ckpt_a).restore_weights()
    sd = {k: v.to(DEV) for k, v in sd.items()}
    model = model_from_config(cfg.model, device=DEV)
    direct = evaluation.evaluate(model, sd, open_dataset(packs["val"], cfg.data, mode="eval"),
                                 cfg)
    same = json.loads(printed.strip().splitlines()[-1]) == direct == out
    print(f"(d) cli.evaluate: {printed.strip()} in {wall:.2f} s, launches {counts}; equals "
          f"evaluate() with the same weights: {same}")
    if not same or counts != _train_want(0, packs["eval_chunks"]):
        raise SystemExit("(d) cli.evaluate differs from evaluate() or its launches are wrong")

    # (e) cli.tag from an export_weights file against iter_pack_tags
    weights = os.path.join(tmp, "weights.pt")
    export_weights(weights, sd)
    argv = [packs["val"], "--preset", "r2plus1d18_ucf101", "--weights", weights,
            "--threshold", "0.0", "--top-k", "5"]
    (_, printed), counts, wall = _counted(_quiet, cli_tag.main, argv)
    launches["cli_tag"] = counts
    tagger = Tagger(cfg, load_weights(weights), device=DEV)
    direct = [json.dumps({"video": path, "tags": [{"tag": r.tag, "score": round(r.score, 5)}
                                                  for r in results]})
              for path, results in iter_pack_tags(tagger, packs["val"], threshold=0.0,
                                                  top_k=5)]
    lines = printed.strip().splitlines()
    same = lines == direct
    print(f"(e) cli.tag: {len(lines)} lines in {wall:.2f} s, launches {counts}; the first "
          f"{lines[0]}; equal to iter_pack_tags: {same}")
    # the preset's 'center' eval: one clip, one chunk a video
    if not same or counts != _train_want(0, len(lines)):
        raise SystemExit("(e) cli.tag differs from iter_pack_tags or its launches are wrong")
    result["cli"] = dict(evaluate=out, tag_lines=len(lines))
    del model, sd, tagger
    torch.cuda.empty_cache()
    print(f"phase 8 (a-e) took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches=launches, result=result)


def accuracy_sites(b: int = ACC_BATCH):
    """r2plus1d_18's (2+1)D conv sites at the accuracy run's 8x32x32 clips:
    (site, kernel, x shape, Co). Stage 4 (T = 1, 2x2) is on the list though
    the model sends it to F.conv3d (the kernels take T >= 2 and H, W >= k,
    as the JAX routing does)."""
    sites = [("stem_temporal", "temporal_conv", (b, ACC_T, ACC_HW // 2, ACC_HW // 2, 45), 64)]
    t, hw = ACC_T, ACC_HW // 2
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = max(1, t // 2), hw // 2
        m = r2plus1d_mid_channels(c, c)
        sites.append((f"stage{stage + 1}_spatial", "spatial_conv", (b, t, hw, hw, c), m))
        sites.append((f"stage{stage + 1}_temporal", "temporal_conv", (b, t, hw, hw, m), c))
    return sites


def phase_accuracy_sites() -> dict:
    """Phase 8f: K1-K3 (forward, dx, temporal dw) against their plain
    versions at the accuracy run's sites, bf16 on the card."""
    print("== phase 8f: K1-K3 at the accuracy run's sites (B = 64, 8x32x32)", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 8)
    worst, failures = {}, []
    for site, kernel, xs, co in accuracy_sites():
        on_path = (ops.spatial_eligible(xs, K, 1) if kernel == "spatial_conv"
                   else ops.temporal_eligible(xs, K, 1))
        for role, key, run, plain, _lib, _bound, _others in site_cases(kernel, xs, co, gen):
            tol = DW_TOL if role == "dw" else KERNEL_TOL
            got = run()
            ref = plain()
            scale = max(ref.float().abs().max().item(), 1e-30)
            err = (got.float() - ref.float()).abs().max().item() / scale
            ok = bool(torch.isfinite(got).all().item()) and err <= tol
            worst[key] = max(worst.get(key, 0.0), err)
            print(f"  {site:16s} {role:3s} {key:13s} x={xs} Co={co} max_rel_err={err:.3e} "
                  f"(tol {tol}){'' if on_path else ' (F.conv3d on the path)'} ok={ok}")
            if not ok:
                failures.append((site, role))
    torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"a kernel disagrees with its plain version at {failures}")
    return worst


# ---------------------------------------------------------------------------
# phase 9: the zoo's other backbones
# ---------------------------------------------------------------------------

# the zoo names this phase adds to the path, and each one's serving clip
# (T, H, W): the preset's geometry where there is one (c3d_ucf101_smoke,
# p3d63_kinetics, slowfast_stretch), else the one its JAX module's docstring
# names: 16x112x112 for Tran'18's VideoResNets, the 224 geometry of the
# S3D / I3D heads (at the Kinetics presets' 32 frames), and P3D-63's preset
# for its deeper siblings
ZOO_CLIPS = {
    "c3d": (16, 112, 112), "p3d_63": (32, 224, 224), "p3d_131": (32, 224, 224),
    "p3d_199": (32, 224, 224), "r3d_18": (16, 112, 112), "mc3_18": (16, 112, 112),
    "s3d": (32, 224, 224), "s3d_g": (32, 224, 224), "i3d": (32, 224, 224),
    "slowfast_r2plus1d": (32, 224, 224), "slowfast_r2plus1d_tpu": (32, 224, 224),
}
ZOO_CLASSES = 400
# P3D-63's K1 / K2 launches per forward at 32 frames (every stage keeps
# T = 16 and H, W >= 7) and per training step (forward + dx; K3 once per
# temporal site)
P3D63_FORWARD = {"spatial_conv": 16, "temporal_conv": 16}
P3D63_STEP = {"spatial_conv": 32, "temporal_conv": 32, "temporal_dw": 16, "fused_block": 0}
# phase 9c: P3D-63's training batch at 32x224x224 (bf16 activations, the
# Norms' f32 copies kept for the backward: about 4 GB a clip), its steps;
# the packs of 9b / 9c
ZOO_TRAIN_BATCH, ZOO_TRAIN_STEPS = 8, 6
ZOO_PACK_VIDEOS, ZOO_PACK_FRAMES = 2, 72
# the packs' frames: the Kinetics presets' 256x342 (9b's val pack, also
# cli.tag's for C3D, which center-crops 112x112 from it) and the C3D preset's
# 128x171 (9c)
ZOO_EVAL_HW, ZOO_C3D_CROP, ZOO_C3D_HW = (256, 342), (112, 112), (128, 171)


class RoutedSites:
    """Forward pre-hooks on a model's factorized convs: the calls the
    routing of ops/conv2plus1d.py sends to K1 / K2 (``backend='cuda'`` and
    eligible), counted, and their (kernel, x shape, Co) kept."""

    def __init__(self, model):
        from fastvideotagging_tpu_torch.models.layers import SpatialConv, TemporalConv

        self.counts = {"spatial_conv": 0, "temporal_conv": 0}
        self.sites = []
        self.handles = []
        for m in model.modules():
            if isinstance(m, (SpatialConv, TemporalConv)):
                self.handles.append(m.register_forward_pre_hook(self._hook))

    def _hook(self, module, args):
        from fastvideotagging_tpu_torch.models.layers import SpatialConv

        xs = tuple(args[0].shape)
        spatial = isinstance(module, SpatialConv)
        eligible = (ops.spatial_eligible(xs, module.k, module.stride) if spatial
                    else ops.temporal_eligible(xs, module.k, module.stride))
        if module.backend == "cuda" and eligible:
            kernel = "spatial_conv" if spatial else "temporal_conv"
            self.counts[kernel] += 1
            self.sites.append((kernel, xs, module.kernel.shape[-1]))

    def remove(self):
        for h in self.handles:
            h.remove()


def _zoo_model(name: str, backend: str = "cuda", state=None):
    """``name`` on the card (seeded, 400 classes, bf16, eval mode); with
    ``state``, those weights."""
    kw = {"clip_shape": ZOO_CLIPS[name]} if name == "c3d" else {}
    m = get_model(name, num_classes=ZOO_CLASSES, device="cpu", backend=backend,
                  generator=torch.Generator().manual_seed(SEED), **kw)
    if state is not None:
        m.load_state_dict(state)
    return m.to(DEV).eval()


def phase_zoo_serving(card: str) -> dict:
    """9a: one bf16 forward of every new zoo name at its serving clip and
    clip_batch 8, both routes: K1 / K2 launches against the routing's
    count, scores of 'cuda' against 'torch', ms per forward, clips/s and
    peak memory."""
    print("== phase 9a: the zoo's other backbones, one forward each", flush=True)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 9)
    result, sites, launches = {}, {}, {k: 0 for k in KERNELS}
    for name, (t, h, w) in ZOO_CLIPS.items():
        torch.cuda.empty_cache()
        m_cuda = _zoo_model(name)
        m_torch = _zoo_model(name, "torch", m_cuda.state_dict())
        x = torch.randn((CLIP_BATCH, t, h, w, 3), generator=gen, device=DEV).to(torch.bfloat16)
        routed = RoutedSites(m_cuda)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with torch.inference_mode():
            y_cuda = m_cuda(x)
            torch.cuda.synchronize()
            counts = dict(ops.launch_counts)
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            y_torch = m_torch(x)
        routed.remove()
        for k in KERNELS:
            launches[k] += counts[k]
        want = dict(routed.counts, temporal_dw=0, fused_block=0)
        s_cuda, s_torch = (torch.softmax(y.float(), -1) for y in (y_cuda, y_torch))
        err = (s_cuda - s_torch).abs().max().item()
        lerr = ((y_cuda.float() - y_torch.float()).abs().max()
                / y_torch.float().abs().max().clamp_min(1e-30)).item()
        with torch.inference_mode():
            ms = {r: time_ms(lambda m=m: m(x), iters=3, warmup=1)
                  for r, m in (("cuda", m_cuda), ("torch", m_torch))}
        finite = bool(torch.isfinite(y_cuda).all().item())
        ok = finite and counts == want and err <= PATH_TOL and y_cuda.shape == (
            CLIP_BATCH, ZOO_CLASSES)
        if name == "p3d_63":
            ok = ok and {k: counts[k] for k in P3D63_FORWARD} == P3D63_FORWARD
        result[name] = dict(
            clip=[CLIP_BATCH, t, h, w], launches={k: counts[k] for k in P3D63_FORWARD},
            routed=routed.counts, score_max_abs_diff=err, logit_rel_diff=lerr,
            ms=ms, clips_per_s={r: CLIP_BATCH / v * 1e3 for r, v in ms.items()},
            peak_memory_gb=peak_gb, ok=ok)
        print(f"  {name:22s} {CLIP_BATCH}x{t}x{h}x{w}: K1/K2 launches "
              f"{counts['spatial_conv']}/{counts['temporal_conv']} (routing "
              f"{routed.counts['spatial_conv']}/{routed.counts['temporal_conv']}); scores cuda "
              f"vs torch {err:.3e}, logits {lerr:.3e} (tol {PATH_TOL}); forward "
              f"{ms['cuda']:.2f} ms cuda / {ms['torch']:.2f} ms torch = "
              f"{CLIP_BATCH / ms['cuda'] * 1e3:.1f} / {CLIP_BATCH / ms['torch'] * 1e3:.1f} "
              f"clips/s; peak {peak_gb:.2f} GB on {card} ok={ok}", flush=True)
        if name in ("p3d_63", "s3d"):
            sites[name] = sorted(set(routed.sites))
        if not ok:
            raise SystemExit(f"9a: {name} failed (launches {counts}, routing {want}, "
                             f"score diff {err:.3e}, finite {finite})")
        del m_cuda, m_torch, x, y_cuda, y_torch
    return dict(result=result, sites=sites, launches=launches)


def _zoo_pack(path: str, hw, n: int = ZOO_PACK_VIDEOS, frames: int = ZOO_PACK_FRAMES,
              num_tags: int | None = None):
    """A seeded pack of ``n`` synthetic videos at ``hw``, video i of class
    i (with ``num_tags``, tagged {i})."""
    items = [(f"zoo{i}.mp4", i, (i,) if num_tags else (),
              make_frames(i, num_frames=frames, height=hw[0], width=hw[1], seed=SEED + 90 + i))
             for i in range(n)]
    return write_pack_from_arrays(items, path, hw, num_tags=num_tags)


def phase_zoo_entry_points(card: str, tmp: str) -> dict:
    """9b: ``cli.evaluate --preset p3d63_kinetics`` against ``evaluate()``
    and ``cli.tag --model c3d`` against ``Tagger`` (iter_pack_tags), on a
    pack of 256x342 frames."""
    print("== phase 9b: cli.evaluate (p3d63_kinetics) and cli.tag (c3d)", flush=True)
    from fastvideotagging_tpu_torch.cli.common import add_common_flags, build_config

    launches = {}
    pack = os.path.join(tmp, "zoo_val.fvtpack")
    _zoo_pack(pack, ZOO_EVAL_HW)
    cfg = PRESETS["p3d63_kinetics"]
    state = create_train_state(cfg, 1, device=DEV, generator=torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(tmp, "zoo_p3d")
    CheckpointManager(ckpt).save(0, state, {"epoch": 0})
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    argv = ["--preset", "p3d63_kinetics", "--val-list", pack, "--checkpoint-dir", ckpt]
    (out, printed), counts, wall = _counted(_quiet, cli_evaluate.main, argv)
    launches["zoo_cli_evaluate"] = counts
    model = model_from_config(cfg.model, device=DEV)
    direct = evaluation.evaluate(model, sd, open_dataset(pack, cfg.data, mode="eval"), cfg)
    same = json.loads(printed.strip().splitlines()[-1]) == direct == out
    chunks = counts["temporal_conv"] // P3D63_FORWARD["temporal_conv"]
    want = {k: chunks * P3D63_FORWARD.get(k, 0) for k in KERNELS}
    print(f"(b) cli.evaluate --preset p3d63_kinetics: {printed.strip()} in {wall:.2f} s, "
          f"launches {counts} ({chunks} forwards of {P3D63_FORWARD}); equals evaluate(): "
          f"{same}")
    if not same or not chunks or counts != want:
        raise SystemExit("9b: cli.evaluate differs from evaluate() or its launches are wrong")
    del model, sd
    torch.cuda.empty_cache()

    weights = os.path.join(tmp, "zoo_c3d.pt")
    export_weights(weights, _zoo_model("c3d").state_dict())
    flags = ["--model", "c3d", "--num-classes", str(ZOO_CLASSES),
             "--resize", *map(str, ZOO_EVAL_HW), "--crop", *map(str, ZOO_C3D_CROP)]
    argv = [pack] + flags + ["--weights", weights, "--threshold", "0.0", "--top-k", "5"]
    (_, printed), counts, wall = _counted(_quiet, cli_tag.main, argv)
    launches["zoo_cli_tag"] = counts
    p = argparse.ArgumentParser()
    add_common_flags(p)
    tcfg = build_config(p.parse_args(flags))
    tagger = Tagger(tcfg, load_weights(weights), device=DEV)
    direct = [json.dumps({"video": path, "tags": [{"tag": r.tag, "score": round(r.score, 5)}
                                                  for r in results]})
              for path, results in iter_pack_tags(tagger, pack, threshold=0.0, top_k=5)]
    lines = printed.strip().splitlines()
    same = lines == direct
    print(f"(b) cli.tag --model c3d: {len(lines)} lines in {wall:.2f} s, launches {counts}; "
          f"the first {lines[0]}; equal to Tagger: {same}")
    if not same or any(counts.values()):
        raise SystemExit("9b: cli.tag differs from Tagger or launched a hand kernel")
    del tagger
    torch.cuda.empty_cache()
    return dict(launches=launches, pack=pack, evaluate=out, tag_lines=len(lines))


def phase_zoo_train(card: str, tmp: str, val_pack: str) -> dict:
    """9c: ``cli.train --preset c3d_ucf101_smoke``; P3D-63 at 32x224x224
    (launches per step, step-0 loss against 'torch', a falling loss, ms
    per step, peak memory); ``cli.train --pretrained`` from an export of
    that state onto another class count."""
    print("== phase 9c: training (c3d_ucf101_smoke, p3d_63, --pretrained)", flush=True)
    launches, result = {}, {}

    # cli.train with the C3D preset (B = 1) on a 128x171 pack
    pack = os.path.join(tmp, "zoo_c3d.fvtpack")
    _zoo_pack(pack, ZOO_C3D_HW, n=4, frames=24, num_tags=101)  # the preset is multilabel
    metrics = os.path.join(tmp, "zoo_c3d.jsonl")
    torch.cuda.reset_peak_memory_stats()
    state, counts, wall = _counted(cli_train.main, [
        "--preset", "c3d_ucf101_smoke", "--train-list", pack, "--tag-lists", "--epochs", "1",
        "--log-every", "1", "--checkpoint-dir", "", "--metrics-jsonl", metrics])
    launches["zoo_train_c3d"] = counts
    ms, steps = _step_ms(metrics, 1)
    result["c3d"] = dict(steps=len(steps), loss=[r["loss"] for r in steps], ms_per_step=ms,
                         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"(c) cli.train --preset c3d_ucf101_smoke: {len(steps)} steps in {wall:.2f} s, "
          f"losses {[round(r['loss'], 5) for r in steps]}, ms per step "
          f"{[round(v, 2) for v in ms]}, launches {counts}, peak "
          f"{result['c3d']['peak_memory_gb']:.2f} GB on {card}")
    if len(steps) != 4 or state.step != 4 or any(counts.values()) or not all(
            np.isfinite(r["loss"]) for r in steps):
        raise SystemExit("9c: the C3D preset's run is wrong")
    del state
    torch.cuda.empty_cache()

    # P3D-63 at the Kinetics geometry, both routes from the same weights
    cfg = dataclasses.replace(PRESETS["p3d63_kinetics"], train=dataclasses.replace(
        PRESETS["p3d63_kinetics"].train, batch_size=ZOO_TRAIN_BATCH))
    batch = _train_batch(cfg)
    routes = {}
    start = None
    for route in ("cuda", "torch"):
        rcfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, kernels=route))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = create_train_state(rcfg, 10, device=DEV,
                                   generator=torch.Generator().manual_seed(SEED))
        if start is None:
            start = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
        else:
            state.model.load_state_dict(start)
        step = make_train_step(state.model, rcfg)
        routed = RoutedSites(state.model)
        n_steps = ZOO_TRAIN_STEPS if route == "cuda" else 1
        losses, per_step = [], []
        for i in range(n_steps):
            gen = torch.Generator(device=DEV).manual_seed(SEED + 1)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            state, m = step(state, batch, gen)
            t1.record()
            torch.cuda.synchronize()
            losses.append(float(m["loss"]))
            per_step.append(t0.elapsed_time(t1))
            if i == 0:
                step_counts = dict(ops.launch_counts)
                rc = routed.counts  # forward + dx; K3 once per temporal site
                want = {"spatial_conv": 2 * rc["spatial_conv"],
                        "temporal_conv": 2 * rc["temporal_conv"],
                        "temporal_dw": rc["temporal_conv"], "fused_block": 0}
                routed.remove()
        launches[f"zoo_train_p3d_{route}"] = dict(step_counts)
        routes[route] = dict(losses=losses, ms_per_step=per_step,
                             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                             launches_step0=step_counts)
        print(f"(c) p3d_63 kernels='{route}', B={ZOO_TRAIN_BATCH} at 32x224x224: losses "
              f"{[round(v, 5) for v in losses]}, ms per step {[round(v, 1) for v in per_step]}, "
              f"launches of step 0 {step_counts} (routing {want}), peak "
              f"{routes[route]['peak_memory_gb']:.2f} GB on {card}", flush=True)
        if route == "cuda":
            if step_counts != want or step_counts != P3D63_STEP:
                raise SystemExit(f"9c: P3D-63's launches {step_counts} != {want} / {P3D63_STEP}")
            if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
                raise SystemExit(f"9c: P3D-63's loss does not fall: {losses}")
            trained = {k: v.detach().to("cpu", copy=True)
                       for k, v in state.model.state_dict().items()}
        elif any(step_counts.values()):
            raise SystemExit("9c: kernels='torch' launched a hand kernel")
        del state, step
    loss_diff = abs(routes["cuda"]["losses"][0] - routes["torch"]["losses"][0]) / abs(
        routes["torch"]["losses"][0])
    print(f"(c) p3d_63 step-0 loss cuda vs torch: {loss_diff:.3e} relative (tol {PATH_TOL})")
    if loss_diff > PATH_TOL:
        raise SystemExit("9c: P3D-63's step-0 loss differs between the routes")
    result["p3d_63"] = dict(routes, step0_loss_rel_diff=loss_diff)
    del batch, start
    torch.cuda.empty_cache()

    # --pretrained: the trained P3D-63 (400 classes) onto 51 classes
    weights = os.path.join(tmp, "zoo_p3d.pt")
    export_weights(weights, trained)
    loaded = {}
    orig_apply = fit_module._apply_pretrained

    def spy(state, variables):
        orig_apply(state, variables)
        loaded.update({k: v.detach().to("cpu", copy=True)
                       for k, v in state.model.state_dict().items()})

    fit_module._apply_pretrained = spy
    try:
        state, counts, wall = _counted(cli_train.main, [
            "--preset", "p3d63_kinetics", "--num-classes", "51", "--train-list", val_pack,
            "--batch-size", str(ZOO_PACK_VIDEOS), "--epochs", "1", "--log-every", "1",
            "--checkpoint-dir", "", "--pretrained", weights])
    finally:
        fit_module._apply_pretrained = orig_apply
    launches["zoo_pretrained"] = counts
    body = [k for k in trained if not k.startswith("fc.")]
    bitwise = all(torch.equal(loaded[k], trained[k]) for k in body)
    head = tuple(loaded["fc.weight"].shape)
    print(f"(c) cli.train --pretrained (p3d_63, 400 -> 51 classes): {len(body)} tensors "
          f"loaded bitwise: {bitwise}; head {head} re-initialized; 1 step in {wall:.2f} s, "
          f"launches {counts}")
    if not bitwise or head != (51, 2048) or state.step != 1 or counts != P3D63_STEP:
        raise SystemExit("9c: --pretrained did not load the export as it should")
    result["pretrained"] = dict(bitwise=bitwise, head=head, launches=counts)
    del state, trained, loaded
    torch.cuda.empty_cache()
    return dict(launches=launches, result=result)


def phase_zoo_sites(card: str, sites: dict) -> dict:
    """9d: K1-K3 (forward, dx, temporal dw) against their plain versions at
    the K1 / K2 sites of P3D-63 and S3D in 9a's forwards (clip_batch 8),
    timed beside the bound and cuDNN."""
    print("== phase 9d: K1-K3 at the P3D-63 and S3D sites (clip_batch 8)", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    worst, rows, failures = {}, [], []
    for model, model_sites in sites.items():
        for kernel, xs, co in model_sites:
            for role, key, run, plain, lib, (b_ms, b_by), _ in site_cases(kernel, xs, co, gen):
                tol = DW_TOL if role == "dw" else KERNEL_TOL
                got, ref = run(), plain()
                scale = max(ref.float().abs().max().item(), 1e-30)
                err = (got.float() - ref.float()).abs().max().item() / scale
                ok = bool(torch.isfinite(got).all().item()) and err <= tol
                ms, lib_ms = time_ms(run, iters=3, warmup=1), time_ms(lib, iters=3, warmup=1)
                worst[key] = max(worst.get(key, 0.0), err)
                rows.append(dict(model=model, kernel=key, role=role, x=list(xs), co=co, err=err,
                                 ms=ms, bound_ms=b_ms, bound_by=b_by, cudnn_ms=lib_ms, ok=ok))
                print(f"  {model:6s} {role:3s} {key:13s} x={xs} Co={co} max_rel_err={err:.3e} "
                      f"(tol {tol}) {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                      f"{b_ms / ms:.0%}), cuDNN {lib_ms:.4f} ms ok={ok}", flush=True)
                if not ok:
                    failures.append((model, xs, role))
        torch.cuda.empty_cache()
    print(f"9d on {card}: {len(rows)} calls")
    if failures:
        raise SystemExit(f"9d: a kernel disagrees with its plain version at {failures}")
    return dict(worst=worst, rows=rows)


def phase_zoo(card: str) -> dict:
    t_phase = time.perf_counter()
    serving = phase_zoo_serving(card)
    with tempfile.TemporaryDirectory() as tmp:
        entry = phase_zoo_entry_points(card, tmp)
        train = phase_zoo_train(card, tmp, entry["pack"])
    sites = phase_zoo_sites(card, serving["sites"])
    launches = {"zoo_serving": serving["launches"], **entry["launches"], **train["launches"]}
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return dict(launches=launches, serving=serving["result"], train=train["result"],
                entry=dict(evaluate=entry["evaluate"], tag_lines=entry["tag_lines"]),
                sites_worst=sites["worst"], sites=sites["rows"])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    agg = phase_kernels(card)
    phase_functions()
    k4 = phase_fused_kernel(card)
    micro_run = phase_micro(card)
    serving = phase_path(card)
    train = phase_train(card)
    ev = phase_eval(card)
    with tempfile.TemporaryDirectory() as tmp:
        fit_run = phase_fit(card, train["routes"], tmp)
        entry = phase_entry_points(card, tmp, train, fit_run)
    acc_sites = phase_accuracy_sites()
    zoo = phase_zoo(card)
    entries = []
    for kernel, meta in KERNELS.items():
        runs = {"serving": serving[kernel], "train_step": train["launches"][kernel],
                **{f"eval_{e}": ev[e]["launches"][kernel] for e in FORWARD_LAUNCHES},
                "fit": fit_run["launches"][kernel],
                **{run: c[kernel] for run, c in entry["launches"].items()},
                **{run: c[kernel] for run, c in zoo["launches"].items()}}
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
            library_ms=s.get("library_ms"), ok=a["ok"], **extra, sites=a["sites"],
            **({"accuracy_sites_max_rel_err": acc_sites[kernel]} if kernel in acc_sites
               else {}),
            **({"zoo_sites_max_rel_err": zoo["sites_worst"][kernel]}
               if kernel in zoo["sites_worst"] else {})))
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
                      "fit": {k: v for k, v in fit_run.items() if k not in ("launches", "packs")},
                      "entry_points": entry["result"],
                      "zoo": {k: zoo[k] for k in ("serving", "train", "entry", "sites")},
                      "card": card}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
