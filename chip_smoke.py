"""Chip smoke run of the PyTorch port on one NVIDIA GPU (an H100 for the
numbers the repo keeps).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. card   — name, power limit and device count;
2. build  — compile every csrc/*.cu kernel (one nvcc per source, in
            parallel) and print ptxas' register / shared memory report;
            then the host line: the host data plane's resize
            (``native.resize_batch_u8``, csrc/framepack.c built with the
            system C compiler) against its plain numpy version at 240x320
            -> 128x171 (within one level) and at a 2x upscale (equal), both
            timed on the host;
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
            function and the least time the card could take, with its plan
            (K5, K6 and K8: the frame ring's ``ring_plan``; K9 and K7: the
            dw ring's ``dw_ring_plan``, with its x and g re-reads and
            partial bytes) and its device time split between its kernels
            (pad copies, main kernel, reduce); K2 and K3 at the same shapes,
            timed, K5's, K6's and K8's share of the bound printed beside
            K2's (read x once against once per tap), K9's time and share
            beside K3's (the TMA-fed dw ring against cp.async slabs) and
            K7's beside K9's and K3's (the clipped walk against the padded);
            then the micro-benchmark's entry point
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

10. int8 serving (ops/int8_infer.py on Q1 and Q2, ops/int8_conv.py): (a) Q1
            at every int8 site of r2plus1d_18 (the stem and stages 1-3, the
            sites recorded from one static forward) at clip_batch 8 and at
            B = 32: bitwise against its plain version with the identity
            epilogue, within one bf16 ulp with the real one, timed beside the
            plain version, torch._int_mm over an explicit im2col (the library
            column, timed only), the bf16 route at the same site (K1 / K2
            where they take it, else cuDNN) and the least time the card could
            take (1,979 TOPS int8, 3.35 TB/s), with its plan and ptxas'
            registers and spills; and at every call of a dynamic forward that
            reduces the next site's amax in its epilogue: the bf16 output and
            the amax bitwise against its plain version, the parent's unfused
            chain and the bf16 store followed by Q2's amax pass, timed with
            and without the amax (CUDA events and the profiler's device
            time); (b) Q2 at every quantize site of the dynamic forward in its
            mode there (the quantize pass from the reduced amax; both passes
            at the input site), bitwise against its plain version in the
            static, dynamic and amax-given modes, the wrapper's time beside
            the device's, the bare C entry point's and the wrapper's host
            time, and the bound of one read of y and the int8 write;
            (c) Tagger(int8=True) on phase 4's video: Q1 / Q2 / amax launches
            (28 / 1 / 0 a static forward, 28 / 26 / 1 a dynamic one), scores
            within 5e-2 of the same engine with Q1 and Q2's plain versions on
            the same qpack, beside bf16 'cuda''s (a figure: the weights are
            random), the int8 engine's clips/s against bf16 'cuda' at
            clip_batch 8 and B = 32 (CUDA events), the per-video calibration's
            ms; (d) ``cli.tag --int8`` and ``cli.evaluate --int8`` on phase
            7/8's val pack (equal to their library calls) and ``cli.serve``
            (with and without ``--int8``) on piped stdin: a pack, a JSON
            object with ``top_k`` and a missing path, which gives an error
            line while the daemon goes on; (e) every other covered name
            (ops/arch_spec.py's COVERED_MODELS) at its serving clip
            (``INT8_FAMILY_CLIPS``: phase 9's, 16x112x112 for the R(2+1)D
            family) and clip_batch 8, seeded random weights with the head
            scaled to unit logits: ``make_int8_apply`` (the calibration's ms,
            CUDA events), the static, dynamic and bf16 forwards' ms, each
            mode's Q1 / Q2 / amax launches against the walk's calls and Q1's
            against the spec's int8 convs, the default mode's sigmoid scores
            within PATH_TOL of the bf16 'cuda' model's, ``Tagger(int8=True)``
            on a dense 8-clip video within PATH_TOL of the bf16 Tagger; Q1 at
            every distinct call of the families' static and dynamic forwards
            (the identity epilogue bitwise against its plain version, the
            form bitwise or within one bf16 ulp, two launches bitwise equal,
            the share of the bound) and Q2 at every distinct (y, dtype, mode)
            call, bitwise.
11. export (evaluation/serving.py, cli/export.py; the serving kernels as
            ``fvt::*`` custom ops, ops/library.py): (a) ``cli.export
            --preset r2plus1d18_ucf101 --clip-batch 8`` of seeded random
            weights, bf16 and ``--int8 --calib-video`` (phase 4's video as a
            one-video pack), the seconds and the artifact's bytes, and the
            same two engines through ``export_serving`` at B = 32; (b) each
            artifact loaded in a fresh ``python3`` process that imports
            evaluation/serving.py alone, its scores on clips the parent saved
            against the in-process serving fn's (within 1e-3); (c) a
            forward's launches there (K1 13 / K2 14; Q1 28 / Q2 1, stage 4's
            K1 / K2 3 / 3) against the in-process forward's; (d) a
            ``torch.export`` of the dynamic int8 engine on the same qpack:
            the in-place amax ops in its graph, 28 / 26 / 1 launches a
            forward, scores against the eager dynamic forward; (e) a
            forward's ms loaded against in-process (CUDA events, 20 forwards)
            at B = 8 and 32: in the fresh process, and in turns in this one
            (in-process, loaded, loaded, in-process) with the host's enqueue
            time a forward beside; (f) the host time a call of K1, K2, Q1 and Q2
            through its ``fvt::*`` op and through the bare wrapper: the
            dispatcher's cost.
12. native serving (csrc/fvt_ops.cpp, csrc/native_runner.cpp,
            native/runner.py, evaluation/native_tagger.py): (a) the op
            library and the CUDA runner built with g++ against libtorch (in
            a thread from phase 2 on), the seconds; (b) ``cli.export
            --format native`` of phase 11's weights, bf16 and ``--int8``
            at clip_batch 8, and the dynamic int8 engine through
            ``export_serving_native``: AOTInductor packages, their seconds
            and bytes; (c) each package in the runner, one shot on seeded
            uint8 clips: scores within 5e-2 of the in-process ``ServingFn``
            (Inductor's glue rounds elsewhere), the C++ op library's
            launches a forward (K1 13 / K2 14; Q1 28 / Q2 1; Q1 28 / Q2 26
            + 1 amax pass; stage 4's K1 / K2 3 / 3), and no libpython in
            the ``--serve`` daemon's /proc/<pid>/maps; a malformed request
            line answered with an error line and the daemon alive after it;
            (d) ``NativeTagger`` over phase 6's kind of eval pack, sequential
            and ``--pipeline 2``, against the in-process ``Tagger`` (within
            5e-2), ``cli.tag --engine native`` and ``cli.serve --engine
            native`` (a pack, a missing path answered with an error line, a
            JSON request after it); (e) in turns (in-process, native,
            loaded, loaded, native, in-process): the in-process forward and
            phase 11's loaded ``serving.pt2`` by CUDA events, the runner's
            ``--bench`` (its own CUDA events on its execution stream and the
            host's two-point slope), at clip_batch 8.
13. parallelism (parallel/, train/shardmap_step.py, train/time_sharded.py,
            evaluation/long_clip.py; about 2 minutes): (a) an NCCL group of
            world size 1 runs the data-parallel step (BatchNorm statistics
            and gradients all-reduced) on phase 5's preset for 2 steps; its
            losses, weights and BN statistics equal the plain step's bit for
            bit, with K1 / K2 / K3 launches a step; (b) ``cli.train
            --coordinator 127.0.0.1:<port> --num-processes 2 --process-id
            {0,1} --dist-backend gloo``, two processes sharing the card,
            3 steps at global B = 16, against one process on the global
            batch, in bf16 (kernels='cuda') and in float64 activations on
            F.conv3d: both ranks' weights equal; in f64 step 1's loss,
            gradients and BN statistics within PAR_F64_TOL of one
            process; in bf16 the loss within PATH_TOL and the gradients
            within PAR_BF16_DIST and PAR_BF16_NORM; each rank's launches
            and ms a step by CUDA events beside one process's; (c)
            64x112x112 clips at B = 2 over the same two processes:
            ``score_long_clip`` (K2 over halo'd slabs) against the
            unsharded forward within PATH_TOL, with the halo bytes a
            forward and each rank's peak memory beside the unsharded
            forward's, and one time-sharded train step against the
            unsharded step, in f64 within PAR_F64_TOL and in bf16 within
            PATH_TOL (loss), PAR_BF16_DIST and PAR_BF16_NORM (gradients).
            Each gradient limit is first shown to reject a zeroed, a
            halved and a doubled gradient; (d) channel sharding: the
            ``slowfast_stretch`` preset's model at its published widths
            (base_width 64, stage_blocks (1, 1, 1, 1), 400 classes) on
            32x224x224 clips at B = 4, data 1 x model 2 over the same two
            processes, 2 steps against the unsharded step in one process,
            in bf16 (loss within PATH_TOL, gradients gathered over the model
            group within PAR_BF16_DIST / PAR_BF16_NORM) and in f64
            (``f64_config``: loss, gradients and BN statistics within
            PAR_F64_TOL), each rank's conv kernels half the unsharded
            model's, its peak memory, ms a step beside the unsharded step's
            and the bytes all-gathered and all-reduced a step; then
            ``cli.train --preset slowfast_stretch`` over the two processes
            for one step with a checkpoint (whole kernels) and
            ``cli.evaluate --preset slowfast_stretch`` on it in this
            process (unsharded, with the warning). SlowFast's convs are
            F.conv3d (no hand kernel), so (d) adds no launches. Each rank
            is a ``python3 -c`` subprocess from the checkout's root under
            one deadline; a failing rank kills the others and fails the
            run.
14. the step profiler (utils/step_profiler.py): ``profile_train_step`` on
            the ``r2plus1d18_ucf101`` preset at B = 32, ``profile_eval_step``
            for r2plus1d_18 in bf16 at clip_batch 8 and in static int8 at B
            = 32, PROFILE_STEPS traced steps each: the categories, the
            closure of the conv floors, the rows with the largest slack, the
            reference's conv roofline and its share of a step's CUDA-event
            time, StepTimer's seconds a step. The device time attributed
            must lie within PROFILE_CLOSURE of the traced busy time, every
            hand kernel's launch under a conv site, and at least one step
            captured (a trace that records no device activity is taken
            again, PROFILE_ATTEMPTS in all).
15. the accuracy scripts (``benchmarks/accuracy_hard.py``,
            ``int8_s3d.py``, ``int8_family.py``, ``int8_inception.py``,
            ``accuracy_kinetics_geom.py``, ``examples/train_synthetic.py``)
            through their entry points at ACC_CLASSES classes and
            ACC_EPOCHS epochs of one step, on packs: finite scores, the
            card in each record, K1 / K2 / K3 launched by accuracy_hard's
            r2plus1d_18 training, and each int8 record's Q1 / Q2 launches
            a forward equal to the engine walk's calls (Q1's to the
            spec's int8 convs); every launch of K1-K4, Q1 and Q2 counted
            across the scripts' own resets.
16. the serving forwards as captured CUDA graphs (evaluation/graphed.py):
            r2plus1d_18 bf16 through ``Tagger`` at 8 clips (its scores
            against the same Tagger on the eager walk) and the i3d and s3d
            int8 engines (``make_int8_engine``) static and dynamic at B =
            32, 16x112x112: graphed against eager bit for bit, the launch
            counts of k replays equal to k eager walks, a second call's
            clips leaving the first call's result as it was, a second
            qpack copied in without a recapture, and the graphed and eager
            ms a forward (CUDA events, the fastest of GRAPH_WINDOWS windows
            of GRAPH_ITERS forwards after one not kept, every window
            printed), each beside its idle share of the card over
            GRAPH_ITERS traced forwards.

The device splits of phases 3, 3c and 3d come from torch.profiler. Where it
records no device activity in three traces, a split is printed as not
measured: no check and no time in the ``kernels`` line depends on one.

The line before the last is a JSON object with one entry per kernel. Its
``launches`` is the kernel's launches over the main path's runs, phases 4 to
9 (each run counted from 0 just before it and read just after), and
``launches_by_run`` splits them by run; its times are per training step for
K1-K3 and per serving forward for K4 (inference only). K5-K9's path is the
micro-benchmark's run in phase 3d (``launches_by_run`` {"micro": n}); their
times are one call at the tpu1 shape (K6, K8 at tiles <= 448). Q1's and
Q2's path is phase 10's int8 runs; phase 11's runs add ``"export"`` to
every entry's ``launches_by_run`` (its CLI exports, in-process forwards,
the fresh process's forwards and the dynamic export's forwards, timing
loops left out), phase 12's ``"native"`` (the runner processes' counts
from the C++ op library: one shot, bench, the daemons and taggers), phase
13's ``"parallel_world1"``, ``"parallel_cli"`` and ``"parallel_long_clip"``
(K1-K3: the rank processes' counts, each from 0, summed), phase 10(e)'s
``"int8_families"``, phase 14's ``"step_profiler_train"``,
``"step_profiler_eval_bf16"`` and ``"step_profiler_eval_int8"``, and phase
15's ``"accuracy_<script>"``, one a script, and phase 16's ``"graphs"``
(K1, K2, Q1, Q2: the eager walks and the replays, counted from 0).
Q1's and Q2's times are per static int8 forward
at clip_batch 8 (the sum over its 28 / 1 launches), with the dynamic
forward's sums beside them. The last
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
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from fastvideotagging_tpu_torch import Tagger, get_model
from fastvideotagging_tpu_torch.benchmarks import kernel_micro
from fastvideotagging_tpu_torch.benchmarks.int8_serving import int8_convs
from fastvideotagging_tpu_torch.cli import evaluate as cli_evaluate
from fastvideotagging_tpu_torch.cli import serve as cli_serve
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
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_apply, quantize_for
from fastvideotagging_tpu_torch.evaluation.tagger import eval_clip_index, iter_pack_tags
from fastvideotagging_tpu_torch.models import heads
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as fused
from fastvideotagging_tpu_torch.ops import int8_conv as q8
from fastvideotagging_tpu_torch.ops import int8_infer
from fastvideotagging_tpu_torch.ops import temporal_micro as micro
from fastvideotagging_tpu_torch.ops.arch_spec import COVERED_MODELS, spec_for
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
from fastvideotagging_tpu_torch.utils import step_profiler as sprof
from fastvideotagging_tpu_torch.utils.profiling import breakdown

# Published H100 SXM peaks (dense bf16 tensor-core rate, HBM3 bandwidth).
PEAK_BF16_FLOPS = sprof.PEAK_FLOPS["bfloat16"]
PEAK_BYTES_S = sprof.PEAK_BYTES_S

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
    "v2": dict(name="micro_ring_kernel<kV2> (K5)", route="cuda", source=_MICRO_SOURCE,
               replaces="benchmarks/kernel_micro.py:91 (pallas_temporal_v2)"),
    "v3": dict(name="micro_ring_kernel<kV3> (K6)", route="cuda", source=_MICRO_SOURCE,
               replaces="benchmarks/kernel_micro.py:155 (pallas_temporal_v3; its dx "
                        "pallas_temporal_dx_v3 :267)"),
    "dw_v3": dict(name="micro_dw_ring_kernel<kDwV3> (K7, + micro_dw_ring_reduce_kernel)",
                  route="cuda", source=_MICRO_SOURCE,
                  replaces="benchmarks/kernel_micro.py:200 (pallas_temporal_dw_v3)"),
    "v3p": dict(name="micro_ring_kernel<kV3P> (K8, K5's walk)", route="cuda",
                source=_MICRO_SOURCE,
                replaces="benchmarks/kernel_micro.py:241 (pallas_temporal_v3p)"),
    "dw_v2": dict(name="micro_dw_ring_kernel<kDwV2> (K9, + micro_dw_ring_reduce_kernel)",
                  route="cuda", source=_MICRO_SOURCE,
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


def _geometry(kernel: str, k: int = K):
    """(kernel size, strides, pads) of a path site's stride-1, k//2-padded
    conv: K1's 1 x k x k, K2's and K3's k x 1 x 1."""
    p = k // 2
    if kernel == "spatial_conv":
        return (1, k, k), (1, 1, 1), ((0, 0), (p, p), (p, p))
    return (k, 1, 1), (1, 1, 1), ((p, p), (0, 0), (0, 0))


def _min_time(flops: float, nbytes: float):
    sec, by = sprof.least_seconds(sprof.ConvWork(flops, nbytes, 0.0, 0.0), "bfloat16")
    return sec * 1e3, by


def work(kernel: str, x_shape, co: int, k: int = K):
    """(operations, bytes) of one call (``step_profiler.conv_work``): each
    input read once, each output written once, and the operations of the
    taps that fall inside the input (none into its zero padding); K3 writes
    its weight gradient in f32."""
    size, strides, pads = _geometry(kernel, k)
    w = (sprof.conv_work(x_shape, size, strides, pads, co, "bfloat16", "dw", out_dtype="float32")
         if kernel == "temporal_dw" else sprof.conv_work(x_shape, size, strides, pads, co))
    return w.flops, w.nbytes


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


HOST_RESIZE = ((240, 320), (128, 171), 8)  # the host resize's source, ship size, frames


def phase_host_resize(card: str) -> dict:
    """The host data plane's resize (``native.resize_batch_u8``, csrc/
    framepack.c, built here with the system C compiler) against its plain
    numpy version: within one level at 240x320 -> 128x171, equal at a 2x
    upscale (whose taps are exact), both timed on the host."""
    from fastvideotagging_tpu_torch import native
    from fastvideotagging_tpu_torch.data.frames import resize_batch_u8_plain

    (h, w), (oh, ow), t = HOST_RESIZE
    t0 = time.perf_counter()
    lib = _build.build_framepack()
    build_s = time.perf_counter() - t0
    x = np.random.default_rng(SEED).integers(0, 256, size=(t, h, w, 3), dtype=np.uint8)
    times = {}
    for name, fn in (("c", native.resize_batch_u8), ("plain", resize_batch_u8_plain)):
        fn(x[:1], oh, ow)
        t0 = time.perf_counter()
        out = fn(x, oh, ow)
        times[name] = ((time.perf_counter() - t0) * 1e3, out)
    diff = np.abs(times["c"][1].astype(np.int16) - times["plain"][1])
    up = x[:, : h // 2, : w // 2]
    upscale_equal = bool(np.array_equal(native.resize_batch_u8(up, h, w),
                                        resize_batch_u8_plain(up, h, w)))
    res = dict(c_ms=times["c"][0], plain_ms=times["plain"][0], differ=int((diff > 0).sum()),
               values=int(diff.size), max_level=int(diff.max()), upscale_equal=upscale_equal,
               build_s=build_s, library=os.path.basename(lib))
    print(f"host resize (native.resize_batch_u8, {res['library']} built in {build_s:.2f} s): "
          f"{t} frames {h}x{w} -> {oh}x{ow} in {res['c_ms']:.2f} ms, the plain numpy version "
          f"{res['plain_ms']:.2f} ms (host clock); {res['differ']} of {res['values']} values "
          f"differ, by at most {res['max_level']} level; a 2x upscale {h // 2}x{w // 2} -> "
          f"{h}x{w} equal: {upscale_equal} (the host of {card})", flush=True)
    if res["max_level"] > 1 or not upscale_equal:
        raise SystemExit(f"the host resize disagrees with its plain version: {res}")
    return res


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
    return (work("spatial_conv", x_shape, m, k)[0]
            + work("temporal_conv", x_shape[:-1] + (m,), co, k)[0])


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

    def ring_plan(c_in=c, c_out=co):
        p = micro.ring_plan((b, t, s, c_in), c_out, K, micro._sms(x))
        return (f"ring: {p.items} items of {micro.RING_COLS} columns x {p.co_tiles} Co tiles "
                f"of {p.bn} x {p.groups} channel groups of {p.chunks} boxes on {p.blocks} "
                f"blocks, {p.slots} frame slots, "
                + (f"y staged ({p.stage} bytes a warpgroup)" if p.stage else "y from registers")
                + f", {p.smem} bytes of shared memory")

    def dw_ring_plan():
        p = micro.dw_ring_plan((b, t, s, c), co, K, micro._sms(x))
        return (f"dw ring: {p.tiles} tiles ({p.tap_groups} tap groups of {p.taps} x "
                f"{p.c_tiles} C tiles of {p.bn} x {p.co_tiles} Co tiles of "
                f"{micro.DW_RING_M}) x {p.chunks} chunks of {p.cols_per_chunk} of {p.cols} "
                f"items = {p.blocks} blocks, {p.xslots} x / {p.gslots} g frame slots, "
                f"{p.smem} bytes of shared memory; x read {p.co_tiles * p.tap_groups}x, g "
                f"{p.c_tiles * p.tap_groups}x (re-reads from L2), partials "
                f"{p.partial_bytes / 1e6:.2f} MB written and read")

    cases = [("v2 fwd", "v2", lambda: micro.temporal_v2_cuda(x, w, K),
              lambda: micro.temporal_v2_plain(x, w, K), lib_fwd, "fwd", ring_plan())]
    for mt in (448, 224):  # the tile partitions only the plain version's rows
        cases.append((f"v3 fwd tile<={mt}", "v3",
                      lambda mt=mt: micro.temporal_v3_cuda(x, w, K, mt),
                      lambda mt=mt: micro.temporal_v3_plain(x, w, K, mt), lib_fwd, "fwd",
                      ring_plan()))
    cases += [("v3 dx", "v3", lambda: micro.temporal_dx_v3_cuda(g, w, K),
               lambda: micro.temporal_dx_v3_plain(g, w, K),
               lambda: kernel_micro.library_temporal_dx(g, w), "dx", ring_plan(co, c)),
              ("dw v3", "dw_v3", lambda: micro.temporal_dw_v3_cuda(x, g, K),
               lambda: micro.temporal_dw_v3_plain(x, g, K), lib_dw, "dw", dw_ring_plan())]
    for mt in (448, 224):  # the tile partitions only the plain version's rows
        cases.append((f"v3p fwd tile<={mt}", "v3p",
                      lambda mt=mt: micro.temporal_v3p_cuda(x, w, K, mt),
                      lambda mt=mt: micro.temporal_v3p_plain(x, w, K, mt), lib_fwd, "fwd",
                      ring_plan()))
    cases.append(("dw v2", "dw_v2", lambda: micro.temporal_dw_v2_cuda(x, g, K),
                  lambda: micro.temporal_dw_v2_plain(x, g, K), lib_dw, "dw", dw_ring_plan()))
    return cases


def micro_split(run) -> dict | None:
    """A micro design's device time per call by kernel (torch.profiler over
    5 calls): the channel-pad copies (the rings', where C or Co % 8 != 0;
    none at the benchmark's shapes), the main kernel, the reduce of the dw
    or group partials, and anything else (the dx's weight flip)."""
    kernels = traced_kernels_ms(run)
    if kernels is None:
        return None
    split = dict(pad_ms=0.0, main_ms=0.0, reduce_ms=0.0, other_ms=0.0)
    for name, ms in kernels:
        part = ("pad_ms" if "pad_kernel" in name else
                "reduce_ms" if "reduce_kernel" in name else
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
        prod_ms = {name: time_ms(fn, iters=10) for name, fn in prod.items()}
        print(f"{shape:9s} production kernels: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in prod_ms.items()) + f" ({card})", flush=True)
        # K5, K6 and K8 read x once, K2 once per tap (mostly from L2): the
        # shares of the same bound side by side
        ring = []
        for key in ("v2", "v3", "v3p"):
            for site in agg[key]["sites"]:
                if site["shape"] == shape:
                    k2 = prod_ms["K2 dx" if site["role"] == "dx" else "K2 fwd"]
                    site["k2_ms"] = k2
                    ring.append(f"{site['call']} {site['ms']:.4f} ms (share "
                                f"{site['bound_ms'] / site['ms']:.3f}) against K2 {k2:.4f} "
                                f"({site['bound_ms'] / k2:.3f})")
        print(f"{shape:9s} read x once (ring) against once per tap (K2): " + "; ".join(ring),
              flush=True)
        # K9's TMA-fed dw ring against K3 (cp.async slabs) on the same inputs,
        # and K7 (the ring's clipped walk) beside both
        k3 = prod_ms["K3 dw"]
        k9 = next(site for site in agg["dw_v2"]["sites"] if site["shape"] == shape)
        k7 = next(site for site in agg["dw_v3"]["sites"] if site["shape"] == shape)
        k9["k3_ms"] = k7["k3_ms"] = k3
        k7["k9_ms"] = k9["ms"]
        k7["k7_over_k9"] = k7["ms"] / k9["ms"]
        print(f"{shape:9s} dw ring (K9) against K3: K9 {k9['ms']:.4f} ms (share "
              f"{k9['bound_ms'] / k9['ms']:.3f}) against K3 {k3:.4f} ms (share "
              f"{k9['bound_ms'] / k3:.3f}): K9 / K3 = {k9['ms'] / k3:.3f}", flush=True)
        print(f"{shape:9s} clipped dw ring (K7) against K9 and K3: K7 {k7['ms']:.4f} ms (share "
              f"{k7['bound_ms'] / k7['ms']:.3f}), K9 {k9['ms']:.4f}, K3 {k3:.4f}: K7 / K9 = "
              f"{k7['k7_over_k9']:.3f}, K7 / K3 = {k7['ms'] / k3:.3f}", flush=True)
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
    return dict(launches=launches, result=result,
                paths=dict(val=packs["val"], ckpt=ckpt_a, weights=weights))


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


# ---------------------------------------------------------------------------
# Phase 10: int8 serving (Q1, Q2, the int8 engine and its entry points)
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = sprof.PEAK_FLOPS["int8"]  # H100 SXM dense int8 tensor-core rate
_INT8_SOURCE = "fastvideotagging_tpu_torch/csrc/int8_conv.cu"
INT8_KERNELS = {
    "conv3d_s8": dict(
        name="conv3d_s8_hopper_kernel (Q1)", route="cuda", source=_INT8_SOURCE,
        replaces="none: no TPU kernel; the JAX engine's int8 conv is XLA "
                 "(fastvideotagging_tpu/ops/int8_infer.py:112, _conv_i8)"),
    "quantize_s8": dict(
        name="quantize_s8_kernel (+ quantize_amax_kernel where no Q1 call reduced the amax) (Q2)",
        route="cuda", source=_INT8_SOURCE,
        replaces="none: no TPU kernel; the JAX engine's quantize is XLA "
                 "(fastvideotagging_tpu/ops/int8_infer.py:144 _dyn_quant, :543 static)"),
}
# launches of one static r2plus1d_18 int8 forward (stage 4 in bf16): Q1 at
# the stem, 4 convs a block of stages 1-3 and 2 downsamples; Q2 at the input
# site only (every other static quantize is the epilogue of the conv before
# it); the dynamic forward's Q2 at the 2 stem sites and 4 a block (a block's
# input is quantized once), its amax pass at the input site only (every
# other amax is reduced in the epilogue of the conv before it); K1 / K2 at
# stage 4's stride-1 convs
INT8_FORWARD = {"conv3d_s8": 28, "quantize_s8": 1, "quantize_s8_amax": 0}
INT8_DYNAMIC = {"conv3d_s8": 28, "quantize_s8": 26, "quantize_s8_amax": 1}
INT8_FLOAT_K = {"spatial_conv": 3, "temporal_conv": 3}
INT8_CLIP = (16, 112, 112)  # (T, H, W) of the int8 sites' clips


def _int8_counts() -> dict:
    return {**q8.launch_counts, **{k: ops.launch_counts[k] for k in INT8_FLOAT_K}}


def _int8_reset() -> None:
    torch.cuda.synchronize()
    q8.reset_launch_counts()
    ops.reset_launch_counts()


@contextlib.contextmanager
def _int8_plain():
    """Q1 and Q2's plain versions in the kernels' place, on the card."""
    saved = q8.conv3d_s8_cuda, q8.quantize_s8_cuda
    q8.conv3d_s8_cuda, q8.quantize_s8_cuda = q8.conv3d_s8_plain, q8.quantize_s8_plain
    try:
        yield
    finally:
        q8.conv3d_s8_cuda, q8.quantize_s8_cuda = saved


def _record_int8_sites(qpack, x, dynamic: bool = False, spec=None):
    """The Q1 and Q2 calls of one int8 forward, with their counts: {key:
    [n, C]} for Q1 (q shape, kernel, strides, pads, Co, relu, out_f32, the
    residual's kind, the epilogue's extra output: None, 'q' or 'q+bf16' (the
    next site's int8), 'amax' (the next site's dynamic amax); C the input's
    real channels) and {key: n} for Q2 (y shape, dtype, mode: 'static',
    'two passes' or 'amax given')."""
    q1, q2 = {}, {}
    conv, quant = q8.conv3d_s8_cuda, q8.quantize_s8_cuda
    cin = {pack["wk"].data_ptr(): pack["w"].shape[3] for pack in qpack["convs"].values()}

    def rec_conv(q, wk, kernel, mul, add, s, strides, pads, relu, out_f32, residual=None,
                 requant=None, amax=None):
        extra = "amax" if amax is not None else requant and (
            "q+bf16" if requant.keep_bf16 else "q")
        key = (tuple(q.shape), tuple(kernel), tuple(strides), tuple(pads), wk.shape[0],
               bool(relu), bool(out_f32), residual and residual.kind, extra)
        q1.setdefault(key, [0, cin[wk.data_ptr()]])[0] += 1
        return conv(q, wk, kernel, mul, add, s, strides, pads, relu, out_f32, residual, requant,
                    amax)

    def rec_quant(y, inv_f, s=None, amax=None, slot=None):
        mode = "static" if s is not None else "two passes" if amax is None else "amax given"
        key = (tuple(y.shape), str(y.dtype).replace("torch.", ""), mode)
        q2[key] = q2.get(key, 0) + 1
        return quant(y, inv_f, s, amax, slot)

    q8.conv3d_s8_cuda, q8.quantize_s8_cuda = rec_conv, rec_quant
    try:
        if spec is None:
            int8_infer.r2plus1d_int8_infer(qpack, x, dynamic=dynamic)
        else:
            int8_infer.int8_infer(qpack, x, spec, dynamic=dynamic)
    finally:
        q8.conv3d_s8_cuda, q8.quantize_s8_cuda = conv, quant
    return q1, q2


def _int8_form(key) -> str:
    """Q1's epilogue form at a recorded call: (a) bf16 / f32 (+ the next
    site's amax), (b) the next site's int8 (+ bf16), (c) a residual, then
    int8 (+ bf16) or bf16 (+ amax)."""
    res_kind, rq = key[7], key[8]
    out = "bf16+amax" if rq == "amax" else rq or ("f32" if key[6] else "bf16")
    if res_kind is None:
        return f"(a) {out}" if rq in (None, "amax") else f"(b) {out}"
    return f"(c) {res_kind} -> {out}"


def _int8_bound(key, c: int):
    """Q1's least time (ms) and what bounds it: the operations of the taps
    inside the input at the real C at 1,979 TOPS, or at 3.35 TB/s the bytes
    its form moves: the padded int8 input the taps read (a strided 1x1x1
    conv reads an eighth of it) and the int8 weights
    (``step_profiler.conv_work``), the epilogue's vectors, the residual's
    read (the block input's int8 q, or an f32 / bf16 tensor) and the output
    (the next site's padded int8, and bf16 where it is kept; or bf16 / f32,
    and the next site's amax)."""
    qs, kernel, strides, pads, co, _relu, out_f32, res_kind, rq = key
    n, t, h, w, cp = qs
    conv = sprof.conv_work((n, t, h, w, c), kernel, strides, pads, co, "int8", stored_c=cp)
    outs = [q8.out_size(d, k, st, p) for d, k, st, p in zip((t, h, w), kernel, strides, pads)]
    rows = n * outs[0] * outs[1] * outs[2]
    if rq in (None, "amax"):
        out = rows * co * (4 if out_f32 else 2) + (4 if rq else 0)
    else:
        out = rows * q8.padded_channels(co) + (rows * co * 2 if rq == "q+bf16" else 0)
    res = {None: 0, "dequant": rows * q8.padded_channels(co), "f32": rows * co * 4,
           "bf16": rows * co * 2}[res_kind]
    vectors = 4 * co * (2 + (rq is not None) + (res_kind == "dequant"))
    nbytes = conv.x_bytes + conv.w_bytes + vectors + res + out
    t_ops, t_bytes = conv.flops / PEAK_INT8_OPS, nbytes / PEAK_BYTES_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), \
        t_ops * 1e3, t_bytes * 1e3


def _im2col_int_mm(q, wk, kernel, strides, pads):
    """The library column: an explicit im2col of the int8 input, then
    torch._int_mm (cuBLASLt) against the weights, Co padded to 8."""
    kt, kh, kw = kernel
    (tl, th), (hl, hh), (wl, wh) = pads
    xp = torch.nn.functional.pad(q, (0, 0, wl, wh, hl, hh, tl, th))
    cols = xp.unfold(1, kt, strides[0]).unfold(2, kh, strides[1]).unfold(3, kw, strides[2])
    cols = cols.permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(-1, kt * kh * kw * q.shape[-1])
    co = wk.shape[0]
    w2 = torch.nn.functional.pad(wk.reshape(co, -1), (0, 0, 0, -co % 8))
    return torch._int_mm(cols, w2.t())[:, :co]


def _ptxas_q1() -> dict:
    """{(BN, output form, amax): (registers, spill bytes)} of Q1's instances
    from the build report (the form as the kernel's `out`: 0 bf16, 1 f32, 2
    int8; amax: the bf16 instance that reduces the next site's amax)."""
    import re

    out = {}
    report = _build._logs.get("int8_conv", "")
    for part in report.split("Compiling entry function")[1:]:
        m = re.search(r"conv3d_s8_hopper_kernelILi(\d+)ELi(\d+)ELb([01])E", part)
        regs = re.search(r"Used (\d+) registers", part)
        spills = re.search(r"(\d+) bytes spill stores", part)
        if m and regs:
            out[(int(m.group(1)), int(m.group(2)), m.group(3) == "1")] = (
                int(regs.group(1)), int(spills.group(1)) if spills else 0)
    return out


def _int8_inputs(key, c: int, gen: torch.Generator):
    """Seeded inputs of a recorded Q1 call on the card: Q1's arguments (q
    from Q2 on a bf16 activation of C channels) and the bf16 activation and
    the float weights for the bf16 route."""
    dev = torch.device(DEV)
    qs, kernel, strides, pads, co, relu, out_f32, res_kind, rq = key
    y = torch.randn(qs[:-1] + (c,), generator=gen, device=dev).to(torch.bfloat16)
    inv_f = torch.rand(c, generator=gen, device=dev) * 3 + 0.1
    s = torch.tensor(0.03, device=dev)
    q, _ = q8.quantize_s8_cuda(y, inv_f, s)
    w = torch.randint(-127, 128, kernel + (c, co), generator=gen, device=dev, dtype=torch.int8)
    wk = q8.weight_layout(w)
    mul = torch.rand(co, generator=gen, device=dev) * 1e-3
    add = torch.randn(co, generator=gen, device=dev)
    out_shape = q8._out_shape(q, kernel, strides, pads, co)
    residual = None
    if res_kind == "dequant":
        t = torch.randn(out_shape, generator=gen, device=dev).to(torch.bfloat16)
        inv_r = torch.rand(co, generator=gen, device=dev) * 3 + 0.1
        q_in, s_in = q8.quantize_s8_cuda(t, inv_r, torch.tensor(0.04, device=dev))
        residual = q8.Residual("dequant", q_in, inv_r, s_in)
    elif res_kind == "f32":
        residual = q8.Residual("f32", torch.randn(out_shape, generator=gen, device=dev) * 4)
    elif res_kind == "bf16":
        residual = q8.Residual("bf16", torch.randn(out_shape, generator=gen,
                                                   device=dev).to(torch.bfloat16))
    next_inv_f = torch.rand(co, generator=gen, device=dev) * 3 + 0.1
    requant = None if rq in (None, "amax") else q8.Requant(
        next_inv_f, torch.tensor(0.06, device=dev), rq == "q+bf16")
    amax = q8.Amax(next_inv_f) if rq == "amax" else None
    args = (q, wk, kernel, mul, add, s, strides, pads, relu, out_f32, residual, requant, amax)
    return args, y, w


def _int8_unfused(args, slot=None):
    """The chain of kernels a fused form replaces: Q1 in form (a) (f32 and
    no ReLU before a residual), the block tail's torch ops, Q2 (for the
    next site's amax, its amax pass into ``slot``, a new one by default)."""
    q, wk, kernel, mul, add, s, strides, pads, relu, out_f32, residual, requant, amax = args
    if residual is None:
        y = q8.conv3d_s8_cuda(q, wk, kernel, mul, add, s, strides, pads, relu,
                              out_f32 and requant is None)
    else:
        zf = q8.conv3d_s8_cuda(q, wk, kernel, mul, add, s, strides, pads, False, True)
        y = q8.residual_tail(zf, residual, relu)
    if amax is not None:
        slot = q8.ScaleSlots(1, y.device).take() if slot is None else slot
        q8.quantize_s8_cuda(y, amax.inv_f, None, None, slot)
        return y, slot[0]
    if requant is None:
        return y
    qn, sn = q8.quantize_s8_cuda(y, requant.inv_f, requant.s)
    return qn, sn, y if requant.keep_bf16 else None


def _ms_or_none(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


def _int8_outputs(out) -> list:
    """The tensors a Q1 call returns: y; (y, amax); or (q, s, y or None)."""
    if torch.is_tensor(out):
        return [out]
    return list(out) if len(out) == 2 else [t for t in (out[0], out[2]) if t is not None]


def phase_int8_kernels(card: str, qpack, batch: int, gen: torch.Generator) -> dict:
    """10(a, b) at one batch: every Q1 call of a static forward in its
    epilogue form, against its plain version and the unfused chain of
    kernels, timed; every Q1 call of a dynamic forward that reduces the next
    site's amax, its bf16 output and amax bit for bit against its plain
    version and the unfused chains, timed with and without the amax; Q2 at
    the dynamic forward's sites in their mode (the quantize pass from the
    reduced amax, both passes at the input site; the static forward runs it
    at the input site only): the wrapper's time, the device's, the bare C
    launch's and the host's, beside the bound of one read of y and the int8
    write."""
    dev = torch.device(DEV)
    x = torch.randn((batch, *INT8_CLIP, 3), generator=gen, device=dev).to(torch.bfloat16)
    q1_sites, q2_sites = _record_int8_sites(qpack, x)
    q1_dynamic, q2_dynamic = _record_int8_sites(qpack, x, dynamic=True)
    del x
    regs = _ptxas_q1()
    rows, agg = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bf16_ms=0.0, bound_ms=0.0,
                         ops_ms=0.0, bytes_ms=0.0, chain_ms=0.0, max_abs_err=0.0, max_ulps=0.0)
    for key, (count, c) in q1_sites.items():
        qs, kernel, strides, pads, co, relu, out_f32, res_kind, rq = key
        form = _int8_form(key)
        args, y, w = _int8_inputs(key, c, gen)
        q, wk = args[0], args[1]
        one, zero = torch.ones(co, device=dev), torch.zeros(co, device=dev)
        unit = torch.tensor(1.0, device=dev)
        ident = q8.conv3d_s8_cuda(q, wk, kernel, one, zero, unit, strides, pads, False, True)
        ident_ref = q8.conv3d_s8_plain(q, wk, kernel, one, zero, unit, strides, pads, False, True)
        bitwise = torch.equal(ident, ident_ref)
        got, ref = _int8_outputs(q8.conv3d_s8_cuda(*args)), _int8_outputs(q8.conv3d_s8_plain(*args))
        chain = _int8_outputs(_int8_unfused(args))
        form_bitwise = all(torch.equal(a, b) for a, b in zip(got, ref))
        chain_equal = all(torch.equal(a, b) for a, b in zip(got, chain))
        diff = (got[0].float() - ref[0].float()).abs()
        _, e = torch.frexp(ref[0].float())
        ulps = 0.0 if rq else (diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()
        lib = _im2col_int_mm(q, wk, kernel, strides, pads)
        lib_ok = torch.equal(lib.float().reshape(ident.shape), ident)
        ms = time_ms(lambda: q8.conv3d_s8_cuda(*args), iters=20)
        fused = res_kind is not None or rq is not None
        chain_ms = time_ms(lambda: _int8_unfused(args), iters=20) if fused else ms
        plain_ms = time_ms(lambda: q8.conv3d_s8_plain(*args), iters=2, warmup=1)
        lib_ms = time_ms(lambda: _im2col_int_mm(q, wk, kernel, strides, pads), iters=5, warmup=1)
        xb = y.contiguous()
        wb = w.float() * 0.01
        bf16_ms = time_ms(lambda: int8_infer._bf16_conv(xb, wb, strides, pads), iters=20)
        bound_ms, bound_by, t_ops, t_bytes = _int8_bound(key, c)
        out0 = got[0]
        plan = q8.conv_s8_plan(out0[..., 0].numel(), co, kernel[0] * kernel[1] * kernel[2],
                               qs[-1], out0.element_size(), out0.shape[-1] * out0.element_size())
        reg, spill = regs.get((plan.bn, q8._OUT[out0.dtype], False), (None, None))
        row = dict(x=list(qs[:-1]) + [c], cp=qs[-1], kernel=list(kernel), strides=list(strides),
                   co=co, relu=relu, out_f32=out_f32, form=form, per_forward=count, ms=ms,
                   unfused_chain_ms=chain_ms, plain_ms=plain_ms, library_ms=lib_ms,
                   bf16_route_ms=bf16_ms, bound_ms=bound_ms, bound_by=bound_by,
                   identity_bitwise=bitwise, form_bitwise=form_bitwise,
                   unfused_chain_equal=chain_equal, real_max_abs_err=diff.max().item(),
                   real_max_ulps=ulps, int_mm_equal=lib_ok,
                   plan=dict(bn=plan.bn, stages=plan.stages, staged=plan.staged,
                             grid=plan.grid, tiles=plan.tiles, slices=plan.slices,
                             smem=plan.smem_bytes),
                   registers=reg, spill_bytes=spill)
        rows.append(row)
        print(f"(a) Q1 B={batch} x{tuple(row['x'])} cp={qs[-1]} k{kernel} s{strides} -> {co} "
              f"{form} (x{count} a forward): {ms:.4f} ms, {bound_ms / ms:.3f} of the bound "
              f"{bound_ms:.4f} ({bound_by}); unfused chain {chain_ms:.4f} (equal "
              f"{chain_equal}); plain {plain_ms:.3f}, im2col+_int_mm {lib_ms:.4f} (equal "
              f"{lib_ok}), bf16 route {bf16_ms:.4f}; identity bitwise {bitwise}, form bitwise "
              f"{form_bitwise}, max err {row['real_max_abs_err']:.3e} ({ulps:.2f} bf16 ulp); "
              f"plan BN {plan.bn} stages {plan.stages} staged {plan.staged} grid {plan.grid} "
              f"tiles {plan.tiles} slices {plan.slices} smem "
              f"{plan.smem_bytes}; ptxas {reg} "
              f"registers, {spill} bytes spilled", flush=True)
        if not (bitwise and chain_equal and (form_bitwise if fused else ulps <= 1.0)):
            raise SystemExit(f"(a) Q1 disagrees with its plain version or the unfused chain "
                             f"at {key}")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                     ("bf16_ms", bf16_ms), ("bound_ms", bound_ms), ("ops_ms", t_ops),
                     ("bytes_ms", t_bytes), ("chain_ms", chain_ms)):
            agg[k] += count * v
        agg["max_abs_err"] = max(agg["max_abs_err"], row["real_max_abs_err"])
        agg["max_ulps"] = max(agg["max_ulps"], ulps)
        del args, got, ref, chain, ident, ident_ref, lib, xb, y, q, wk
        torch.cuda.empty_cache()

    dyn_rows, dyn = [], dict(ms=0.0, no_amax_ms=0.0, device_ms=0.0, device_no_amax_ms=0.0,
                             chain_ms=0.0, bound_ms=0.0, calls=0)
    for key, (count, c) in q1_dynamic.items():
        if key[8] != "amax":  # the dynamic forward's other Q1 calls are forms the static one has
            continue
        form = _int8_form(key)
        args, _, _ = _int8_inputs(key, c, gen)
        bare = args[:12] + (None,)
        got, ref, chain = q8.conv3d_s8_cuda(*args), q8.conv3d_s8_plain(*args), _int8_unfused(args)
        # the unfused chain the issue names: the same call's bf16 store, then Q2's amax pass
        stored, slot = q8.conv3d_s8_cuda(*bare), q8.ScaleSlots(1, dev).take()
        q8.quantize_s8_cuda(stored, args[12].inv_f, None, None, slot)
        y_equal = all(torch.equal(got[0], t) for t in (ref[0], chain[0], stored))
        amax_equal = all(torch.equal(got[1], t) for t in (ref[1], chain[1], slot[0]))
        timed = args[:12] + (args[12]._replace(out=torch.zeros((), device=dev)),)
        ms = time_ms(lambda: q8.conv3d_s8_cuda(*timed), iters=20)
        no_amax_ms = time_ms(lambda: q8.conv3d_s8_cuda(*bare), iters=20)
        chain_ms = time_ms(lambda: _int8_unfused(args, slot), iters=20)
        # the device's time a call (the wrapper's host work left out)
        device = [traced_kernels_ms(lambda: q8.conv3d_s8_cuda(*a)) for a in (timed, bare)]
        device = [None if d is None else sum(v for n, v in d if "conv3d_s8" in n) for d in device]
        bound_ms, bound_by, _, _ = _int8_bound(key, c)
        plan = q8.conv_s8_plan(got[0][..., 0].numel(), key[4], key[1][0] * key[1][1] * key[1][2],
                               key[0][-1], 2, 2 * key[4])
        reg, spill = regs.get((plan.bn, 0, True), (None, None))
        row = dict(x=list(key[0][:-1]) + [c], kernel=list(key[1]), strides=list(key[2]),
                   co=key[4], form=form, per_forward=count, ms=ms, no_amax_ms=no_amax_ms,
                   amax_cost=ms / no_amax_ms - 1.0, device_ms=device[0],
                   device_no_amax_ms=device[1], unfused_chain_ms=chain_ms, bound_ms=bound_ms,
                   bound_by=bound_by, y_bitwise=y_equal, amax_bitwise=amax_equal,
                   amax=got[1].item(), bn=plan.bn, registers=reg, spill_bytes=spill)
        dyn_rows.append(row)
        print(f"(a) Q1 dynamic B={batch} x{tuple(row['x'])} k{key[1]} s{key[2]} -> {key[4]} "
              f"{form} (x{count} a forward): {ms:.4f} ms with the amax, {no_amax_ms:.4f} "
              f"without ({row['amax_cost'] * 100:+.1f} %; device {_ms_or_none(device[0])} / "
              f"{_ms_or_none(device[1])}), {bound_ms / ms:.3f} of the bound "
              f"{bound_ms:.4f} ({bound_by}); the parent's unfused chain (Q1, tail, Q2's amax "
              f"pass) {chain_ms:.4f}; y bitwise {y_equal}, amax {row['amax']:.6g} bitwise "
              f"against the plain version, the unfused chain and the bf16 store + amax pass "
              f"{amax_equal}; BN {plan.bn}, ptxas {reg} registers, {spill} bytes spilled",
              flush=True)
        if not (y_equal and amax_equal):
            raise SystemExit(f"(a) Q1's amax disagrees with its plain version or the unfused "
                             f"chain at {key}")
        for k, v in (("ms", ms), ("no_amax_ms", no_amax_ms), ("chain_ms", chain_ms),
                     ("bound_ms", bound_ms), ("calls", 1), ("device_ms", device[0]),
                     ("device_no_amax_ms", device[1])):
            dyn[k] = None if v is None or dyn[k] is None else dyn[k] + count * v
        del args, got, ref, chain, stored, timed
        torch.cuda.empty_cache()

    q2_rows = []
    q2_agg = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, dyn_ms=0.0, dyn_device_ms=0.0,
                  dyn_bare_ms=0.0, dyn_host_ms=0.0, dyn_plain_ms=0.0, dyn_bound_ms=0.0,
                  two_pass_ms=0.0, device_measured=True)
    lib = q8._kernels()
    for (ys, dtype, mode), count in q2_dynamic.items():
        static_count = sum(n for (zs, zt, _), n in q2_sites.items() if (zs, zt) == (ys, dtype))
        y = torch.randn(ys, generator=gen, device=dev) * 2
        if mode == "amax given":  # a ReLU's output, as at every site but the input
            y = torch.relu(y)
        y = y.to(getattr(torch, dtype))
        inv_f = torch.rand(ys[-1], generator=gen, device=dev) * 3 + 0.1
        s = torch.tensor(0.05, device=dev)
        slots = q8.ScaleSlots(2, dev)
        two, given = slots.take(), slots.take()
        a, b = q8.quantize_s8_cuda(y, inv_f, s), q8.quantize_s8_plain(y, inv_f, s)
        d, e = q8.quantize_s8_cuda(y, inv_f, None, None, two), q8.quantize_s8_plain(y, inv_f)
        given[0].copy_((y.float() * inv_f).abs().amax())
        g = q8.quantize_s8_cuda(y, inv_f, None, given[0], given)
        h = q8.quantize_s8_plain(y, inv_f, None, given[0])
        ok = (torch.equal(a[0], b[0]) and torch.equal(d[0], e[0]) and torch.equal(d[1], e[1])
              and torch.equal(two[0], given[0]) and all(
                  torch.equal(g[i], t[i]) for t in (h, d) for i in (0, 1)))
        # the site's mode in the dynamic forward: the quantize pass from the
        # amax a Q1 epilogue reduced, or both passes (the input site)
        if mode == "amax given":
            def run():
                return q8.quantize_s8_cuda(y, inv_f, None, given[0], given)
            plain = (lambda: q8.quantize_s8_plain(y, inv_f, None, given[0]))  # noqa: E731
            slot, c_mode = given, 2
        else:
            def run():
                return q8.quantize_s8_cuda(y, inv_f, None, None, two)
            plain = (lambda: q8.quantize_s8_plain(y, inv_f))  # noqa: E731
            slot, c_mode = two, 1
        qb = torch.empty_like(g[0])
        stream = torch.cuda.current_stream(dev).cuda_stream
        bare_args = (y.data_ptr(), int(dtype == "float32"), inv_f.data_ptr(), None,
                     slot[0].data_ptr(), slot[1].data_ptr(), qb.data_ptr(),
                     y.numel() // ys[-1], ys[-1], qb.shape[-1], c_mode, y.device.index, stream)

        def bare():
            return lib.fvt_quantize_s8(*bare_args)
        dyn_ms = time_ms(run, iters=20)  # the wrapper, CUDA events over 20 calls back to back
        bare_ms = time_ms(bare, iters=20)  # the C entry point alone, the same way
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            run()
        host_ms = (time.perf_counter() - t0) / 50 * 1e3  # the wrapper's host time a call
        torch.cuda.synchronize()
        split = traced_kernels_ms(run)
        device_ms = None if split is None else sum(v for n, v in split if "quantize" in n)
        two_ms = time_ms(lambda: q8.quantize_s8_cuda(y, inv_f, None, None, two), iters=20)
        ms = time_ms(lambda: q8.quantize_s8_cuda(y, inv_f, s), iters=20)
        plain_ms = time_ms(lambda: q8.quantize_s8_plain(y, inv_f, s), iters=5)
        dyn_plain_ms = time_ms(plain, iters=5)
        nbytes = y.numel() * y.element_size() + a[0].numel() + 4 * ys[-1]
        bound_ms = nbytes / PEAK_BYTES_S * 1e3
        q2_rows.append(dict(y=list(ys), dtype=dtype, mode=mode, per_static_forward=static_count,
                            per_dynamic_forward=count, ms=ms, plain_ms=plain_ms,
                            dynamic_ms=dyn_ms, dynamic_device_ms=device_ms,
                            dynamic_bare_launch_ms=bare_ms, dynamic_host_ms=host_ms,
                            dynamic_plain_ms=dyn_plain_ms, two_passes_ms=two_ms,
                            bound_ms=bound_ms, bitwise=ok))
        device = "not measured" if device_ms is None else f"{device_ms:.4f}"
        print(f"(b) Q2 B={batch} y{ys} {dtype} (x{static_count} static, x{count} dynamic a "
              f"forward, {mode}): {dyn_ms:.4f} ms a wrapper call (device {device}, the bare "
              f"C launch {bare_ms:.4f}, the wrapper's host time {host_ms:.4f}), "
              f"{bound_ms / dyn_ms:.3f} of the bound {bound_ms:.4f} (one read of y and the int8 "
              f"write); both passes {two_ms:.4f}; static {ms:.4f}; plain {plain_ms:.4f} static, "
              f"{dyn_plain_ms:.4f} {mode}; bitwise in the three modes {ok}", flush=True)
        if not ok:
            raise SystemExit(f"(b) Q2 disagrees with its plain version at {ys}")
        for k, v, n in (("ms", ms, static_count), ("plain_ms", plain_ms, static_count),
                        ("bound_ms", bound_ms, static_count), ("dyn_ms", dyn_ms, count),
                        ("dyn_bare_ms", bare_ms, count), ("dyn_host_ms", host_ms, count),
                        ("dyn_plain_ms", dyn_plain_ms, count), ("dyn_bound_ms", bound_ms, count),
                        ("two_pass_ms", two_ms, count)):
            q2_agg[k] += n * v
        if device_ms is None:
            q2_agg["device_measured"] = False
        else:
            q2_agg["dyn_device_ms"] += count * device_ms
        del y, a, b, d, e, g, h, qb
    print(f"(a, b) B={batch}, sums over one static forward's launches: Q1 {agg['ms']:.4f} ms "
          f"({agg['bound_ms'] / agg['ms']:.3f} of its bound {agg['bound_ms']:.4f}; the unfused "
          f"chains of kernels it replaces {agg['chain_ms']:.4f}, plain {agg['plain_ms']:.2f}, "
          f"im2col+_int_mm {agg['library_ms']:.4f}, bf16 route {agg['bf16_ms']:.4f}); Q2 "
          f"{q2_agg['ms']:.4f} ms static on {card}", flush=True)
    device_sum = (f"{q2_agg['dyn_device_ms']:.4f}" if q2_agg["device_measured"]
                  else "not measured")
    print(f"(a, b) B={batch}, sums over one dynamic forward's launches: Q1's {dyn['calls']} "
          f"calls with the amax {dyn['ms']:.4f} ms, the same calls without it "
          f"{dyn['no_amax_ms']:.4f} ({(dyn['ms'] / dyn['no_amax_ms'] - 1) * 100:+.1f} %; device "
          f"{_ms_or_none(dyn['device_ms'])} / {_ms_or_none(dyn['device_no_amax_ms'])}), the "
          f"parent's unfused chains {dyn['chain_ms']:.4f}; Q2 {q2_agg['dyn_ms']:.4f} ms (device "
          f"{device_sum}, bare C launches {q2_agg['dyn_bare_ms']:.4f}, wrapper host "
          f"{q2_agg['dyn_host_ms']:.4f}), {q2_agg['dyn_bound_ms'] / q2_agg['dyn_ms']:.3f} of "
          f"its bound {q2_agg['dyn_bound_ms']:.4f}; both passes at every site (the parent's "
          f"design) {q2_agg['two_pass_ms']:.4f} on {card}", flush=True)
    return dict(q1=agg, q1_sites=rows, q1_dynamic=dyn, q1_dynamic_sites=dyn_rows, q2=q2_agg,
                q2_sites=q2_rows, q1_launches=sum(n for n, _ in q1_sites.values()),
                q1_dynamic_amax=sum(n for k, (n, _) in q1_dynamic.items() if k[8] == "amax"),
                q2_launches=sum(q2_sites.values()),
                q2_dynamic_launches=sum(q2_dynamic.values()),
                q2_dynamic_two_pass=sum(n for k, n in q2_dynamic.items() if k[2] == "two passes"))


def phase_int8_tagger(card: str) -> dict:
    """10(c): Tagger(int8=True) on phase 4's video and the engine's
    throughput against bf16 'cuda'."""
    g = torch.Generator().manual_seed(SEED)
    state = get_model("r2plus1d_18", num_classes=400, device="cpu", generator=g).state_dict()
    frames = make_frames(3, num_frames=160, height=128, width=171, seed=SEED)

    def read_frames(idx):
        return frames[idx]

    tagger = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, int8=True, device=DEV)
    clip_idx = eval_clip_index(len(frames), tagger.sampler_cfg)
    chunks = -(-clip_idx.shape[0] // CLIP_BATCH)
    bf16 = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, device=DEV)
    tagger.scores_from(read_frames, len(frames))  # warm-up
    _int8_reset()
    scores = tagger.scores_from(read_frames, len(frames))
    torch.cuda.synchronize()
    launches = _int8_counts()
    want = {k: v * chunks for k, v in INT8_FORWARD.items()}
    want_k = {k: n * chunks for k, n in INT8_FLOAT_K.items()}
    print(f"(c) Tagger(int8=True): launches over {chunks} chunks {launches} (Q1 / Q2 / amax "
          f"{want}; K1 / K2 {want_k}: stage 4's a chunk; the calibration walk's convs are f32 "
          f"cuDNN)", flush=True)
    if launches != {**want, **want_k}:
        raise SystemExit(f"(c) launch counts {launches} != {want} {want_k}")
    if scores.shape != (tagger.num_classes,) or not np.isfinite(scores).all():
        raise SystemExit("(c) the int8 scores are not finite or of the wrong shape")
    with _int8_plain():  # a new Tagger: the first's graph replays the kernels it captured
        plain = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, int8=True,
                       device=DEV).scores_from(read_frames, len(frames))
    ref = bf16.scores_from(read_frames, len(frames))
    err = float(np.abs(scores - plain).max())
    print(f"(c) int8 scores vs the same engine with Q1 / Q2's plain versions on the card: max abs "
          f"diff {err:.3e} (tol {PATH_TOL}); vs bf16 'cuda' {np.abs(scores - ref).max():.3e} (a "
          f"figure: random weights); top-5 int8 {np.argsort(-scores)[:5].tolist()} bf16 "
          f"{np.argsort(-ref)[:5].tolist()}", flush=True)
    if err > PATH_TOL:
        raise SystemExit("(c) the int8 engine disagrees with its plain versions")

    # the per-video calibration apart from the forward, and clips/s
    d = tagger.cfg.data
    first = torch.from_numpy(frames[clip_idx[:CLIP_BATCH]]).to(DEV)
    clips = preprocess_eval_clip(first, d.resize_hw,
                                 d.crop_hw, d.mean, d.std, out_dtype=torch.bfloat16)
    calib = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        qpack = quantize_for("r2plus1d_18", tagger._weights, [clips], w_cols=tagger._w_cols)
        torch.cuda.synchronize()
        calib.append((time.perf_counter() - t0) * 1e3)
    w_cols_ms = time_ms(lambda: int8_infer.consumer_absmax(spec_for("r2plus1d_18"),
                                                          tagger._weights), iters=1, warmup=0)
    rates = {}
    for b in (CLIP_BATCH, TRAIN_BATCH):
        x = torch.randn((b, *INT8_CLIP, 3), generator=torch.Generator(device=DEV).manual_seed(b),
                        device=DEV).to(torch.bfloat16)
        with torch.inference_mode():
            runs = {
                "bf16_cuda": lambda: bf16.model(x),
                "int8_static": lambda: int8_infer.r2plus1d_int8_infer(qpack, x),
                "int8_dynamic": lambda: int8_infer.r2plus1d_int8_infer(qpack, x, dynamic=True),
                "int8_exact_residual": lambda: int8_infer.r2plus1d_int8_infer(
                    qpack, x, residual="exact"),
            }
            for name, fn in runs.items():
                ms = time_ms(fn, iters=10)
                rates[f"{name}_b{b}"] = dict(ms=ms, clips_per_s=b / ms * 1e3)
            for mode, want_f in (("static", INT8_FORWARD), ("dynamic", INT8_DYNAMIC)):
                _int8_reset()
                int8_infer.r2plus1d_int8_infer(qpack, x, dynamic=mode == "dynamic")
                torch.cuda.synchronize()
                got_f = dict(q8.launch_counts)
                rates[f"int8_{mode}_b{b}"]["launches"] = got_f
                if got_f != want_f:
                    raise SystemExit(f"(c) a {mode} forward at B={b} launched {got_f}, not "
                                     f"{want_f}")
        del x
        torch.cuda.empty_cache()
        print(f"(c) B={b}: " + "; ".join(
            f"{k} {rates[f'{k}_b{b}']['ms']:.3f} ms = {rates[f'{k}_b{b}']['clips_per_s']:.1f} "
            f"clips/s" for k in runs) + f" (CUDA events, 10 forwards) on {card}; launches a "
              f"forward: static {rates[f'int8_static_b{b}']['launches']}, dynamic "
              f"{rates[f'int8_dynamic_b{b}']['launches']}", flush=True)
    print(f"(c) per-video calibration (calibrate + quantize_variables on one chunk of "
          f"{CLIP_BATCH} clips): {[round(c, 3) for c in calib]} ms; the consumer absmax, taken "
          f"once per Tagger: {w_cols_ms:.3f} ms", flush=True)
    return dict(launches=launches, score_err=err, calibration_ms=calib,
                consumer_absmax_ms=w_cols_ms, rates=rates, qpack=qpack)


def phase_int8_entry_points(card: str, paths: dict) -> dict:
    """10(d): cli.tag --int8, cli.evaluate --int8 and cli.serve on phase
    7/8's val pack, each run's launches counted from 0."""
    cfg = PRESETS["r2plus1d18_ucf101"]
    launches = {}
    argv = [paths["val"], "--preset", "r2plus1d18_ucf101", "--weights", paths["weights"],
            "--threshold", "0.0", "--top-k", "5", "--int8"]
    _int8_reset()
    (_, printed) = _quiet(cli_tag.main, argv)
    launches["cli_tag_int8"] = _int8_counts()
    tagger = Tagger(cfg, load_weights(paths["weights"]), int8=True, device=DEV)
    direct = [json.dumps({"video": path, "tags": [{"tag": r.tag, "score": round(r.score, 5)}
                                                  for r in results]})
              for path, results in iter_pack_tags(tagger, paths["val"], threshold=0.0, top_k=5)]
    lines = printed.strip().splitlines()
    print(f"(d) cli.tag --int8: {len(lines)} lines, launches {launches['cli_tag_int8']}; equal to "
          f"iter_pack_tags(Tagger(int8=True)): {lines == direct}; the first {lines[0]}", flush=True)
    if lines != direct or launches["cli_tag_int8"]["conv3d_s8"] != 28 * len(lines):
        raise SystemExit("(d) cli.tag --int8 differs from its library call or its launches")

    argv = ["--preset", "r2plus1d18_ucf101", "--val-list", paths["val"], "--checkpoint-dir",
            paths["ckpt"], "--int8"]
    _int8_reset()
    out, printed = _quiet(cli_evaluate.main, argv)
    launches["cli_evaluate_int8"] = _int8_counts()
    sd, _ = CheckpointManager(paths["ckpt"]).restore_weights()
    sd = {k: v.to(DEV) for k, v in sd.items()}
    ds = open_dataset(paths["val"], cfg.data, mode="eval")
    d = cfg.data
    calib = [preprocess_eval_clip(torch.from_numpy(ds.get_eval_clips(i)[0]).to(DEV),
                                  d.resize_hw, d.crop_hw, d.mean, d.std, out_dtype=torch.bfloat16)
             for i in range(min(8, len(ds)))]
    qpack, apply_fn = make_int8_apply(cfg.model.name, sd, calib, multilabel=cfg.model.multilabel)
    direct = evaluation.evaluate(model_from_config(cfg.model, device=DEV), qpack, ds, cfg,
                                 apply_fn=apply_fn)
    same = json.loads(printed.strip().splitlines()[-1]) == direct == out
    print(f"(d) cli.evaluate --int8: {printed.strip()}, launches "
          f"{launches['cli_evaluate_int8']}; equal to evaluate(apply_fn=make_int8_apply(...)): "
          f"{same}", flush=True)
    if not same or launches["cli_evaluate_int8"]["conv3d_s8"] == 0:
        raise SystemExit("(d) cli.evaluate --int8 differs from evaluate() or ran no Q1")

    missing = os.path.join(os.path.dirname(paths["val"]), "missing.fvtpack")
    requests = (f"{paths['val']}\n"
                + json.dumps({"video": paths["val"], "top_k": 2}) + "\n"
                + f"{missing}\n")
    served = {}
    for flag in ("--int8", None):
        run = "serve_int8" if flag else "serve_bf16"
        stdin = sys.stdin
        sys.stdin = io.StringIO(requests)
        err = io.StringIO()
        _int8_reset()
        try:
            with contextlib.redirect_stderr(err):
                stats, printed = _quiet(cli_serve.main, [
                    "--preset", "r2plus1d18_ucf101", "--weights", paths["weights"],
                    "--threshold", "0.0"] + ([flag] if flag else []))
        finally:
            sys.stdin = stdin
        launches[run] = _int8_counts()
        resp = [json.loads(line) for line in printed.strip().splitlines()]
        n = len(lines)  # the val pack's videos
        good = (stats == {"served": 2, "errors": 1} and len(resp) == 2 * n + 1
                and "error" in resp[-1] and all(len(r["tags"]) == 2 for r in resp[n:2 * n])
                and "ready" in err.getvalue())
        served[run] = dict(stats=stats, lines=len(resp), error=resp[-1].get("error"))
        print(f"(d) cli.serve {flag or '(bf16)'}: {stats}, {len(resp)} lines, the last "
              f"{json.dumps(resp[-1])}; launches {launches[run]}", flush=True)
        if not good or (flag and launches[run]["conv3d_s8"] != 28 * 2 * n):
            raise SystemExit(f"(d) cli.serve {flag or ''} did not answer as it should")
    return dict(launches=launches, evaluate=out, tag_lines=len(lines), serve=served)


def phase_int8(card: str, paths: dict) -> dict:
    print("== phase 10: int8 serving", flush=True)
    t_phase = time.perf_counter()
    tag = phase_int8_tagger(card)
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    kernels = {b: phase_int8_kernels(card, tag["qpack"], b, gen) for b in (CLIP_BATCH, TRAIN_BATCH)}
    for b, k in kernels.items():
        calls = (k["q1_launches"], k["q2_launches"], k["q2_dynamic_launches"],
                 k["q2_dynamic_two_pass"], k["q1_dynamic_amax"])
        if calls != (28, 1, 26, 1, 25):
            raise SystemExit(f"B={b}: a forward made {calls} Q1 / Q2 / dynamic Q2 calls / "
                             f"dynamic amax passes / dynamic Q1 amaxes, not 28 / 1 / 26 / 1 / 25")
    entry = phase_int8_entry_points(card, paths)
    launches = {"tagger_int8": tag["launches"], **entry["launches"]}
    print(f"phase 10 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    del tag["qpack"]
    return dict(launches=launches, tagger=tag, kernels=kernels, entry=entry)


# ---------------------------------------------------------------------------
# Phase 10(e): every other covered family in int8
# ---------------------------------------------------------------------------

# the serving clip (T, H, W) of each covered name: phase 9's, and 16x112x112
# for the R(2+1)D family; the frames the taggers read (the presets' resize)
INT8_FAMILY_CLIPS = {**{n: (16, 112, 112) for n in ("r2plus1d_18_tpu", "r2plus1d_34",
                                                    "r2plus1d_34_tpu")}, **ZOO_CLIPS}
INT8_FAMILY_HW = {112: (128, 171), 224: (256, 342)}
Q1_FAMILY_ITERS = 5  # CUDA-event-timed launches of Q1 at each new site geometry


def _family_cfg(name: str, clip) -> ExperimentConfig:
    t, h, w = clip
    return ExperimentConfig(
        model=ModelConfig(name=name, num_classes=ZOO_CLASSES, multilabel=True),
        data=DataConfig(resize_hw=INT8_FAMILY_HW[h], crop_hw=(h, w),
                        sampler=ClipSamplerConfig(clip_len=t, eval_mode="dense")))


def _unit_logits(model, spec, x) -> None:
    """Scale the head (its last Dense, kernel and bias) of ``model`` so that
    its bf16 logits on ``x`` have unit standard deviation, as a trained
    head's are of the order of one: at their seeded init the deep families'
    logits reach 1e3-1e4, where the sigmoid of any rounding saturates."""
    from fastvideotagging_tpu_torch.ops.arch_spec import param

    with torch.inference_mode():
        std = model(x).float().std().item()
    sd = model.state_dict()
    with torch.no_grad():
        for leaf in ("kernel", "bias"):
            param(sd, spec.head[-1].param + (leaf,)).div_(std)


def _q1_site_check(key, c: int, gen: torch.Generator) -> dict:
    """Q1 at one recorded call: the identity epilogue bitwise against its
    plain version, the call's form bitwise (fused) or within one bf16 ulp,
    two launches bitwise equal, its time against the bound."""
    dev = torch.device(DEV)
    qs, kernel, strides, pads, co, *_ = key
    rq, fused = key[8], key[7] is not None or key[8] not in (None, "amax")
    args, _, _ = _int8_inputs(key, c, gen)
    q, wk = args[0], args[1]
    one, zero = torch.ones(co, device=dev), torch.zeros(co, device=dev)
    unit = torch.tensor(1.0, device=dev)
    ident = torch.equal(q8.conv3d_s8_cuda(q, wk, kernel, one, zero, unit, strides, pads, False,
                                          True),
                        q8.conv3d_s8_plain(q, wk, kernel, one, zero, unit, strides, pads, False,
                                           True))
    got = _int8_outputs(q8.conv3d_s8_cuda(*args))
    again = _int8_outputs(q8.conv3d_s8_cuda(*args))
    ref = _int8_outputs(q8.conv3d_s8_plain(*args))
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    form = all(torch.equal(a, b) for a, b in zip(got, ref))
    diff = (got[0].float() - ref[0].float()).abs()
    _, e = torch.frexp(ref[0].float())
    ulps = 0.0 if rq not in (None, "amax") else (
        diff / torch.ldexp(torch.ones_like(diff), e - 8)).max().item()
    ms = time_ms(lambda: q8.conv3d_s8_cuda(*args), iters=Q1_FAMILY_ITERS)
    bound_ms, by, _, _ = _int8_bound(key, c)
    ok = ident and repeat and (form if fused else ulps <= 1.0)
    return dict(x=list(qs[:-1]) + [c], cp=qs[-1], kernel=list(kernel), strides=list(strides),
                pads=[list(p) for p in pads], co=co, form=_int8_form(key), ms=ms,
                bound_ms=bound_ms, bound_by=by, share=bound_ms / ms, identity_bitwise=ident,
                two_launches_bitwise=repeat, form_bitwise=form, max_bf16_ulps=ulps, ok=ok)


def _q2_site_check(key, gen: torch.Generator) -> dict:
    """Q2 at one recorded (y shape, dtype, mode) against its plain version,
    bit for bit (the amax-given mode on the amax the plain pass reduces)."""
    dev = torch.device(DEV)
    ys, dtype, mode = key
    y = (torch.randn(ys, generator=gen, device=dev) * 3).to(getattr(torch, dtype))
    inv_f = torch.rand(ys[-1], generator=gen, device=dev) * 3 + 0.1
    if mode == "static":
        s = torch.tensor(0.05, device=dev)
        got, ref = q8.quantize_s8_cuda(y, inv_f, s), q8.quantize_s8_plain(y, inv_f, s)
    else:
        amax = None
        if mode == "amax given":
            amax = (y.float() * inv_f).abs().amax().reshape(())
        slots = [q8.ScaleSlots(1, dev).take() for _ in range(2)]
        got = q8.quantize_s8_cuda(y, inv_f, None, amax, slots[0])
        ref = q8.quantize_s8_plain(y, inv_f, None, amax, slots[1])
    ok = all(torch.equal(a, b) for a, b in zip(got, ref))
    return dict(y=list(ys), dtype=dtype, mode=mode, bitwise=ok)


def phase_int8_families(card: str) -> dict:
    """10(e): every covered name but r2plus1d_18 in int8 at its serving clip
    and clip_batch 8 (seeded random weights, 400 classes, the head scaled
    to unit logits: ``_unit_logits``): Q1 at every
    distinct call of its static and dynamic forwards (against its plain
    version, two launches bitwise, the share of the bound), Q2 at every
    distinct quantize call; the calibration's ms; the static, dynamic and
    bf16 forwards' ms (CUDA events); each mode's Q1 / Q2 launches against
    the walk's calls and Q1's against the spec's int8 convs; scores of
    ``make_int8_apply`` (the spec's default mode) against the bf16 'cuda'
    model within PATH_TOL; and ``Tagger(int8=True)`` on a dense 8-clip
    video against the bf16 Tagger."""
    print("== phase 10(e): every covered family in int8", flush=True)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=DEV).manual_seed(SEED + 10)
    checked_q1, checked_q2 = {}, {}
    result, launches, failures = {}, _int8_counts(), []
    launches = {k: 0 for k in launches}
    videos = {}
    for name in (n for n in COVERED_MODELS if n != "r2plus1d_18"):
        t0 = time.perf_counter()
        clip = INT8_FAMILY_CLIPS[name]
        spec = spec_for(name)
        torch.cuda.empty_cache()
        model = _zoo_model(name) if name in ZOO_CLIPS else get_model(
            name, num_classes=ZOO_CLASSES, device="cpu",
            generator=torch.Generator().manual_seed(SEED)).to(DEV).eval()
        x = torch.randn((CLIP_BATCH, *clip, 3), generator=gen, device=DEV).to(torch.bfloat16)
        _unit_logits(model, spec, x)
        state = model.state_dict()
        calib = []
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            qpack, apply_fn = make_int8_apply(name, state, [x], multilabel=True)
            end.record()
            torch.cuda.synchronize()
            calib.append(start.elapsed_time(end))
        runs = {"static": lambda: int8_infer.int8_infer(qpack, x, spec),
                "dynamic": lambda: int8_infer.int8_infer(qpack, x, spec, dynamic=True)}
        row = dict(clip=[CLIP_BATCH, *clip], default_dynamic=spec.default_dynamic,
                   calibration_ms=calib,
                   int8_convs=int8_convs(spec, spec.default_float_blocks))
        for mode, run in runs.items():
            q1_calls, q2_calls = _record_int8_sites(qpack, x, mode == "dynamic", spec)
            walk = dict(conv3d_s8=sum(n for n, _ in q1_calls.values()),
                        quantize_s8=sum(q2_calls.values()),
                        quantize_s8_amax=sum(n for k, n in q2_calls.items()
                                             if k[2] == "two passes"))
            _int8_reset()
            with torch.inference_mode():
                logits = run()
            torch.cuda.synchronize()
            got = _int8_counts()
            for k, v in got.items():
                launches[k] += v
            counts = {k: got[k] for k in walk}
            ok = counts == walk and counts["conv3d_s8"] == row["int8_convs"] and bool(
                torch.isfinite(logits).all().item())
            with torch.inference_mode():
                ms = time_ms(run, iters=3)
            row[mode] = dict(ms=ms, clips_per_s=CLIP_BATCH / ms * 1e3, launches=counts,
                             walk=walk, float_k=[got["spatial_conv"], got["temporal_conv"]],
                             ok=ok)
            if not ok:
                failures.append((name, mode, counts, walk))
            for key, (n, c) in q1_calls.items():
                if key not in checked_q1:
                    checked_q1[key] = dict(_q1_site_check(key, c, gen), first=name)
            for key in q2_calls:
                if key not in checked_q2:
                    checked_q2[key] = dict(_q2_site_check(key, gen), first=name)
        with torch.inference_mode():
            bf16_logits = model(x)
            row["bf16_ms"] = time_ms(lambda: model(x), iters=3)
            scores = apply_fn(qpack, x)
        ref = heads.predict_scores(bf16_logits.float(), True)
        err = (scores.float() - ref).abs().max().item()
        row.update(score_max_abs_diff=err,
                   logit_scale=bf16_logits.float().abs().max().item(),
                   top1_agree=float((scores.argmax(-1) == ref.argmax(-1)).float().mean().item()))
        # the normal entry point: Tagger(int8=True) against the bf16 Tagger
        t, h, w = clip
        hw = INT8_FAMILY_HW[h]
        if (t, hw) not in videos:
            videos[(t, hw)] = make_frames(5, num_frames=t * CLIP_BATCH, height=hw[0],
                                          width=hw[1], seed=SEED + 10)
        frames = videos[(t, hw)]
        cfg = _family_cfg(name, clip)
        tagged = {}
        for int8 in (True, False):
            tagger = Tagger(cfg, state, clip_batch=CLIP_BATCH, int8=int8, device=DEV)
            _int8_reset()
            tagged[int8] = tagger.scores_from(lambda idx: frames[idx], len(frames))
            torch.cuda.synchronize()
            if int8:
                tag_counts = {k: v for k, v in _int8_counts().items()}
                for k, v in tag_counts.items():
                    launches[k] += v
            del tagger
        tag_err = float(np.abs(tagged[True] - tagged[False]).max())
        row.update(tagger_score_max_abs_diff=tag_err,
                   tagger_launches={k: tag_counts[k] for k in ("conv3d_s8", "quantize_s8",
                                                               "quantize_s8_amax")},
                   seconds=time.perf_counter() - t0)
        mode = "dynamic" if spec.default_dynamic else "static"
        tag_ok = (tag_counts["conv3d_s8"] == row["int8_convs"]
                  and np.isfinite(tagged[True]).all())
        if err > PATH_TOL or not tag_ok or tag_err > PATH_TOL:
            failures.append((name, "scores", err, tag_err, tag_counts))
        result[name] = row
        print(f"  {name:22s} {CLIP_BATCH}x{t}x{h}x{w}: calibration {calib[-1]:.1f} ms; static "
              f"{row['static']['ms']:.3f} ms, dynamic {row['dynamic']['ms']:.3f} ms, bf16 "
              f"{row['bf16_ms']:.3f} ms a forward; Q1 / Q2 / amax static "
              f"{list(row['static']['launches'].values())} dynamic "
              f"{list(row['dynamic']['launches'].values())} (walk {row['static']['walk'] == row['static']['launches']}"
              f"/{row['dynamic']['walk'] == row['dynamic']['launches']}, int8 convs "
              f"{row['int8_convs']}), K1/K2 {row['static']['float_k']}; scores ({mode}) vs bf16 "
              f"{err:.3e} (logits up to {row['logit_scale']:.3g}, top-1 agree "
              f"{row['top1_agree']:.2f}); Tagger int8 vs bf16 {tag_err:.3e}, launches "
              f"{row['tagger_launches']}; {row['seconds']:.1f} s", flush=True)
        del model, state, qpack, apply_fn, x, runs, bf16_logits, scores
    q1_rows = list(checked_q1.values())
    for r in q1_rows:
        print(f"  Q1 {r['first']:20s} x{tuple(r['x'])} cp={r['cp']} k{tuple(r['kernel'])} "
              f"s{tuple(r['strides'])} pads {r['pads']} -> {r['co']} {r['form']}: {r['ms']:.4f} "
              f"ms, {r['share']:.3f} of the bound {r['bound_ms']:.4f} ({r['bound_by']}); "
              f"identity bitwise {r['identity_bitwise']}, two launches bitwise "
              f"{r['two_launches_bitwise']}, form bitwise {r['form_bitwise']} "
              f"({r['max_bf16_ulps']:.2f} bf16 ulp) ok={r['ok']}", flush=True)
    q2_rows = list(checked_q2.values())
    bad_q2 = [r for r in q2_rows if not r["bitwise"]]
    print(f"  Q2 at {len(q2_rows)} distinct (y, dtype, mode) calls bitwise against its plain "
          f"version: {len(q2_rows) - len(bad_q2)} (failing: {bad_q2})", flush=True)
    worst = min(q1_rows, key=lambda r: r["share"])
    print(f"(e) Q1 at {len(q1_rows)} distinct calls, its worst share of the bound "
          f"{worst['share']:.3f} at {worst['first']} x{tuple(worst['x'])} k{tuple(worst['kernel'])} "
          f"-> {worst['co']} {worst['form']}; phase 10(e) took {time.perf_counter() - t_phase:.1f} "
          f"s on {card}", flush=True)
    failures += [("Q1", r["first"], r["x"], r["kernel"], r["co"], r["form"])
                 for r in q1_rows if not r["ok"]] + [("Q2", r) for r in bad_q2]
    if failures:
        raise SystemExit(f"10(e) failed: {failures}")
    return dict(result=result, q1_sites=q1_rows, q2_sites=q2_rows, launches=launches,
                worst=dict(worst))


def int8_entries(int8: dict) -> list:
    """The ``kernels`` line's entries of Q1 and Q2 from phase 10: launches of
    its int8 runs, times per static forward at clip_batch 8."""
    entries = []
    for key, meta in INT8_KERNELS.items():  # Q1, Q2: phase 10's int8 runs
        runs = {run: c[key] + (c["quantize_s8_amax"] if key == "quantize_s8" else 0)
                for run, c in int8["launches"].items()}
        a = int8["kernels"][CLIP_BATCH]
        if key == "conv3d_s8":
            s8 = a["q1"]
            extra = dict(library_ms=s8["library_ms"], bound_ms=s8["bound_ms"],
                         bound_by="operations" if s8["ops_ms"] >= s8["bytes_ms"] else "bytes",
                         max_abs_err=s8["max_abs_err"], max_bf16_ulps=s8["max_ulps"],
                         bf16_route_ms=s8["bf16_ms"], unfused_chain_ms=s8["chain_ms"],
                         b32=dict(int8["kernels"][TRAIN_BATCH]["q1"]),
                         sites=a["q1_sites"] + int8["kernels"][TRAIN_BATCH]["q1_sites"])
            extra.update(dynamic_amax=a["q1_dynamic"],
                         dynamic_amax_b32=int8["kernels"][TRAIN_BATCH]["q1_dynamic"],
                         dynamic_amax_sites=a["q1_dynamic_sites"]
                         + int8["kernels"][TRAIN_BATCH]["q1_dynamic_sites"])
        else:
            s8 = a["q2"]
            extra = dict(library_ms=None, bound_ms=s8["bound_ms"], bound_by="bytes",
                         max_abs_err=0.0, dynamic_ms=s8["dyn_ms"],
                         dynamic_device_ms=s8["dyn_device_ms"] if s8["device_measured"] else None,
                         dynamic_bare_launch_ms=s8["dyn_bare_ms"],
                         dynamic_host_ms=s8["dyn_host_ms"], dynamic_two_passes_ms=s8["two_pass_ms"],
                         dynamic_plain_ms=s8["dyn_plain_ms"], dynamic_bound_ms=s8["dyn_bound_ms"],
                         b32=dict(int8["kernels"][TRAIN_BATCH]["q2"]),
                         sites=a["q2_sites"] + int8["kernels"][TRAIN_BATCH]["q2_sites"])
        if sum(runs.values()) == 0:
            raise SystemExit(f"{meta['name']} was launched no time on its path")
        entries.append(dict(
            meta, launches=sum(runs.values()), launches_by_run=runs, ms=s8["ms"],
            plain_ms=s8["plain_ms"], ok=True,
            per=f"one static r2plus1d_18 int8 forward at clip_batch {CLIP_BATCH} (the sum over "
                f"its launches)" + ("; library_ms: torch._int_mm over an explicit im2col"
                                    if key == "conv3d_s8" else ""), **extra))
    return entries


# ---------------------------------------------------------------------------
# Phase 11: the serving export (cli.export, evaluation/serving.py) on the
# fvt::* custom ops
# ---------------------------------------------------------------------------

EXPORT_PRESET = "r2plus1d18_ucf101"
EXPORT_FORWARD = {  # launches a forward of a loaded artifact at clip_batch 8
    "bf16": {"conv3d_s8": 0, "quantize_s8": 0, "quantize_s8_amax": 0, "spatial_conv": 13,
             "temporal_conv": 14},
    "int8": {**INT8_FORWARD, **INT8_FLOAT_K},
    "int8_dynamic": {**INT8_DYNAMIC, **INT8_FLOAT_K},
}
EXPORT_TOL = 1e-3  # loaded artifact against the in-process serving fn, absolute
EXPORT_TIMED = 20  # forwards timed by CUDA events a measurement
DISPATCH_CALLS = 200  # calls a host-time measurement of the dispatcher

# Run in a fresh python3 process: loads each artifact with nothing but
# evaluation/serving.py imported, scores the parent's clips, counts a
# forward's launches and times forwards by CUDA events.
_LOAD_ARTIFACTS = r"""
import json, sys, time
import numpy as np
import torch
from fastvideotagging_tpu_torch.evaluation import serving

k12, q8 = serving.library.k12, serving.library.q8


def counts():
    torch.cuda.synchronize()
    return {**q8.launch_counts, "spatial_conv": k12.launch_counts["spatial_conv"],
            "temporal_conv": k12.launch_counts["temporal_conv"]}


def reset():
    torch.cuda.synchronize()
    q8.reset_launch_counts()
    k12.reset_launch_counts()


out = {}
jobs, timed = json.loads(sys.argv[1]), int(sys.argv[2])
for name, job in jobs.items():
    t0 = time.perf_counter()
    run = serving.load_serving(job["artifact"])
    load_s = time.perf_counter() - t0
    clips = np.load(job["clips"])
    reset()
    t0 = time.perf_counter()
    run(clips)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm = counts()
    reset()
    scores = run(clips)
    launches = counts()
    np.save(job["scores"], scores.float().cpu().numpy())
    x = torch.from_numpy(clips).cuda()
    for _ in range(2):
        run(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(timed):
        run(x)
    end.record()
    torch.cuda.synchronize()
    out[name] = dict(load_s=load_s, first_call_s=first_s, launches=launches,
                     launches_total={k: warm[k] + launches[k] for k in warm},
                     ms=start.elapsed_time(end) / timed)
print(json.dumps(out))
"""


def _ms_and_host(fn, x) -> tuple[float, float]:
    """(CUDA-event ms, the host's ms) a forward of ``fn(x)`` over
    ``EXPORT_TIMED`` forwards after two warm-up forwards; the host's is the
    time to enqueue them, which is the forward's time where the host is the
    bottleneck."""
    for _ in range(2):
        fn(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(EXPORT_TIMED):
        fn(x)
    host = (time.perf_counter() - t0) * 1e3 / EXPORT_TIMED
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / EXPORT_TIMED, host


def _export_counts() -> dict:
    torch.cuda.synchronize()
    return {**q8.launch_counts, **{k: ops.launch_counts[k] for k in INT8_FLOAT_K}}


def _add_counts(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}


def _dispatch_costs(card: str) -> dict:
    """Host time a call of each serving kernel through its ``fvt::*`` op
    and through the bare wrapper it reaches (the kernel's ctypes launch),
    at small stage-4 shapes where the device keeps up: the enqueue time of
    ``DISPATCH_CALLS`` calls, the card synchronized before and after."""
    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)

    def bf16(*shape):
        return torch.randn(shape, device=DEV, generator=gen).to(torch.bfloat16)

    x, w1, w2 = bf16(2, 7, 7, 512), bf16(3, 3, 512, 512), bf16(3, 512, 512)
    xt = bf16(2, 2, 49, 512)
    q = torch.randint(-127, 128, (1, 2, 7, 7, 512), device=DEV, generator=gen,
                      dtype=torch.int8)
    wk = torch.randint(-127, 128, (512, 9, 512), device=DEV, generator=gen, dtype=torch.int8)
    vec = torch.rand(512, device=DEV, generator=gen) * 1e-3
    s = torch.tensor(0.05, device=DEV)
    conv = (q, wk, [1, 3, 3], vec, vec, s, [1, 1, 1], [0, 0, 1, 1, 1, 1])
    y = bf16(2, 2, 7, 7, 512)
    cases = {
        "K1 spatial_conv": (lambda: torch.ops.fvt.spatial_conv(x, w1),
                            lambda: ops.spatial_conv_cuda(x, w1)),
        "K2 temporal_conv": (lambda: torch.ops.fvt.temporal_conv(xt, w2),
                             lambda: ops.temporal_conv_cuda(xt, w2)),
        "Q1 conv3d_s8 (a)": (lambda: torch.ops.fvt.conv3d_s8(*conv, True, False, "", None,
                                                             None, None),
                             lambda: q8.conv3d_s8_cuda(q, wk, (1, 3, 3), vec, vec, s,
                                                       (1, 1, 1), ((0, 0), (1, 1), (1, 1)),
                                                       True, False)),
        "Q2 quantize_s8 static": (lambda: torch.ops.fvt.quantize_s8(y, vec, s),
                                  lambda: q8.quantize_s8_cuda(y, vec, s)),
    }
    out = {}
    for name, (op, bare) in cases.items():
        host = {}
        for route, fn in (("op", op), ("bare", bare), ("op2", op), ("bare2", bare)):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(DISPATCH_CALLS):
                fn()
            host[route] = (time.perf_counter() - t0) / DISPATCH_CALLS * 1e6
            torch.cuda.synchronize()
        op_us, bare_us = min(host["op"], host["op2"]), min(host["bare"], host["bare2"])
        out[name] = dict(op_us=op_us, bare_us=bare_us, dispatcher_us=op_us - bare_us,
                         turns_us=host)
        turns = json.dumps({k: round(v, 2) for k, v in host.items()})
        print(f"(f) {name}: host time a call through the op {op_us:.2f} us, the bare wrapper "
              f"{bare_us:.2f} us: the dispatcher {op_us - bare_us:.2f} us a call (best of 2 "
              f"turns of {DISPATCH_CALLS} calls; turns {turns}) on {card}", flush=True)
    return out


def phase_export(card: str, tmp: str) -> dict:
    """Phase 11: ``cli.export`` (bf16 and ``--int8 --calib-video``) of
    r2plus1d_18 at full width, each artifact loaded in a fresh process and
    held to the in-process serving fn, a forward's launches, an export of
    the dynamic int8 engine, the forwards' ms and the dispatcher's cost."""
    print("== phase 11: export", flush=True)
    t_phase = time.perf_counter()
    from fastvideotagging_tpu_torch.cli import export as cli_export
    from fastvideotagging_tpu_torch.cli.common import build_config
    from fastvideotagging_tpu_torch.evaluation import serving

    d11 = os.path.join(tmp, "export")
    os.makedirs(d11, exist_ok=True)
    preset = PRESETS[EXPORT_PRESET]
    t, (h, w) = preset.data.sampler.clip_len, preset.data.source_hw or preset.data.resize_hw
    classes = preset.model.num_classes
    g = torch.Generator().manual_seed(SEED)
    state = get_model("r2plus1d_18", num_classes=classes, device="cpu",
                      generator=g).state_dict()
    weights = os.path.join(d11, "w.pt")
    export_weights(weights, state)
    frames = make_frames(3, num_frames=160, height=h, width=w, seed=SEED)  # phase 4's video
    video = os.path.join(d11, "video.fvtpack")
    write_pack_from_arrays([("video.mp4", 0, (), frames)], video, (h, w))

    # (a) cli.export, bf16 and int8; the launches of phase 11's runs from 0
    argv = ["--preset", EXPORT_PRESET, "--weights", weights, "--clip-batch", str(CLIP_BATCH)]
    int8_argv = ["--int8", "--calib-video", video]
    _int8_reset()
    metas, export_s = {}, {}
    for engine, extra in (("bf16", []), ("int8", int8_argv)):
        t0 = time.perf_counter()
        metas[engine] = cli_export.main(argv + ["--out", os.path.join(d11, engine)] + extra)
        export_s[engine] = time.perf_counter() - t0
        size = metas[engine]["artifacts"]["torch"]["bytes"]
        print(f"(a) cli.export {engine}: {export_s[engine]:.1f} s (weights load, "
              f"{'calibration, ' if engine == 'int8' else ''}torch.export, save), serving.pt2 "
              f"{size} bytes; input {metas[engine]['input']['shape']} uint8", flush=True)
        if metas[engine]["int8"] != (engine == "int8") or metas[engine]["input"]["shape"] != [
                CLIP_BATCH, t, h, w, 3]:
            raise SystemExit(f"(a) cli.export {engine} wrote the wrong meta.json")
    launches = _export_counts()

    # the in-process serving fns on the same weights and qpack
    cfg = build_config(cli_export.parse_args(argv + ["--out", d11]))
    calib = cli_export.collect_pack_calib_clips(cfg, video, CLIP_BATCH)
    sd = {k: v.to(DEV) for k, v in state.items()}
    _int8_reset()
    qpack = serving.quantize_for_serving(cfg, sd, calib, device=DEV)
    fns = {"bf16": serving.make_serving_fn(cfg, sd, device=DEV),
           "int8": serving.make_serving_fn(cfg, sd, qpack=qpack, device=DEV)}
    clips = {CLIP_BATCH: frames[np.arange(CLIP_BATCH * t).reshape(CLIP_BATCH, t)],
             TRAIN_BATCH: np.random.default_rng(SEED + 12).integers(
                 0, 256, (TRAIN_BATCH, t, h, w, 3), dtype=np.uint8)}

    # the B = 32 artifacts through the library call, for (e)
    paths = {("bf16", CLIP_BATCH): os.path.join(d11, "bf16", "serving.pt2"),
             ("int8", CLIP_BATCH): os.path.join(d11, "int8", "serving.pt2")}
    for engine in fns:
        t0 = time.perf_counter()
        path = os.path.join(d11, f"{engine}_b{TRAIN_BATCH}.pt2")
        serving.export_serving(cfg, sd, TRAIN_BATCH, path=path,
                               qpack=qpack if engine == "int8" else None, device=DEV)
        paths[(engine, TRAIN_BATCH)] = path
        print(f"(a) export_serving {engine} at clip_batch {TRAIN_BATCH}: "
              f"{time.perf_counter() - t0:.1f} s, {os.path.getsize(path)} bytes", flush=True)
    launches = _add_counts(launches, _export_counts())

    # in-process: a forward's launches, scores and ms
    inproc, scores_in = {}, {}
    for (engine, b), _ in paths.items():
        fn, x = fns[engine], torch.from_numpy(clips[b]).to(DEV)
        with torch.no_grad():
            fn(x)
            _int8_reset()
            scores_in[(engine, b)] = fn(x).float().cpu().numpy()
            counted = _export_counts()
            launches = _add_counts(launches, counted)
            inproc[(engine, b)] = dict(launches=counted, ms=time_ms(lambda: fn(x),
                                                                     iters=EXPORT_TIMED))
        _int8_reset()
        if b == CLIP_BATCH and counted != EXPORT_FORWARD[engine]:
            raise SystemExit(f"(c) an in-process {engine} forward launched {counted}, not "
                             f"{EXPORT_FORWARD[engine]}")

    # (b, c, e) each artifact in a fresh process
    jobs = {}
    for (engine, b), path in paths.items():
        name = f"{engine}_b{b}"
        np.save(os.path.join(d11, f"clips_b{b}.npy"), clips[b])
        jobs[name] = dict(artifact=path, clips=os.path.join(d11, f"clips_b{b}.npy"),
                          scores=os.path.join(d11, f"scores_{name}.npy"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _LOAD_ARTIFACTS, json.dumps(jobs),
                           str(EXPORT_TIMED)], capture_output=True, text=True, timeout=900,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    if proc.returncode != 0:
        raise SystemExit(f"(b) loading the artifacts in a fresh process failed:\n"
                         f"{proc.stderr[-4000:]}")
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"(b) the fresh process (imports evaluation.serving only) took "
          f"{time.perf_counter() - t0:.1f} s for {len(jobs)} artifacts", flush=True)
    result = {}
    for (engine, b), path in paths.items():
        name = f"{engine}_b{b}"
        got = np.load(jobs[name]["scores"])
        err = float(np.abs(got - scores_in[(engine, b)]).max())
        lo = loaded[name]
        launches = _add_counts(launches, lo["launches_total"])
        result[name] = dict(bytes=os.path.getsize(path), max_abs_diff=err,
                            loaded_ms=lo["ms"], in_process_ms=inproc[(engine, b)]["ms"],
                            loaded_launches=lo["launches"],
                            in_process_launches=inproc[(engine, b)]["launches"],
                            load_s=lo["load_s"], first_call_s=lo["first_call_s"])
        print(f"(b) {name}: loaded artifact vs in-process scores max |diff| {err:.3e} (tol "
              f"{EXPORT_TOL}); (c) a forward's launches loaded {lo['launches']}, in-process "
              f"{inproc[(engine, b)]['launches']}; (e) forward {lo['ms']:.3f} ms loaded, "
              f"{inproc[(engine, b)]['ms']:.3f} ms in-process (CUDA events, {EXPORT_TIMED} "
              f"forwards); load {lo['load_s']:.2f} s, first call {lo['first_call_s']:.2f} s "
              f"on {card}", flush=True)
        if not (got.shape == (b, classes) and np.isfinite(got).all() and err <= EXPORT_TOL):
            raise SystemExit(f"(b) the loaded {name} artifact disagrees with the in-process fn")
        if lo["launches"] != inproc[(engine, b)]["launches"] or (
                b == CLIP_BATCH and lo["launches"] != EXPORT_FORWARD[engine]):
            raise SystemExit(f"(c) the loaded {name} artifact launched {lo['launches']}")

    # (e) in turns in this process: the in-process fn and the artifact loaded
    # here, CUDA events and the host's enqueue time a forward
    for (engine, b), path in paths.items():
        name = f"{engine}_b{b}"
        fn, run = fns[engine], serving.load_serving(path)
        x = torch.from_numpy(clips[b]).to(DEV)
        turns = {"in_process": [], "loaded": []}
        with torch.no_grad():
            for route in ("in_process", "loaded", "loaded", "in_process"):
                turns[route].append(_ms_and_host(fn if route == "in_process" else run, x))
        _int8_reset()
        graph = [str(n.target) for n in run.program.graph.nodes if n.op == "call_function"]
        nodes = dict(calls=len(graph), fvt_ops=sum(t.startswith("fvt.") for t in graph),
                     metadata_asserts=graph.count("aten._assert_tensor_metadata.default"),
                     dtype_casts=graph.count("aten.to.dtype"))
        result[name].update(turns=turns, graph_nodes=nodes)
        print(f"(e) {name} in turns in one process (in-process, loaded, loaded, in-process): "
              f"forward ms {[round(t[0], 3) for t in turns['in_process']]} in-process, "
              f"{[round(t[0], 3) for t in turns['loaded']]} loaded; the host's ms a forward "
              f"{[round(t[1], 3) for t in turns['in_process']]} / "
              f"{[round(t[1], 3) for t in turns['loaded']]} (CUDA events and the host clock, "
              f"{EXPORT_TIMED} forwards a turn) on {card}; the loaded graph's op calls "
              f"{json.dumps(nodes)}", flush=True)
        del run

    # (d) torch.export of the dynamic int8 engine on the same qpack
    x = torch.from_numpy(clips[CLIP_BATCH]).to(DEV)
    dyn = serving.ServingFn(cfg, sd, qpack=qpack, device=DEV, dynamic=True)
    with torch.no_grad():
        want = dyn(x)
        t0 = time.perf_counter()
        program = torch.export.export(dyn, (x,))
        dyn_export_s = time.perf_counter() - t0
        module = program.module()
        module(x)
        _int8_reset()
        got = module(x)
        counted = _export_counts()
    launches = _add_counts(launches, counted)
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    mutating = {op: nodes.count(f"fvt.{op}.default") for op in
                ("conv3d_s8_amax", "quantize_s8_given", "quantize_s8_dynamic")}
    err = (got - want).abs().max().item()
    print(f"(d) torch.export of the dynamic int8 engine: {dyn_export_s:.1f} s; the graph's "
          f"mutating ops {mutating}; a forward's launches {counted} (want "
          f"{EXPORT_FORWARD['int8_dynamic']}); scores vs the eager dynamic forward max |diff| "
          f"{err:.3e} (tol {EXPORT_TOL})", flush=True)
    if counted != EXPORT_FORWARD["int8_dynamic"] or err > EXPORT_TOL or mutating != {
            "conv3d_s8_amax": 25, "quantize_s8_given": 25, "quantize_s8_dynamic": 1}:
        raise SystemExit("(d) the dynamic int8 export lost its amax reductions or disagrees")
    del program, module, dyn, fns
    torch.cuda.empty_cache()

    dispatch = _dispatch_costs(card)
    print(f"phase 11 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return dict(launches=launches, export_s=export_s, artifacts=result,
                dynamic=dict(export_s=dyn_export_s, launches=counted, max_abs_diff=err,
                             mutating_ops=mutating),
                dispatch=dispatch,
                files=dict(dir=d11, argv=argv, int8_argv=int8_argv, state=state,
                           frames=frames, video=video,
                           loaded={e: paths[(e, CLIP_BATCH)] for e in ("bf16", "int8")}))


# ---------------------------------------------------------------------------
# Phase 12: the native serving tier (the fvt::* ops registered in C++, the
# AOTInductor packages, the runner, NativeTagger, --engine native)
# ---------------------------------------------------------------------------

# the runner's scores against the in-process ServingFn: the same kernels, but
# Inductor's fused glue (the uint8 preprocess, eval BatchNorm in bf16) rounds
# at other places than the eager chain; the serving tolerance
NATIVE_TOL = 5e-2
# distinct instances of the runner's --bench: 1 warm-up, 7 + 24 timed. The
# host slope is (t_long - t_short) / (n_long - n_short), and the short batch
# carries a start-up cost of tens of ms (a slope of 1.5 ms against 4.5 ms of
# device time at 2 + 9 instances: 21 ms), which at 2 + 9 made the slope
# non-positive three times in a row in one run; 17 executions outweigh it.
NATIVE_BENCH = 32
NATIVE_BENCH_ATTEMPTS = 3  # runs of one --bench until the host slope is positive
NATIVE_ENGINES = ("bf16", "int8", "int8_dynamic")


def start_native_build() -> dict:
    """Phase 12(a)'s build, the op library and the CUDA runner (g++ against
    libtorch, tens of seconds), in a thread while phases 3-11 run; phase 12
    joins it (and the interpreter waits for it at exit)."""
    job = {}

    def build():
        t0 = time.perf_counter()
        try:
            job["paths"] = _build.build_native()
        except RuntimeError as e:
            job["error"] = str(e)
        job["s"] = time.perf_counter() - t0

    job["thread"] = threading.Thread(target=build, name="native-build")
    job["thread"].start()
    return job


def _native_counts(launches) -> dict:
    """The op library's counts as phase 11's forward dicts have them."""
    return {k: int((launches or {}).get(k, 0)) for k in EXPORT_FORWARD["bf16"]}


def phase_native(card: str, tmp: str, export: dict, build: dict) -> dict:
    """Phase 12: the native serving tier on phase 11's weights: the build,
    ``cli.export --format native``, the runner one shot and as a daemon, the
    taggers and CLIs on top of it, and the forward's ms in turns."""
    print("== phase 12: native serving", flush=True)
    t_phase = time.perf_counter()
    from fastvideotagging_tpu_torch.cli import export as cli_export
    from fastvideotagging_tpu_torch.cli.common import build_config
    from fastvideotagging_tpu_torch.evaluation import serving
    from fastvideotagging_tpu_torch.evaluation.native_tagger import NativeTagger
    from fastvideotagging_tpu_torch.native import runner

    # (a) the build started in phase 2
    build["thread"].join()
    if "error" in build:
        raise SystemExit(f"(a) building the op library and the runner failed:\n"
                         f"{build['error'][-4000:]}")
    print(f"(a) the op library and the CUDA runner built with g++ against libtorch in "
          f"{build['s']:.1f} s (a thread from phase 2 on): "
          f"{json.dumps({k: os.path.basename(v) for k, v in build['paths'].items()})}",
          flush=True)
    files = export["files"]
    d12 = os.path.join(tmp, "native")
    os.makedirs(d12, exist_ok=True)
    launches = _native_counts(None)  # summed over the runner processes

    def add(counts):
        for k, v in _native_counts(counts).items():
            launches[k] += v

    # (b) the packages: cli.export --format native, and the dynamic engine
    pkgs, export_s = {}, {}
    for engine, extra in (("bf16", []), ("int8", files["int8_argv"])):
        t0 = time.perf_counter()
        meta = cli_export.main(files["argv"] + ["--out", os.path.join(d12, engine), "--format",
                                                "native"] + extra)
        export_s[engine] = time.perf_counter() - t0
        art = meta["artifacts"]
        pkgs[engine] = os.path.join(d12, engine, art["native"]["file"])
        if list(art) != ["native"] or art["native"]["device"] != "cuda" or meta["int8"] != (
                engine == "int8"):
            raise SystemExit(f"(b) cli.export --format native {engine} wrote {art}")
    cfg = build_config(cli_export.parse_args(files["argv"] + ["--out", d12]))
    sd = {k: v.to(DEV) for k, v in files["state"].items()}
    calib = cli_export.collect_pack_calib_clips(cfg, files["video"], CLIP_BATCH)
    qpack = serving.quantize_for_serving(cfg, sd, calib, device=DEV)
    t0 = time.perf_counter()
    pkgs["int8_dynamic"] = serving.export_serving_native(
        cfg, sd, CLIP_BATCH, os.path.join(d12, "int8_dynamic.native.pt2"), qpack=qpack,
        device=DEV, dynamic=True)
    export_s["int8_dynamic"] = time.perf_counter() - t0
    sizes = {e: os.path.getsize(p) for e, p in pkgs.items()}
    for engine in NATIVE_ENGINES:
        print(f"(b) {engine} AOTInductor package at clip_batch {CLIP_BATCH}: "
              f"{export_s[engine]:.1f} s ({'cli.export --format native' if engine != 'int8_dynamic' else 'export_serving_native(dynamic=True)'}"
              f"{', calibration included' if engine == 'int8' else ''}), {sizes[engine]} bytes",
              flush=True)
    fns = {"bf16": serving.ServingFn(cfg, sd, device=DEV),
           "int8": serving.ServingFn(cfg, sd, qpack=qpack, device=DEV, dynamic=False),
           "int8_dynamic": serving.ServingFn(cfg, sd, qpack=qpack, device=DEV, dynamic=True)}
    t, (h, w) = cfg.data.sampler.clip_len, cfg.data.source_hw or cfg.data.resize_hw
    clips = np.random.default_rng(SEED + 13).integers(
        0, 256, (NATIVE_BENCH, CLIP_BATCH, t, h, w, 3), dtype=np.uint8)

    def in_process(engine, x):
        with torch.no_grad():
            return fns[engine](torch.from_numpy(x).to(DEV)).float().cpu().numpy()

    # (c) one shot, each package: scores, a forward's launches
    one_shot = {}
    for engine in NATIVE_ENGINES:
        want = in_process(engine, clips[0])
        t0 = time.perf_counter()
        summary = runner.run_summary(pkgs[engine], [clips[0]], os.path.join(d12, f"run_{engine}"),
                                     device=DEV)
        run_s = time.perf_counter() - t0
        got, counts = summary["outputs"][0], _native_counts(summary["launches"])
        add(counts)
        err = float(np.abs(got - want).max())
        one_shot[engine] = dict(max_abs_diff=err, launches=counts, process_s=run_s)
        print(f"(c) {engine}: the runner's scores vs the in-process ServingFn max |diff| "
              f"{err:.3e} (tol {NATIVE_TOL}); the C++ op library's launches a forward {counts}; "
              f"the process (load, one forward, exit) {run_s:.2f} s", flush=True)
        if not (got.shape == want.shape and np.isfinite(got).all() and err <= NATIVE_TOL):
            raise SystemExit(f"(c) the native {engine} package disagrees with the serving fn")
        if counts != EXPORT_FORWARD[engine]:
            raise SystemExit(f"(c) the native {engine} forward launched {counts}, not "
                             f"{EXPORT_FORWARD[engine]}")

    # (c) the daemon: no Python in its process; a malformed line answered
    spec = [((CLIP_BATCH, t, h, w, 3), np.uint8)]
    with runner.NativeServer(pkgs["bf16"], spec, os.path.join(d12, "serve"), device=DEV) as srv:
        with open(f"/proc/{srv.pid}/maps") as f:
            maps = f.read()
        exe = os.readlink(f"/proc/{srv.pid}/exe")
        first, = srv.request([clips[1]])
        srv._proc.stdin.write("/no/such/request.bin\n")
        srv._proc.stdin.flush()
        bad = json.loads(srv._proc.stdout.readline())
        srv._req_id += 1  # the raw line spent an id the client did not issue
        after, = srv.request([clips[2]])
        add(srv.launches)
    no_python = "libpython" not in maps and "python" not in os.path.basename(exe)
    daemon_err = max(float(np.abs(first - in_process("bf16", clips[1])).max()),
                     float(np.abs(after - in_process("bf16", clips[2])).max()))
    print(f"(c) the --serve daemon: {os.path.basename(exe)}, libpython in its maps: "
          f"{'libpython' in maps}; a malformed line answered {json.dumps(bad)}, the next "
          f"request served (max |diff| {daemon_err:.3e})", flush=True)
    if not (no_python and "error" in bad and daemon_err <= NATIVE_TOL):
        raise SystemExit("(c) the native daemon has Python in it or lost a request")

    # (d) NativeTagger, cli.tag and cli.serve --engine native over an eval pack
    pack = os.path.join(d12, "eval.fvtpack")
    write_pack_from_arrays(list(_eval_items()), pack, (h, w), EVAL_CLASSES)
    tagger = Tagger(cfg, sd, clip_batch=CLIP_BATCH, device=DEV)
    p = open_dataset(pack, cfg.data, mode="eval").pack
    ref = {rec.path: tagger.scores_from(lambda idx, _i=i: p.gather(_i, idx),
                                        p.entries[i]["probe_frames"])
           for i, rec in enumerate(p.records(""))}
    closed = []
    close = runner.NativeServer.close

    def counting_close(server):  # the CLIs' daemons' counts
        closed.append(server.launches)
        close(server)

    taggers = {}
    runner.NativeServer.close = counting_close
    try:
        for pipeline in (0, 2):
            t0 = time.perf_counter()
            with NativeTagger(os.path.join(d12, "bf16"), pipeline=pipeline, device=DEV) as nt:
                got = dict(nt.iter_pack_scores(pack))
            err = max(float(np.abs(got[k] - ref[k]).max()) for k in ref)
            taggers[pipeline] = dict(max_abs_diff=err, s=time.perf_counter() - t0)
            print(f"(d) NativeTagger --pipeline {pipeline} over the {len(ref)}-video pack: "
                  f"video scores vs the in-process Tagger max |diff| {err:.3e} (tol "
                  f"{NATIVE_TOL}), {taggers[pipeline]['s']:.2f} s", flush=True)
            if list(got) != list(ref) or err > NATIVE_TOL:
                raise SystemExit("(d) NativeTagger disagrees with the in-process Tagger")
        art_flags = ["--engine", "native", "--artifacts", os.path.join(d12, "bf16")]
        _, printed = _quiet(cli_tag.main, [pack] + art_flags + ["--threshold", "0.0"])
        lines = [json.loads(line) for line in printed.strip().splitlines()]
        tag_err = max(abs(tg["score"] - float(ref[r["video"]][int(tg["tag"].split("_")[1])]))
                      for r in lines for tg in r["tags"])
        missing = os.path.join(d12, "missing.fvtpack")
        stdin = sys.stdin
        sys.stdin = io.StringIO(f"{pack}\n{missing}\n" + json.dumps({"video": pack, "top_k": 2})
                                + "\n")
        err_buf = io.StringIO()
        try:
            with contextlib.redirect_stderr(err_buf):
                stats, printed = _quiet(cli_serve.main, art_flags + ["--threshold", "0.0"])
        finally:
            sys.stdin = stdin
    finally:
        runner.NativeServer.close = close
    for counts in closed:
        add(counts)
    resp = [json.loads(line) for line in printed.strip().splitlines()]
    n = len(ref)
    print(f"(d) cli.tag --engine native: {len(lines)} lines, scores vs the in-process Tagger "
          f"max |diff| {tag_err:.3e}; cli.serve --engine native: {stats}, {len(resp)} lines, "
          f"line {n + 1} {json.dumps(resp[n]) if len(resp) > n else None}", flush=True)
    if len(lines) != n or tag_err > NATIVE_TOL:
        raise SystemExit("(d) cli.tag --engine native did not answer as it should")
    if not (stats == {"served": 2, "errors": 1} and len(resp) == 2 * n + 1
            and "error" in resp[n] and all(len(r["tags"]) == 2 for r in resp[n + 1:])
            and "ready" in err_buf.getvalue()):
        raise SystemExit("(d) cli.serve --engine native did not answer as it should")

    # (e) the forward at clip_batch 8 in turns: in-process and phase 11's loaded
    # serving.pt2 by CUDA events here, the runner's --bench in its process
    turns = {}
    for engine in NATIVE_ENGINES:
        loaded = (serving.load_serving(files["loaded"][engine]) if engine in files["loaded"]
                  else None)
        x = torch.from_numpy(clips[0]).to(DEV)
        rec = {"in_process": [], "native": [], "loaded": []}
        order = ("in_process", "native", "loaded", "loaded", "native", "in_process")
        for route in order:
            if route == "loaded" and loaded is None:
                continue
            if route == "native":
                # the runner leaves its bench out when the host's two-point
                # slope comes out non-positive (host noise over a few ms):
                # then the instance is measured again, at most twice more
                for attempt in range(NATIVE_BENCH_ATTEMPTS):
                    summary = runner.run_summary(pkgs[engine], [clips],
                                                 os.path.join(d12, f"bench_{engine}"),
                                                 device=DEV, bench=NATIVE_BENCH)
                    add(summary["launches"])
                    b = summary.get("bench")
                    last = float(np.abs(summary["outputs"][0]
                                        - in_process(engine, clips[-1])).max())
                    if last > NATIVE_TOL or b is not None:
                        break
                    print(f"(e) the runner's --bench of {engine}: no positive host slope "
                          f"(attempt {attempt + 1}); measured again", flush=True)
                if b is None or b["device_ms_per_exec"] <= 0 or last > NATIVE_TOL:
                    raise SystemExit(f"(e) the runner's --bench of {engine} failed: {b}, "
                                     f"last instance max |diff| {last:.3e}")
                rec["native"].append((b["device_ms_per_exec"], b["sec_per_exec"] * 1e3))
            else:
                with torch.no_grad():
                    rec[route].append(_ms_and_host(fns[engine] if route == "in_process"
                                                   else loaded, x))
        turns[engine] = rec
        fmt = {k: [[round(a, 3), round(b, 3)] for a, b in v] for k, v in rec.items() if v}
        print(f"(e) {engine} at clip_batch {CLIP_BATCH} in turns (in-process, native, loaded, "
              f"loaded, native, in-process): [device ms by CUDA events, host ms] a forward "
              f"{json.dumps(fmt)}; the runner's {CLIP_BATCH} / device ms = "
              f"{[round(CLIP_BATCH / a * 1e3, 1) for a, _ in rec['native']]} clips/s on {card}",
              flush=True)
        del loaded
    torch.cuda.empty_cache()
    print(f"(f) phase 12's launches counted by the C++ op library {launches}", flush=True)
    if min(launches.values()) == 0:
        raise SystemExit(f"(f) a serving kernel was launched no time in phase 12: {launches}")
    print(f"phase 12 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    return dict(launches=launches, build_s=build["s"], export_s=export_s, bytes=sizes,
                one_shot=one_shot, daemon=dict(no_python=no_python, max_abs_diff=daemon_err,
                                               bad_request=bad),
                tagger=taggers, cli=dict(tag_max_abs_diff=tag_err, serve=stats), turns=turns)


# ---------------------------------------------------------------------------
# phase 13: parallelism across processes
# ---------------------------------------------------------------------------

PAR_STEPS = 2  # (a): steps of the data-parallel step at world size 1 against the plain one
PAR_RANKS = 2  # (b), (c): processes sharing the one card over gloo
PAR_CLI_BATCH, PAR_CLI_VIDEOS = 16, 48  # (b): 3 steps of 8 rows a rank, one epoch
LONG_B, LONG_T = 2, 64  # (c): clips of 64 frames, 32 a rank
PAR_TIMEOUT = 420  # seconds the ranks of one job may take together
PAR_GROUP_TIMEOUT = 120  # seconds a collective may wait before the job fails
# Step-1 gradients over the ranks against one process (b) or the unsharded
# step (c), all parameters taken together: ||g - g_ref|| / ||g_ref|| and
# ||g|| / ||g_ref||. The collectives and the halo's backward are held in
# float64 activations on F.conv3d (``f64_config``; params, head and loss
# stay f32, as everywhere in the port), where the two sides differ by
# summation order only: step 1's gradient distance, loss and BatchNorm
# statistics within PAR_F64_TOL. Not in f32: there that order flips ReLU
# gates, and the ranks' gradients lay 9.3e-3 from one process's (ROADMAP
# Queue C item 4 holds the whole-step tests in float64 for the same
# reason); and not after step 1: the f32 params' rounding is amplified the
# same way by the steps after it ((b)'s state after 3 steps is printed). In bf16 (kernels='cuda') the rounding is a large
# part of this network's gradient at a random init (phase 5: 0.86 from
# f32): the bf16 pair, run for the kernels' launches, is held to a distance
# under PAR_BF16_DIST (a zero gradient lies at 1) and a norm ratio within
# PAR_BF16_NORM (a halved or doubled gradient lies at 0.5 or 2). Each limit
# is shown to reject a zeroed, a halved and a doubled gradient before it is
# applied.
PAR_F64_TOL = 1e-5
PAR_BF16_DIST, PAR_BF16_NORM = 0.9, 1.25
_ROOT = os.path.dirname(os.path.abspath(__file__))


def f64_config(cfg):
    """``cfg`` with float64 activations on F.conv3d (kernels='torch')."""
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, kernels="torch", compute_dtype="float64"))


@contextlib.contextmanager
def cli_train_run(run: str, times: list, counts: list, first: dict):
    """Inside, ``cli.train``'s steps are timed (``timed_steps``) and, for run
    'f64', its config goes through ``f64_config`` (the CLI offers bfloat16
    and float32 only)."""
    make, build = fit_module.make_train_step, cli_train.build_config
    fit_module.make_train_step = timed_steps(make, times, counts, first)
    if run == "f64":
        cli_train.build_config = lambda args: f64_config(build(args))
    try:
        yield
    finally:
        fit_module.make_train_step, cli_train.build_config = make, build


def timed_steps(make, times: list, counts: list, first: dict | None = None):
    """``make`` (a train-step factory) wrapped so that every step it builds
    is timed by CUDA events (into ``times``) and has its launches counted
    from 0 (into ``counts``); the first step's loss, the gradients it
    applies and the BatchNorm statistics it leaves (f32, on the host) go
    into ``first`` ("loss", "grads", "buffers") when one is given. Phase
    13's ranks import it too."""
    def build(*a, **kw):
        step = make(*a, **kw)

        def run(state, *sa, **skw):
            keep = first is not None and not times
            if keep:
                apply = state.apply_gradients

                def capture():
                    m = state.model
                    first["grads"] = {n: p.grad.detach().float().cpu()
                                      for n, p in m.named_parameters()}
                    first["buffers"] = {n: b.detach().float().cpu()
                                        for n, b in m.named_buffers() if b.is_floating_point()}
                    apply()
                state.apply_gradients = capture
            ops.reset_launch_counts()
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            try:
                res = step(state, *sa, **skw)
            finally:
                if keep:
                    state.apply_gradients = apply
            e.record()
            e.synchronize()
            if keep:
                first["loss"] = float(res[1]["loss"])
            times.append(s.elapsed_time(e))
            counts.append(dict(ops.launch_counts))
            return res
        return run
    return build


# (d): the slowfast_stretch preset's model at its published widths
# (base_width 64, stage_blocks (1, 1, 1, 1), 400 classes) on its 32x224x224
# clips, data 1 x model 2 over the two processes, against the unsharded step
TP_PRESET = "slowfast_stretch"
TP_BATCH, TP_STEPS = 4, 2
TP_CLI_VIDEOS, TP_CLI_FRAMES = 4, 64  # (d)'s cli.train: one step of 4 clips of 32 at stride 2
TP_SEED = SEED + 23


def tp_config(run: str) -> ExperimentConfig:
    """(d)'s config: the preset at B = TP_BATCH, in bf16 or (``f64_config``)
    float64 activations."""
    cfg = PRESETS[TP_PRESET]
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=TP_BATCH))
    return cfg if run == "bf16" else f64_config(cfg)


def tp_steps(spec: dict, run: str, mesh=None) -> tuple[dict, dict]:
    """TP_STEPS train steps of (d)'s model from ``spec``'s seed and batch
    (step 1 alone in f64), channel-sharded over ``mesh``'s model group or
    unsharded without one: per step the ms by CUDA events, the loss and the
    channel collectives' counts and bytes; the peak memory and the conv
    kernels' bytes on this process; and step 1's loss, whole gradients
    (gathered over the model group) and BatchNorm statistics, on the host.
    Phase 13's ranks import it too."""
    from fastvideotagging_tpu_torch.parallel import channel, shard_train_state
    from fastvideotagging_tpu_torch.parallel.mesh import param_partition_specs
    from fastvideotagging_tpu_torch.train.fit import dropout_generator

    cfg = tp_config(run)
    kw = {} if mesh is None else {"shard_axis": mesh.model_group}
    model = model_from_config(cfg.model, device=DEV,
                              generator=torch.Generator().manual_seed(spec["seed"]), **kw)
    state = create_train_state(cfg, 10, device=DEV, model=model)
    if mesh is not None:
        shard_train_state(state, mesh)
    specs = param_partition_specs(model)
    step = make_train_step(model, cfg, mesh=mesh)
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in spec["batches"][run].items()}
    first, apply = {}, state.apply_gradients

    def capture():
        grads = {}
        for n, p in model.named_parameters():
            g = p.grad.detach()
            if specs[n] is not None:
                g = channel.gather_along(g, specs[n], mesh.model_group)
            grads[n] = g.float().cpu()
        first["grads"] = grads
        first["buffers"] = {n: b.detach().float().cpu() for n, b in model.named_buffers()
                            if b.is_floating_point()}
        apply()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = dict(ms=[], losses=[], collectives=[],
               kernel_bytes=sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                                if n.endswith(".kernel")))
    for i in range(TP_STEPS if run == "bf16" else 1):
        state.apply_gradients = capture if i == 0 else apply
        channel.reset_channel_counts()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        state, metrics = step(state, batch, dropout_generator(spec["seed"], i, torch.device(DEV)))
        e.record()
        e.synchronize()
        res["ms"].append(s.elapsed_time(e))
        res["losses"].append(float(metrics["loss"]))
        res["collectives"].append(dict(channel.channel_counts))
    state.apply_gradients = apply
    first["loss"] = res["losses"][0]
    res["peak_bytes"] = torch.cuda.max_memory_allocated()
    del state, step, model, batch
    return res, first


# The script each rank of (b), (c) and (d) runs, from the checkout's root:
# ``python3 -c _PAR_RANK role rank world port,port tmp``. It writes its
# results to tmp/par_<role><rank>.json (and tensors to .pt files beside it).
_PAR_RANK = r"""
import functools, json, os, sys
import torch
from chip_smoke import cli_train, cli_train_run, timed_steps
from fastvideotagging_tpu_torch.parallel import temporal as tp
role, rank, world, tmp = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[5]
ports = [int(p) for p in sys.argv[4].split(",")]
out = {}
if role == "cli":
    with open(os.path.join(tmp, "par_argv.json")) as f:
        argv = json.load(f)
    for run, port in (("bf16", ports[0]), ("f64", ports[1])):
        ms, launches, first = [], [], {}
        with cli_train_run(run, ms, launches, first):
            state = cli_train.main(argv + [
                "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
                "--process-id", str(rank), "--dist-backend", "gloo",
                "--dist-timeout", "%(group)d"])
        cli_train.finish_multihost()  # as ``python -m ...cli.train`` ends
        out[run] = dict(ms=ms, launches=launches, first_loss=first["loss"], step=state.step,
                        device=str(next(state.model.parameters()).device))
        torch.save({k: v.cpu() for k, v in state.model.state_dict().items()},
                   os.path.join(tmp, f"par_cli_{run}{rank}.pt"))
        torch.save(first, os.path.join(tmp, f"par_cli_first_{run}{rank}.pt"))
        del state
        torch.cuda.empty_cache()
elif role == "tp":  # (d): the slowfast_stretch model channel-sharded, data 1 x model 2
    from chip_smoke import tp_steps
    from fastvideotagging_tpu_torch.parallel import init_multihost, make_mesh
    init_multihost(f"127.0.0.1:{ports[0]}", world, rank, backend="gloo", timeout=%(group)d)
    mesh = make_mesh(1, world)
    spec = torch.load(os.path.join(tmp, "tp_spec.pt"), weights_only=False)
    for run in ("bf16", "f64"):
        out[run], first = tp_steps(spec, run, mesh)
        out[run]["device"] = str(mesh.device)
        torch.save(first, os.path.join(tmp, f"tp_first_{run}{rank}.pt"))
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
elif role == "tpcli":  # (d): cli.train --preset slowfast_stretch over the ranks
    from fastvideotagging_tpu_torch.parallel.mesh import param_partition_specs
    with open(os.path.join(tmp, "tp_argv.json")) as f:
        argv = json.load(f)
    state = cli_train.main(argv + [
        "--coordinator", f"127.0.0.1:{ports[0]}", "--num-processes", str(world),
        "--process-id", str(rank), "--dist-backend", "gloo", "--dist-timeout", "%(group)d"])
    specs = param_partition_specs(state.model)
    out["cli"] = dict(step=state.step, device=str(next(state.model.parameters()).device),
                      kernel_bytes=sum(p.numel() * p.element_size()
                                       for n, p in state.model.named_parameters()
                                       if specs[n] is not None))
    cli_train.finish_multihost()
else:  # "long": score_long_clip and one time-sharded train step in bf16 and in f64
    from fastvideotagging_tpu_torch import get_model
    from fastvideotagging_tpu_torch.evaluation.long_clip import make_time_mesh, score_long_clip
    from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
    from fastvideotagging_tpu_torch.parallel import init_multihost
    from fastvideotagging_tpu_torch.train.state import create_train_state
    from fastvideotagging_tpu_torch.train.time_sharded import make_time_sharded_train_step
    init_multihost(f"127.0.0.1:{ports[0]}", world, rank, backend="gloo", timeout=%(group)d)
    mesh = make_time_mesh(world)
    spec = torch.load(os.path.join(tmp, "long_spec.pt"), weights_only=False)
    factory = functools.partial(get_model, "r2plus1d_18", num_classes=spec["classes"],
                                device=mesh.device, dropout=0.0)
    score_long_clip(factory, spec["weights"], spec["clips"], mesh, multilabel=True)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tp.reset_halo_counts()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    scores = score_long_clip(factory, spec["weights"], spec["clips"], mesh, multilabel=True)
    e.record()
    e.synchronize()
    out["forward"] = dict(ms=s.elapsed_time(e), peak_bytes=torch.cuda.max_memory_allocated(),
                          launches=dict(ops.launch_counts), halo=dict(tp.halo_counts),
                          device=str(mesh.device))
    out["scores"] = scores.float().cpu().tolist()
    del scores
    # the sharded forward alone, on a model built once (score_long_clip
    # builds its model and loads the weights at every call)
    model = factory(time_axis=mesh.group).eval()
    model.load_state_dict(spec["weights"])
    xl = tp.time_shard(spec["clips"], mesh.group).to(mesh.device)
    ms = []
    with torch.inference_mode():
        for _ in range(3):
            s.record()
            pooled = model(xl, features_only=True).float().sum(dim=(1, 2, 3))
            torch.distributed.all_reduce(pooled, group=mesh.group)
            e.record()
            e.synchronize()
            ms.append(s.elapsed_time(e))
    out["forward"]["model_forward_ms"] = ms
    del model, xl, pooled
    torch.cuda.empty_cache()
    for run, kw in (("bf16", {}), ("f64", dict(backend="torch", dtype=torch.float64))):
        cfg = spec["cfgs"][run]
        step, model = make_time_sharded_train_step(functools.partial(factory, **kw), cfg, mesh)
        model.load_state_dict(spec["weights"])
        state = create_train_state(cfg, 10, device=mesh.device, model=model)
        times, counts, first = [], [], {}
        torch.cuda.reset_peak_memory_stats()
        tp.reset_halo_counts()
        timed_steps(lambda: step, times, counts, first)()(state, spec["batch"])
        out["train_" + run] = dict(ms=times[0], launches=counts[0], halo=dict(tp.halo_counts),
                                   loss=first["loss"],
                                   peak_bytes=torch.cuda.max_memory_allocated())
        torch.save(first, os.path.join(tmp, f"par_first_{run}{rank}.pt"))
        del step, model, state, first
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
with open(os.path.join(tmp, f"par_{role}{rank}.json"), "w") as f:
    json.dump(out, f)
""" % {"group": PAR_GROUP_TIMEOUT}


def _free_ports(n: int) -> list[int]:
    """``n`` distinct free ports on the loopback (held together while
    picked)."""
    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(n)]
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]


def _run_ranks(role: str, tmp: str) -> list:
    """PAR_RANKS processes of ``_PAR_RANK`` on the card, all under one
    deadline; the first that fails (or the deadline) kills the others and
    fails the run. Returns each rank's results."""
    ports = ",".join(map(str, _free_ports(2)))
    logs = [os.path.join(tmp, f"par_{role}{r}.log") for r in range(PAR_RANKS)]
    procs = []
    for r in range(PAR_RANKS):
        with open(logs[r], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _PAR_RANK, role, str(r), str(PAR_RANKS), ports, tmp],
                cwd=_ROOT, stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PAR_TIMEOUT
    try:
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                r = bad[0] if bad else 0
                with open(logs[r]) as f:
                    tail = f.read()[-6000:]
                raise SystemExit(f"phase 13 {role}: rank {r} "
                                 f"{'exited ' + str(codes[r]) if bad else 'timed out'}:\n{tail}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    results = []
    for r in range(PAR_RANKS):
        with open(os.path.join(tmp, f"par_{role}{r}.json")) as f:
            results.append(json.load(f))
    return results


def _sum_counts(rows) -> dict:
    return {k: sum(r.get(k, 0) for r in rows) for k in KERNELS}


def _grad_distance(a: dict, ref: dict) -> float:
    num = sum((a[k].float() - ref[k]).pow(2).sum().item() for k in ref)
    return (num / sum(ref[k].pow(2).sum().item() for k in ref)) ** 0.5


def _grad_check(g: dict, ref: dict, dist_limit: float, norm_limit: float) -> tuple:
    """``(distance, norm ratio, held)``: ||g - ref|| / ||ref|| within
    ``dist_limit`` and ||g|| / ||ref|| within [1 / norm_limit, norm_limit]."""
    d = _grad_distance(g, ref)
    ratio = (sum(g[k].float().pow(2).sum().item() for k in ref)
             / sum(ref[k].pow(2).sum().item() for k in ref)) ** 0.5
    return d, ratio, d <= dist_limit and 1 / norm_limit <= ratio <= norm_limit


def _limit_rejects(ref: dict, dist_limit: float, norm_limit: float, what: str) -> str:
    """Fail unless the limit rejects ``ref`` zeroed, halved and doubled (a
    lost gradient, one not averaged or averaged twice); returns a note of
    what each gave."""
    notes = []
    for name, scale in (("zeroed", 0.0), ("halved", 0.5), ("doubled", 2.0)):
        d, ratio, held = _grad_check({k: v * scale for k, v in ref.items()}, ref,
                                     dist_limit, norm_limit)
        if held:
            raise SystemExit(f"{what}: the limit passes a {name} gradient")
        notes.append(f"{name} {d:.3f} / {ratio:.3f}")
    return ", ".join(notes)


def _state_err(a: dict, ref: dict) -> float:
    """The largest max|a - ref| / max|ref| over the float tensors of ``a``
    (a state_dict, or part of one) and their namesakes in ``ref``."""
    return max((a[k].float() - ref[k].float()).abs().max().item()
               / max(ref[k].float().abs().max().item(), 1e-30)
               for k in a if a[k].is_floating_point())


def _limits_note(run: str) -> str:
    if run == "bf16":
        return f"distance <= {PAR_BF16_DIST}, ratio within 1/{PAR_BF16_NORM}..{PAR_BF16_NORM}"
    return f"distance <= {PAR_F64_TOL}, ratio within 1 -/+ {PAR_F64_TOL}"


def phase_parallel(card: str, tmp: str) -> dict:
    """(a) the data-parallel step on an NCCL group of world size 1 against
    the plain step, bit for bit; (b) cli.train as 2 processes on the card
    over gloo against one process, in bf16 and in f64; (c) score_long_clip
    and the time-sharded train step over 2 processes against the unsharded
    forward and step, the step in bf16 and in f64."""
    print("== phase 13: parallelism", flush=True)
    import torch.distributed as dist

    from fastvideotagging_tpu_torch.evaluation.long_clip import TOTAL_STRIDE
    from fastvideotagging_tpu_torch.parallel import init_multihost, make_mesh
    from fastvideotagging_tpu_torch.train.fit import dropout_generator

    t_phase = time.perf_counter()
    result, launches = {}, {}
    cfg = PRESETS["r2plus1d18_ucf101"]
    # (a) NCCL at world size 1: the step with the group's collectives against
    # the step without a group, from the same weights, batch and masks
    backend = init_multihost(f"127.0.0.1:{_free_ports(1)[0]}", 1, 0,
                             timeout=PAR_GROUP_TIMEOUT)
    mesh = make_mesh()
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in _train_batch(cfg).items()}
    runs = {}
    try:
        for form in ("plain", "data_parallel"):
            state = create_train_state(cfg, steps_per_epoch=100, device=DEV,
                                       generator=torch.Generator().manual_seed(SEED))
            step = make_train_step(state.model, cfg,
                                   mesh=mesh if form == "data_parallel" else None)
            losses, counts, ms = [], [], []
            for i in range(PAR_STEPS):
                ops.reset_launch_counts()
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
                state, metrics = step(state, batch, dropout_generator(SEED, i, mesh.device))
                e.record()
                e.synchronize()
                ms.append(s.elapsed_time(e))
                counts.append(dict(ops.launch_counts))
                losses.append(metrics["loss"].clone())
            runs[form] = (losses, {k: v.clone() for k, v in state.model.state_dict().items()},
                          counts, ms)
            del state, step
    finally:
        dist.destroy_process_group()
    (lp, sp, _, msp), (ld, sd, cd, msd) = runs["plain"], runs["data_parallel"]
    bitwise = (all(torch.equal(a, b) for a, b in zip(lp, ld))
               and all(torch.equal(sp[k], sd[k]) for k in sp))
    launches["world1"] = _sum_counts(cd)
    print(f"(a) {backend} group of world size {mesh.world} on {mesh.device}: {PAR_STEPS} "
          f"data-parallel steps of the r2plus1d18_ucf101 preset (B={cfg.train.batch_size}, "
          f"bf16, kernels='cuda') against the plain step: losses "
          f"{[float(x) for x in ld]}; loss, weights and BN statistics bitwise equal: "
          f"{bitwise}; launches a step {cd}; ms a step {['%.2f' % x for x in msd]} against "
          f"{['%.2f' % x for x in msp]} (CUDA events, {card})", flush=True)
    if not bitwise:
        raise SystemExit("(a) the data-parallel step at world size 1 is not the plain step")
    if any(c != TRAIN_STEP_LAUNCHES for c in cd):
        raise SystemExit(f"(a) launches {cd} != {TRAIN_STEP_LAUNCHES} a step")
    result["a"] = dict(backend=backend, world=mesh.world, bitwise=bitwise,
                       losses=[float(x) for x in ld], launches_per_step=cd[0],
                       ms_per_step=msd, plain_ms_per_step=msp)
    del runs, batch, sp, sd
    torch.cuda.empty_cache()

    # (b) cli.train as PAR_RANKS processes sharing the card over gloo, one
    # epoch of 3 steps at global B = 16, against one process on the same
    # pack; each in bf16 on the kernels and in f64 on F.conv3d, with the
    # same batches and dropout masks
    pack = os.path.join(tmp, "par.fvtpack")
    write_pack_from_arrays(_fit_items(PAR_CLI_VIDEOS, SEED + 500), pack, (128, 171))
    argv = ["--preset", "r2plus1d18_ucf101", "--train-list", pack, "--batch-size",
            str(PAR_CLI_BATCH), "--epochs", "1", "--checkpoint-dir", "", "--log-every", "1"]
    with open(os.path.join(tmp, "par_argv.json"), "w") as f:
        json.dump(argv, f)
    t0 = time.perf_counter()
    ranks = _run_ranks("cli", tmp)
    ranks_s = time.perf_counter() - t0
    one = {}
    for run in ("bf16", "f64"):
        ms, counts, first = [], [], {}
        with cli_train_run(run, ms, counts, first):
            state = cli_train.main(argv)
        one[run] = dict(ms=ms, counts=counts, **first,
                        state={k: v.detach().cpu() for k, v in state.model.state_dict().items()})
        del state
        torch.cuda.empty_cache()
    chk, same = {}, {}
    for run in ("bf16", "f64"):
        wr = [torch.load(os.path.join(tmp, f"par_cli_{run}{r}.pt")) for r in range(PAR_RANKS)]
        same[run] = all(torch.equal(wr[0][k], wr[r][k])
                        for r in range(1, PAR_RANKS) for k in wr[0])
        first = torch.load(os.path.join(tmp, f"par_cli_first_{run}0.pt"))
        g = first["grads"]
        limits = (PAR_BF16_DIST, PAR_BF16_NORM) if run == "bf16" else (PAR_F64_TOL,
                                                                       1 + PAR_F64_TOL)
        d, ratio, held = _grad_check(g, one[run]["grads"], *limits)
        stats = [k for k in wr[0] if k.endswith((".mean", ".var"))]
        chk[run] = dict(
            loss_err=abs(ranks[0][run]["first_loss"] - one[run]["loss"]) / abs(one[run]["loss"]),
            grad_dist=d, norm_ratio=ratio, held=held,
            rejects=_limit_rejects(one[run]["grads"], *limits, f"(b) {run}"),
            to_f64=_grad_distance(g, one["f64"]["grads"]),
            one_to_f64=_grad_distance(one[run]["grads"], one["f64"]["grads"]),
            bn1_err=_state_err(first["buffers"], one[run]["buffers"]),
            bn_err=_state_err({k: wr[0][k] for k in stats}, one[run]["state"]),
            state_err=_state_err(wr[0], one[run]["state"]))
        del wr, g, first
    launches["cli"] = _sum_counts([c for r in ranks for c in r["bf16"]["launches"]])
    for r, res in enumerate(ranks):
        print(f"(b) rank {r} of {PAR_RANKS} on {res['bf16']['device']} (gloo): "
              f"{res['bf16']['step']} steps of {PAR_CLI_BATCH // PAR_RANKS} rows; launches a "
              f"step {res['bf16']['launches']}; ms a step "
              f"{['%.2f' % x for x in res['bf16']['ms']]}, f64 on F.conv3d "
              f"{['%.2f' % x for x in res['f64']['ms']]} (CUDA events, {card})")
    print(f"(b) one process on the global batch B={PAR_CLI_BATCH}: ms a step "
          f"{['%.2f' % x for x in one['bf16']['ms']]}; launches a step {one['bf16']['counts']}; "
          f"f64 on F.conv3d {['%.2f' % x for x in one['f64']['ms']]}; the ranks' two jobs took "
          f"{ranks_s:.1f} s of wall time with their processes' start")
    for run, c in chk.items():
        tol = PATH_TOL if run == "bf16" else PAR_F64_TOL
        print(f"(b) {run}: ranks' weights and BN statistics equal: {same[run]}; step 1 against "
              f"one process: loss rel diff {c['loss_err']:.3e} (tol {tol}), gradients "
              f"||g - g_one|| / ||g_one|| {c['grad_dist']:.3e}, ||g|| / ||g_one|| "
              f"{c['norm_ratio']:.4f} (limits {_limits_note(run)}; the limits give a "
              f"{c['rejects']}); max diff / max|value| of the BN statistics after step 1 "
              f"{c['bn1_err']:.3e}" + (f" (tol {tol})" if run == "f64" else "")
              + f"; after 3 steps (not held) the BN statistics {c['bn_err']:.3e}, the whole "
              f"state {c['state_err']:.3e}; ||g - g_f64one|| / ||g_f64one||: ranks {c['to_f64']:.3e}, one process "
              f"{c['one_to_f64']:.3e}", flush=True)
    if not all(same.values()):
        raise SystemExit(f"(b) the ranks' weights differ: {same}")
    if not (chk["bf16"]["loss_err"] <= PATH_TOL and chk["bf16"]["held"]):
        raise SystemExit("(b) the ranks' bf16 step 1 is not within its limits of one process")
    c64 = chk["f64"]
    if not (c64["loss_err"] <= PAR_F64_TOL and c64["held"] and c64["bn1_err"] <= PAR_F64_TOL):
        raise SystemExit("(b) the ranks' f64 run is not within PAR_F64_TOL of one process")
    for res in ranks:
        if any(res[run]["step"] != PAR_CLI_VIDEOS // PAR_CLI_BATCH for run in res) or not all(
                c["spatial_conv"] and c["temporal_conv"] and c["temporal_dw"]
                for c in res["bf16"]["launches"]):
            raise SystemExit(f"(b) a rank missed steps or kernels: {res}")
    result["b"] = dict(ranks=[dict(ms_per_step=r["bf16"]["ms"],
                                   f64_ms_per_step=r["f64"]["ms"],
                                   launches_per_step=r["bf16"]["launches"][0]) for r in ranks],
                       one_process_ms_per_step=one["bf16"]["ms"],
                       one_process_f64_ms_per_step=one["f64"]["ms"],
                       checks={run: {k: v for k, v in c.items() if k != "held"}
                               for run, c in chk.items()},
                       job_wall_s=ranks_s)
    del one
    torch.cuda.empty_cache()

    # (c) long clips at full width: score_long_clip (400 sigmoid scores, as
    # phase 4's Tagger) and the time-sharded train step (softmax over the
    # same 400 logits) over PAR_RANKS processes against the unsharded ones,
    # the step in bf16 on the kernels and in f64 on F.conv3d
    lcfg = dataclasses.replace(
        _cfg("cuda"), model=dataclasses.replace(_cfg("cuda").model, dropout=0.0,
                                                multilabel=False),
        data=dataclasses.replace(_cfg("cuda").data,
                                 sampler=ClipSamplerConfig(clip_len=LONG_T)),
        train=dataclasses.replace(cfg.train, batch_size=LONG_B))
    lcfgs = {"bf16": lcfg, "f64": f64_config(lcfg)}
    host = _train_batch(lcfg)
    lbatch = {k: torch.as_tensor(v).to(DEV) for k, v in host.items()}
    d = lcfg.data
    centre = [(d.resize_hw[0] - d.crop_hw[0]) // 2] * LONG_B, \
        [(d.resize_hw[1] - d.crop_hw[1]) // 2] * LONG_B
    clips = preprocess_batch(lbatch["frames"], torch.tensor(centre[0], device=DEV),
                             torch.tensor(centre[1], device=DEV),
                             torch.zeros(LONG_B, dtype=torch.bool, device=DEV), d.mean, d.std,
                             resize_hw=d.resize_hw, crop_hw=d.crop_hw, out_dtype=torch.bfloat16)
    model = model_from_config(lcfg.model, device=DEV,
                              generator=torch.Generator().manual_seed(SEED + 7))
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    torch.save(dict(weights=weights, clips=clips.cpu(), cfgs=lcfgs, batch=host,
                    classes=lcfg.model.num_classes), os.path.join(tmp, "long_spec.pt"))
    model.eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ops.reset_launch_counts()
    with torch.inference_mode():
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        fwd_ms = []
        for _ in range(3):
            s.record()
            ref_scores = heads.predict_scores(model(clips), True).float()
            e.record()
            e.synchronize()
            fwd_ms.append(s.elapsed_time(e))
    unsharded = dict(ms=fwd_ms, peak_bytes=torch.cuda.max_memory_allocated(),
                     activation_peak_bytes=torch.cuda.max_memory_allocated() - base_mem,
                     launches={k: v // 3 for k, v in ops.launch_counts.items()})
    # the unsharded step in bf16 on the kernels and in f64 on F.conv3d
    ref = {}
    for run, rcfg in lcfgs.items():
        state = create_train_state(rcfg, steps_per_epoch=10, device=DEV,
                                   model=model_from_config(rcfg.model, device=DEV))
        state.model.load_state_dict(weights)
        torch.cuda.reset_peak_memory_stats()
        times, counts, first = [], [], {}
        timed_steps(lambda: make_train_step(state.model, rcfg), times, counts, first)()(
            state, lbatch)
        ref[run] = dict(first, ms=times[0], peak_bytes=torch.cuda.max_memory_allocated())
        del state
        torch.cuda.empty_cache()
    del model, clips, lbatch
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks("long", tmp)
    ranks_s = time.perf_counter() - t0
    chk = {}
    for run in ("bf16", "f64"):
        firsts = [torch.load(os.path.join(tmp, f"par_first_{run}{r}.pt"))
                  for r in range(PAR_RANKS)]
        grads = [f["grads"] for f in firsts]
        limits = (PAR_BF16_DIST, PAR_BF16_NORM) if run == "bf16" else (PAR_F64_TOL,
                                                                       1 + PAR_F64_TOL)
        dist_, ratio, held = _grad_check(grads[0], ref[run]["grads"], *limits)
        chk[run] = dict(
            same=all(torch.equal(grads[0][k], grads[r][k]) for r in range(1, PAR_RANKS)
                     for k in grads[0]),
            finite=all(torch.isfinite(g).all().item() for g in grads[0].values()),
            loss_err=max(abs(r["train_" + run]["loss"] - ref[run]["loss"]) / abs(ref[run]["loss"])
                         for r in ranks),
            grad_dist=dist_, norm_ratio=ratio, held=held,
            bn1_err=_state_err(firsts[0]["buffers"], ref[run]["buffers"]),
            rejects=_limit_rejects(ref[run]["grads"], *limits, f"(c) {run}"),
            to_f64=_grad_distance(grads[0], ref["f64"]["grads"]),
            unsharded_to_f64=_grad_distance(ref[run]["grads"], ref["f64"]["grads"]))
        del grads, firsts
    score_err = max((torch.tensor(r["scores"]) - ref_scores.cpu()).abs().max().item()
                    for r in ranks)
    launches["long_clip"] = _sum_counts(
        [r["forward"]["launches"] for r in ranks] + [r["train_bf16"]["launches"] for r in ranks])
    t_local = LONG_T // PAR_RANKS
    extra = {f"T_local={t}": 2 / t for t in (t_local, t_local // 2, t_local // 4,
                                              t_local // TOTAL_STRIDE)}
    print(f"(c) unsharded forward of {LONG_B} x {LONG_T}x112x112 clips (r2plus1d_18, "
          f"{lcfg.model.num_classes} classes, bf16, kernels='cuda'): "
          f"{['%.2f' % x for x in unsharded['ms']]} ms, "
          f"peak {unsharded['peak_bytes'] / 1e9:.3f} GB (of it activations "
          f"{unsharded['activation_peak_bytes'] / 1e9:.3f} GB); launches {unsharded['launches']} "
          f"on {card}")
    for r, res in enumerate(ranks):
        fw, tr, t64 = res["forward"], res["train_bf16"], res["train_f64"]
        print(f"(c) rank {r} on {fw['device']} (gloo, {t_local} frames): score_long_clip "
              f"{fw['ms']:.2f} ms (its model built and loaded in the call), the sharded "
              f"forward alone {['%.2f' % x for x in fw['model_forward_ms']]} ms, peak "
              f"{fw['peak_bytes'] / 1e9:.3f} GB, launches "
              f"{fw['launches']}, K2 over halo'd slabs {fw['halo']['k2_slabs']}, halo "
              f"exchanges {fw['halo']['exchanges_fwd']} sending {fw['halo']['bytes_fwd']} bytes "
              f"a forward; time-sharded step {tr['ms']:.2f} ms, peak "
              f"{tr['peak_bytes'] / 1e9:.3f} GB, launches {tr['launches']}, halo bytes sent "
              f"{tr['halo']['bytes_fwd']} forward + {tr['halo']['bytes_bwd']} backward, loss "
              f"{tr['loss']:.5f}; f64 step {t64['ms']:.2f} ms, peak "
              f"{t64['peak_bytes'] / 1e9:.3f} GB (CUDA events, {card})")
    print(f"(c) unsharded step: bf16 {ref['bf16']['ms']:.2f} ms (its first), peak "
          f"{ref['bf16']['peak_bytes'] / 1e9:.3f} GB; f64 {ref['f64']['ms']:.2f} ms, peak "
          f"{ref['f64']['peak_bytes'] / 1e9:.3f} GB; K2's extra frames over the halo'd slab "
          f"2p/T_local (k = 3): " + ", ".join(f"{k} {v:.1%}" for k, v in extra.items()))
    print(f"(c) scores max abs diff against the unsharded forward {score_err:.3e} (tol "
          f"{PATH_TOL}); the job took {ranks_s:.1f} s of wall time with its processes' start",
          flush=True)
    for run, c in chk.items():
        tol = PATH_TOL if run == "bf16" else PAR_F64_TOL
        print(f"(c) time-sharded step, {run}, against the unsharded: loss rel diff "
              f"{c['loss_err']:.3e} (tol {tol}); ranks' gradients equal {c['same']}, finite "
              f"{c['finite']}; ||g - g_ref|| / ||g_ref|| {c['grad_dist']:.3e}, ||g|| / ||g_ref|| "
              f"{c['norm_ratio']:.4f} (limits {_limits_note(run)}; the limits give a "
              f"{c['rejects']}); BN statistics after the step max diff / max|value| "
              f"{c['bn1_err']:.3e}" + (f" (tol {tol})" if run == "f64" else "")
              + f"; ||g - g_f64|| / ||g_f64||: time-sharded {c['to_f64']:.3e}, "
              f"unsharded {c['unsharded_to_f64']:.3e}", flush=True)
    if score_err > PATH_TOL:
        raise SystemExit("(c) the time-sharded forward disagrees with the unsharded")
    for run, c in chk.items():
        tol = PATH_TOL if run == "bf16" else PAR_F64_TOL
        if not (c["loss_err"] <= tol and c["same"] and c["finite"] and c["held"]
                and (run == "bf16" or c["bn1_err"] <= PAR_F64_TOL)):
            raise SystemExit(f"(c) the {run} time-sharded step disagrees with the unsharded")
    for res in ranks:
        fw, tr = res["forward"]["launches"], res["train_bf16"]["launches"]
        if not (fw["spatial_conv"] and fw["temporal_conv"] and tr["spatial_conv"]
                and tr["temporal_conv"] and tr["temporal_dw"]):
            raise SystemExit(f"(c) a rank missed a kernel: {res}")
        if res["forward"]["halo"]["k2_slabs"] == 0:
            raise SystemExit("(c) no halo'd slab went to K2")
    result["c"] = dict(
        unsharded=unsharded, ranks=[{k: r[k] for k in ("forward", "train_bf16", "train_f64")}
                                    for r in ranks],
        score_err=score_err, checks={run: {k: v for k, v in c.items() if k != "held"}
                                     for run, c in chk.items()},
        unsharded_step={run: {k: ref[run][k] for k in ("loss", "ms", "peak_bytes")}
                        for run in ref},
        k2_extra_frames=extra)
    result["d"] = phase_channel(card, tmp)
    print(f"phase 13 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(result=result, launches=launches)


def _kernel_bytes_note(bytes_: int, whole: int) -> str:
    return f"{bytes_ / 1e6:.3f} MB of conv kernels ({bytes_ / whole:.3f} of the unsharded)"


def phase_channel(card: str, tmp: str) -> dict:
    """(d) channel sharding: the slowfast_stretch preset's model at its
    published widths on 32x224x224 clips, data 1 x model 2 over two
    processes sharing the card over gloo, against the unsharded step in one
    process, in bf16 and in f64; then ``cli.train --preset
    slowfast_stretch`` over the two processes for one step with a
    checkpoint, and ``cli.evaluate --preset slowfast_stretch`` on it in
    this process (unsharded, with the warning)."""
    from fastvideotagging_tpu_torch.parallel.channel import reset_channel_counts

    spec = dict(seed=TP_SEED, batches={run: _train_batch(tp_config(run))
                                       for run in ("bf16", "f64")})
    torch.save(spec, os.path.join(tmp, "tp_spec.pt"))
    reset_channel_counts()
    ref = {}
    for run in ("bf16", "f64"):
        ref[run] = tp_steps(spec, run)
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = _run_ranks("tp", tmp)
    ranks_s = time.perf_counter() - t0
    d = tp_config("bf16").data
    shape = f"{TP_BATCH} x {d.sampler.clip_len}x{d.crop_hw[0]}x{d.crop_hw[1]}"
    whole = ref["bf16"][0]["kernel_bytes"]
    chk = {}
    for run in ("bf16", "f64"):
        res, first = ref[run]
        firsts = [torch.load(os.path.join(tmp, f"tp_first_{run}{r}.pt")) for r in range(PAR_RANKS)]
        limits = (PAR_BF16_DIST, PAR_BF16_NORM) if run == "bf16" else (PAR_F64_TOL,
                                                                       1 + PAR_F64_TOL)
        dist_, ratio, held = _grad_check(firsts[0]["grads"], first["grads"], *limits)
        chk[run] = dict(
            same=all(torch.equal(firsts[0]["grads"][k], f["grads"][k])
                     for f in firsts[1:] for k in first["grads"]),
            finite=all(torch.isfinite(g).all().item() for g in firsts[0]["grads"].values()),
            loss_err=max(abs(r[run]["losses"][0] - first["loss"]) / abs(first["loss"])
                         for r in ranks),
            grad_dist=dist_, norm_ratio=ratio, held=held,
            bn1_err=_state_err(firsts[0]["buffers"], first["buffers"]),
            rejects=_limit_rejects(first["grads"], *limits, f"(d) {run}"),
            to_f64=_grad_distance(firsts[0]["grads"], ref["f64"][1]["grads"]),
            unsharded_to_f64=_grad_distance(first["grads"], ref["f64"][1]["grads"]))
        del firsts
    for run in ("bf16", "f64"):
        res = ref[run][0]
        print(f"(d) unsharded {TP_PRESET} step ({shape}, {run}): ms a step "
              f"{['%.2f' % x for x in res['ms']]}, losses {res['losses']}, peak "
              f"{res['peak_bytes'] / 1e9:.3f} GB, {whole / 1e6:.3f} MB of conv kernels "
              f"(CUDA events, {card})")
    for r, res in enumerate(ranks):
        for run in ("bf16", "f64"):
            c = res[run]["collectives"][0]
            print(f"(d) rank {r} of {PAR_RANKS} on {res[run]['device']} (gloo, model index {r}), "
                  f"{run}: {_kernel_bytes_note(res[run]['kernel_bytes'], whole)}; peak "
                  f"{res[run]['peak_bytes'] / 1e9:.3f} GB; ms a step "
                  f"{['%.2f' % x for x in res[run]['ms']]} against the unsharded "
                  f"{['%.2f' % x for x in ref[run][0]['ms']]}; a step all-gathers "
                  f"{c['gather_bytes'] / 1e6:.1f} MB in {c['gathers']} calls and all-reduces "
                  f"{c['reduce_bytes'] / 1e6:.1f} MB of dx in {c['reduces']} calls; losses "
                  f"{res[run]['losses']} (CUDA events, {card})")
    for run, c in chk.items():
        tol = PATH_TOL if run == "bf16" else PAR_F64_TOL
        print(f"(d) {run}, step 1 over the ranks against the unsharded: loss rel diff "
              f"{c['loss_err']:.3e} (tol {tol}); ranks' gathered gradients equal {c['same']}, "
              f"finite {c['finite']}; ||g - g_ref|| / ||g_ref|| {c['grad_dist']:.3e}, "
              f"||g|| / ||g_ref|| {c['norm_ratio']:.4f} (limits {_limits_note(run)}; the limits "
              f"give a {c['rejects']}); BN statistics max diff / max|value| {c['bn1_err']:.3e}"
              + (f" (tol {tol})" if run == "f64" else "")
              + f"; ||g - g_f64|| / ||g_f64||: sharded {c['to_f64']:.3e}, unsharded "
              f"{c['unsharded_to_f64']:.3e}; the job took {ranks_s:.1f} s of wall time with "
              f"its processes' start", flush=True)
    for run, c in chk.items():
        tol = PATH_TOL if run == "bf16" else PAR_F64_TOL
        if not (c["loss_err"] <= tol and c["same"] and c["finite"] and c["held"]
                and (run == "bf16" or c["bn1_err"] <= PAR_F64_TOL)):
            raise SystemExit(f"(d) the {run} channel-sharded step disagrees with the unsharded")
    for res in ranks:
        for run in ("bf16", "f64"):
            if 2 * res[run]["kernel_bytes"] != whole:
                raise SystemExit(f"(d) a rank holds {res[run]['kernel_bytes']} bytes of conv "
                                 f"kernels, not half of {whole}")
            if not all(c["gathers"] and c["reduces"] for c in res[run]["collectives"]):
                raise SystemExit(f"(d) a step ran no channel collective: {res[run]}")
    out = dict(unsharded={run: ref[run][0] for run in ref},
               ranks=[{run: r[run] for run in ("bf16", "f64")} for r in ranks],
               checks={run: {k: v for k, v in c.items() if k != "held"} for run, c in chk.items()},
               job_wall_s=ranks_s)
    del ref, ranks
    torch.cuda.empty_cache()

    # the CLIs: cli.train over the two processes (one step, a checkpoint),
    # then cli.evaluate in this process, where model_parallel = 2 cannot fit
    pack, ckdir = os.path.join(tmp, "tp.fvtpack"), os.path.join(tmp, "tp_ckpt")
    _zoo_pack(pack, PRESETS[TP_PRESET].data.resize_hw, n=TP_CLI_VIDEOS, frames=TP_CLI_FRAMES)
    argv = ["--preset", TP_PRESET, "--train-list", pack, "--batch-size", str(TP_CLI_VIDEOS),
            "--epochs", "1", "--checkpoint-dir", ckdir, "--log-every", "1"]
    with open(os.path.join(tmp, "tp_argv.json"), "w") as f:
        json.dump(argv, f)
    t0 = time.perf_counter()
    cli_ranks = _run_ranks("tpcli", tmp)
    cli_s = time.perf_counter() - t0
    saved = torch.load(os.path.join(ckdir, "step_1.pt"), map_location="cpu")["model"]
    whole_saved = sum(v.numel() * v.element_size() for k, v in saved.items()
                      if k.endswith(".kernel"))
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger("fvt.eval").addHandler(handler)
    t0 = time.perf_counter()
    try:
        metrics, printed = _quiet(cli_evaluate.main, [
            "--preset", TP_PRESET, "--val-list", pack, "--checkpoint-dir", ckdir,
            "--num-eval-clips", "2", "--clip-batch", "4"])
    finally:
        logging.getLogger("fvt.eval").removeHandler(handler)
    eval_s = time.perf_counter() - t0
    for r, res in enumerate(cli_ranks):
        print(f"(d) cli.train --preset {TP_PRESET} rank {r} on {res['cli']['device']}: "
              f"{res['cli']['step']} step(s), "
              f"{_kernel_bytes_note(res['cli']['kernel_bytes'], whole_saved)}")
    print(f"(d) the checkpoint holds {whole_saved / 1e6:.3f} MB of whole conv kernels; "
          f"cli.evaluate --preset {TP_PRESET} in one process ({eval_s:.1f} s): {metrics}; "
          f"warned: {warnings}; the train job took {cli_s:.1f} s with its processes' start "
          f"({card})", flush=True)
    if any(res["cli"]["step"] != 1 or 2 * res["cli"]["kernel_bytes"] != whole_saved
           for res in cli_ranks):
        raise SystemExit(f"(d) cli.train across the processes: {cli_ranks}")
    if not (any("evaluating unsharded" in w for w in warnings)
            and metrics.get("num_videos") == TP_CLI_VIDEOS
            and json.loads(printed.strip().splitlines()[-1]) == metrics):
        raise SystemExit(f"(d) cli.evaluate on the sharded run's checkpoint: {metrics} {warnings}")
    out["cli"] = dict(ranks=[r["cli"] for r in cli_ranks], train_job_s=cli_s,
                      evaluate=metrics, evaluate_s=eval_s, warnings=warnings)
    return out


# ---------------------------------------------------------------------------
# Phase 14: the step profiler (utils/step_profiler.py)
# ---------------------------------------------------------------------------

PROFILE_STEPS = 4  # traced steps a run
PROFILE_CLOSURE = 0.02  # attributed device time against the traced busy time
PROFILE_ATTEMPTS = 3  # traces a run before "no device activity" fails it


def _profiled(fn):
    """``fn()`` again (at most PROFILE_ATTEMPTS times in all) while the
    profiler records no device activity."""
    for attempt in range(PROFILE_ATTEMPTS):
        try:
            return fn(), attempt + 1
        except RuntimeError as e:
            if "no device activity" not in str(e) or attempt == PROFILE_ATTEMPTS - 1:
                raise
            print(f"    attempt {attempt + 1}: the profiler recorded no device activity; "
                  "tracing again", flush=True)


def phase_step_profiler(card: str) -> dict:
    """14: ``profile_train_step`` on the ``r2plus1d18_ucf101`` preset at B =
    32, ``profile_eval_step`` for r2plus1d_18 in bf16 at clip_batch 8 and
    in static int8 at B = 32: the categories, the closure, the rows with the
    largest slack, the conv roofline and its share of a step's CUDA-event
    time, StepTimer's seconds a step. Fails when the attributed device time
    is more than PROFILE_CLOSURE from the traced busy time, when a hand
    kernel's launch lies under no conv site, or when no step was captured."""
    print("== phase 14: the step profiler", flush=True)
    t_phase = time.perf_counter()
    runs = {
        "train": (f"train step, the r2plus1d18_ucf101 preset at B={TRAIN_BATCH}",
                  lambda d: sprof.profile_train_step(batch_size=TRAIN_BATCH,
                                                     n_steps=PROFILE_STEPS, trace_dir=d)),
        "eval_bf16": (f"r2plus1d_18 bf16 forward at clip_batch {CLIP_BATCH}",
                      lambda d: sprof.profile_eval_step(batch_size=CLIP_BATCH,
                                                        n_steps=PROFILE_STEPS, trace_dir=d)),
        "eval_int8": (f"r2plus1d_18 static int8 forward at B={TRAIN_BATCH}",
                      lambda d: sprof.profile_eval_step(batch_size=TRAIN_BATCH, int8="static",
                                                        n_steps=PROFILE_STEPS, trace_dir=d)),
    }
    result, launches, failures = {}, {}, []
    for key, (what, run) in runs.items():
        torch.cuda.empty_cache()
        _int8_reset()
        with tempfile.TemporaryDirectory() as d:
            (rows, cats, info), attempts = _profiled(lambda: run(os.path.join(d, "trace")))
        torch.cuda.synchronize()
        launches[key] = {**{k: ops.launch_counts[k] for k in KERNELS}, **q8.launch_counts}
        event_ms = sorted(info["step_ms"])[len(info["step_ms"]) // 2]
        closure = abs(info["attributed_us_per_step"] - info["device_us_per_step"]) / max(
            info["device_us_per_step"], 1e-9)
        ok = (closure <= PROFILE_CLOSURE and not info["hand_kernels_unplaced"]
              and info["hand_kernels"] > 0 and info["steps_captured"] >= 1)
        print(f"-- {what} ({attempts} trace(s)):", flush=True)
        print(sprof.format_report(rows, cats, info, top=12), flush=True)
        print(f"   steps captured {info['steps_captured']} of {PROFILE_STEPS} traced; CUDA-event ms "
              f"a step {['%.3f' % v for v in info['step_ms']]}, device busy "
              f"{['%.3f' % v for v in info['busy_ms']]}; attributed "
              f"{info['attributed_us_per_step'] / 1e3:.3f} ms against busy "
              f"{info['device_us_per_step'] / 1e3:.3f} ms ({closure * 100:.2f} %, limit "
              f"{PROFILE_CLOSURE * 100:.0f} %); hand-kernel launches {info['hand_kernels']} "
              f"({info['hand_kernels'] / max(info['steps_captured'], 1):.0f} a step), under no "
              f"conv site {info['hand_kernels_unplaced']}; unjoined {info['unjoined']}, outside "
              f"the steps {info['outside_steps']}; conv roofline "
              f"{info['roofline_s'] * 1e3:.3f} ms = {info['roofline_s'] * 1e3 / event_ms:.3f} of "
              f"the step's {event_ms:.3f} ms; StepTimer {info['step_timer_s'] * 1e3:.3f} ms a "
              f"step after the trace, {info['step_timer_before_s'] * 1e3:.3f} before it; on "
              f"{card} ok={ok}", flush=True)
        result[key] = dict(info, what=what, categories_ms={k: v / 1e3 for k, v in cats.items()},
                           rows=[dataclasses.asdict(r) for r in rows[:40]],
                           attempts=attempts, busy_closure=closure, event_ms=event_ms,
                           roofline_share=info["roofline_s"] * 1e3 / event_ms, ok=ok)
        if not ok:
            failures.append(key)
    print(f"phase 14 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    if failures:
        raise SystemExit(f"phase 14 failed: {failures}")
    return dict(result=result, launches=launches)


# phase 15: each accuracy script's run at a reduced size (classes, epochs,
# videos a class), the recipe otherwise the script's own
ACC_CLASSES = 4
ACC_EPOCHS = 5  # the least the schedule takes: warmup 2 ends before the first decay
ACC_KINETICS_GEOMETRY = dict(train_per_class=2, eval_per_class=1)


def _int8_walk_failures(name: str, by_mode: dict) -> list:
    """A record's Q1 / Q2 launches a forward that differ from the engine
    walk's calls or Q1's from the spec's int8 convs."""
    return [(name, mode, f) for mode, f in by_mode.items()
            if f["launches"] != f["walk"] or f["launches"]["conv3d_s8"] != f["int8_convs"]]


def phase_accuracy_scripts(card: str) -> dict:
    """15: the accuracy scripts' runs on the card at ACC_CLASSES classes and
    ACC_EPOCHS epochs (one step an epoch), through their ``main``:
    ``accuracy_hard`` on r2plus1d_18 (K1 / K2 / K3 launched in its
    training), ``int8_s3d``, ``int8_family`` on p3d_63, ``int8_inception``
    on i3d with the margin sweep and the serving throughput,
    ``examples.train_synthetic`` (1 epoch, a pack), and
    ``accuracy_kinetics_geom.run`` at ACC_KINETICS_GEOMETRY's videos a class:
    finite scores, each int8 record's Q1 / Q2 launches a forward equal to the
    engine walk's calls (and Q1's to the spec's int8 convs), the card in
    each record, and every run's launches of K1-K4, Q1 and Q2 summed."""
    from fastvideotagging_tpu_torch.benchmarks import (
        accuracy_hard,
        accuracy_kinetics_geom,
        int8_family,
        int8_inception,
        int8_s3d,
    )
    from fastvideotagging_tpu_torch.examples import train_synthetic

    print("== phase 15: the accuracy scripts at a reduced size", flush=True)
    t_phase = time.perf_counter()
    small = ["--classes", str(ACC_CLASSES), "--epochs", str(ACC_EPOCHS), "--source", "pack",
             "--device", DEV]

    def one_row(out: dict) -> dict:
        return dict(out["results"][0], card=out["card"])

    runs = {
        "accuracy_hard": lambda: accuracy_hard.main(["--model", "r2plus1d_18", *small]),
        "int8_s3d": lambda: int8_s3d.main(small),
        "int8_family": lambda: one_row(int8_family.main(["--models", "p3d_63", *small])),
        "int8_inception": lambda: one_row(int8_inception.main(
            ["--models", "i3d", "--margin-sweep", *small])),
        "accuracy_kinetics_geom": lambda: accuracy_kinetics_geom.run(
            ACC_CLASSES, ACC_EPOCHS, source="pack", device=DEV,
            geometry=ACC_KINETICS_GEOMETRY),
        "train_synthetic": lambda: train_synthetic.main(
            ["--source", "pack", "--epochs", "1", "--device", DEV]),
    }
    result, launches, failures = {}, {}, []
    for name, run in runs.items():
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        q8.reset_launch_counts()
        r = run()
        torch.cuda.synchronize()
        total = {**ops.launch_counts, **q8.launch_counts}
        seconds = time.perf_counter() - t0
        scores = [v for k, v in r.items() if ("top1" in k or k == "mAP")
                  and isinstance(v, float)]
        for k in ("sweep_top1", "margin_sweep", "eval"):
            scores += list(r.get(k, {}).values())
        ok = bool(scores) and all(np.isfinite(v) for v in scores)
        if name in ("int8_s3d", "int8_family", "int8_inception"):
            bad = _int8_walk_failures(name, r["int8_launches"])
            failures += bad
            ok = ok and not bad
        if name == "accuracy_hard":
            ok = ok and all(r["launches"]["fit"][k] > 0 for k in accuracy_hard.TRAIN_KERNELS)
        if name == "train_synthetic":
            ok = ok and len(r["tags"]) == 3
        else:
            ok = ok and r["card"] == card
        launches[name] = total
        result[name] = dict(seconds=seconds, ok=ok, launches=total,
                            record={k: v for k, v in r.items() if k != "int8_launches"},
                            int8_launches=r.get("int8_launches"))
        k123 = [total.get(k, 0) for k in accuracy_hard.TRAIN_KERNELS]
        q12 = [total.get(k, 0) for k in ("conv3d_s8", "quantize_s8", "quantize_s8_amax")]
        print(f"  {name:24s} {seconds:6.1f} s; scores {[round(float(v), 4) for v in scores]}; "
              f"K1/K2/K3 {k123}, Q1/Q2/amax {q12}; ok={ok}", flush=True)
        if "int8_launches" in r:
            for mode, f in r["int8_launches"].items():
                print(f"    {mode:13s} a forward of {f['clips']} clips: launches "
                      f"{list(f['launches'].values())} walk {list(f['walk'].values())} "
                      f"int8 convs {f['int8_convs']}", flush=True)
        if not ok:
            failures.append((name, "checks"))
    print(f"phase 15 took {time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    if failures:
        raise SystemExit(f"phase 15 failed: {failures}")
    return dict(result=result, launches=launches)


# ---------------------------------------------------------------------------
# phase 16: the serving forwards as captured CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_ITERS, GRAPH_WINDOWS = 10, 3  # forwards a window, windows kept
GRAPH_REPLAYS = 3  # replays whose launches are held to as many eager walks
GRAPH_INT8 = ("i3d", "s3d")  # the int8 engines at B = TRAIN_BATCH, INT8_CLIP
# a library call that picks another algorithm under capture (the bf16
# forward's cuDNN / cuBLAS calls) is held to the serving tolerance
# (tests/test_torch_port_export.py's INT8_SCORE_ATOL) where not bitwise
GRAPH_TOL = 5e-2 / 4


def _graph_counts() -> dict:
    torch.cuda.synchronize()
    return {**{k: ops.launch_counts[k] for k in ("spatial_conv", "temporal_conv")},
            **q8.launch_counts}


def _graph_timing(graphed, args) -> dict:
    """Graphed and eager ms a forward (CUDA events, window_ms), then each's
    idle share of the card over GRAPH_ITERS traced forwards (torch.profiler,
    ``breakdown``; None where the trace records no device activity)."""
    from fastvideotagging_tpu_torch.utils.profiling import window_ms

    runs = {"graphed": lambda: graphed(*args), "eager": lambda: graphed.fn(*args)}
    with torch.inference_mode():  # as Tagger and the engines serve
        ms = window_ms(runs, GRAPH_ITERS, GRAPH_WINDOWS)
        out = {k: dict(ms=min(v), window_ms=[round(t, 4) for t in v]) for k, v in ms.items()}
        for k, run in runs.items():
            try:
                b = breakdown(run, iters=GRAPH_ITERS)
            except RuntimeError as e:
                if "no device activity" not in str(e):
                    raise
                out[k].update(idle_share=None, busy_ms=None)
                continue
            out[k].update(idle_share=round(b["idle_share"], 4),
                          busy_ms=round(b["device_busy_ms_per_iter"], 4))
    return out


def _idle_note(t: dict) -> str:
    if t["idle_share"] is None:
        return "idle share not measured (no device activity traced)"
    return f"idle share {t['idle_share']} (busy {t['busy_ms']} ms)"


def _graph_engine(name: str, dynamic: bool, qpacks, x, x2) -> dict:
    """One int8 engine graphed against its eager walk."""
    from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine

    engine = make_int8_engine(name, dynamic=dynamic)
    qpack, qpack2 = qpacks
    with torch.inference_mode():
        first = engine(qpack, x)  # the eager warm-up, then the capture
        before = _graph_counts()
        eager = engine.fn(qpack, x)
        walk = {k: v - before[k] for k, v in _graph_counts().items()}
        before = _graph_counts()
        outs = [engine(qpack, x) for _ in range(GRAPH_REPLAYS)]
        replays = {k: v - before[k] for k, v in _graph_counts().items()}
        a = engine(qpack, x)
        kept = a.clone()
        b = engine(qpack, x2)
        other = engine.fn(qpack, x2)
        second = engine(qpack2, x)
        second_eager = engine.fn(qpack2, x)
        back = engine(qpack, x)
        torch.cuda.synchronize()
    row = dict(
        bitwise=all(torch.equal(o, eager) for o in [first] + outs),
        max_abs_diff=max(float((o - eager).abs().max()) for o in [first] + outs),
        launches_walk=walk, launches_replays=replays,
        launches_ok=replays == {k: GRAPH_REPLAYS * v for k, v in walk.items()},
        clone_kept=torch.equal(a, kept) and torch.equal(b, other) and not torch.equal(a, b),
        second_qpack=torch.equal(second, second_eager) and not torch.equal(second, eager)
        and torch.equal(back, eager),
        captures=engine.captures)
    row.update(ok=row["bitwise"] and row["launches_ok"] and row["clone_kept"]
               and row["second_qpack"] and row["captures"] == 1)
    row["timing"] = _graph_timing(engine, (qpack, x))
    return row


def phase_graphs(card: str) -> dict:
    """16: the serving forwards as captured CUDA graphs against their eager
    walks (the docstring's list); the launches of K1, K2, Q1 and Q2 in the
    phase, counted from 0."""
    print("== phase 16: the serving forwards as captured CUDA graphs", flush=True)
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    q8.reset_launch_counts()
    failures, result = [], {}

    # (a) r2plus1d_18 bf16 through Tagger at 8 clips
    g = torch.Generator().manual_seed(SEED)
    state = get_model("r2plus1d_18", num_classes=400, device="cpu", generator=g).state_dict()
    frames = make_frames(3, num_frames=160, height=128, width=171, seed=SEED)

    def read_frames(idx):
        return frames[idx]

    chunks = -(-(len(frames) // 16) // CLIP_BATCH)
    tagger = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, device=DEV)
    eager_tagger = Tagger(_cfg("cuda"), state, clip_batch=CLIP_BATCH, device=DEV)
    eager_tagger._bf16_apply = eager_tagger._bf16_apply.fn  # the eager walk, for reference
    tagger.scores_from(read_frames, len(frames))  # the first chunk captures
    before = _graph_counts()
    graphed = tagger.scores_from(read_frames, len(frames))
    counts = {k: v - before[k] for k, v in _graph_counts().items()}
    eager = eager_tagger.scores_from(read_frames, len(frames))
    want = {k: n * chunks for k, n in FORWARD_LAUNCHES["cuda"].items()
            if k in ("spatial_conv", "temporal_conv")}
    err = float(np.abs(graphed - eager).max())
    d = tagger.cfg.data
    x = preprocess_eval_clip(torch.from_numpy(frames[:CLIP_BATCH * 16].reshape(
        CLIP_BATCH, 16, 128, 171, 3)).to(DEV), d.resize_hw, d.crop_hw, d.mean, d.std,
        out_dtype=torch.bfloat16)
    with torch.inference_mode():
        fwd_err = float((tagger._bf16_apply(x) - tagger._bf16_apply.fn(x)).abs().max())
    row = dict(bitwise=err == 0.0 and fwd_err == 0.0, max_abs_diff=max(err, fwd_err),
               launches=counts, launches_ok=counts == {**want, "conv3d_s8": 0,
                                                       "quantize_s8": 0,
                                                       "quantize_s8_amax": 0},
               captures=tagger._bf16_apply.captures,
               timing=_graph_timing(tagger._bf16_apply, (x,)))
    row["ok"] = (row["max_abs_diff"] <= GRAPH_TOL and row["launches_ok"]
                 and row["captures"] == 1)
    result["r2plus1d_18_bf16_tagger"] = row
    del tagger, eager_tagger, x

    # (b) the i3d and s3d int8 engines at B = 32
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    for name in GRAPH_INT8:
        model = get_model(name, num_classes=400, device="cpu",
                          generator=torch.Generator().manual_seed(SEED)).to(DEV).eval()
        x = torch.randn((TRAIN_BATCH, *INT8_CLIP, 3), generator=gen, device=DEV).to(
            torch.bfloat16)
        x2 = torch.randn((TRAIN_BATCH, *INT8_CLIP, 3), generator=gen, device=DEV).to(
            torch.bfloat16)
        sd = model.state_dict()
        qpacks = (quantize_for(name, sd, [x[:CLIP_BATCH]]),
                  quantize_for(name, sd, [x2[:CLIP_BATCH]]))
        for mode in ("static", "dynamic"):
            result[f"{name}_int8_{mode}"] = _graph_engine(name, mode == "dynamic", qpacks, x, x2)
        del model, x, x2, sd, qpacks
        torch.cuda.empty_cache()
    launches = _graph_counts()
    for key, row in result.items():
        t = row["timing"]
        diff = "" if row["bitwise"] else f" (max |diff| {row.get('max_abs_diff')})"
        print(f"(16) {key}: graphed against eager bitwise {row['bitwise']}{diff}; "
              f"launches ok {row['launches_ok']}; captures {row['captures']}; "
              + ("" if "clone_kept" not in row else
                 f"clone kept {row['clone_kept']}, second qpack {row['second_qpack']}; ")
              + f"ms a forward graphed {t['graphed']['ms']:.4f} (windows "
              f"{t['graphed']['window_ms']}; {_idle_note(t['graphed'])}), eager "
              f"{t['eager']['ms']:.4f} (windows {t['eager']['window_ms']}; "
              f"{_idle_note(t['eager'])}); ok={row['ok']}", flush=True)
        if not row["ok"]:
            failures.append(key)
    for name in GRAPH_INT8:
        st, dy = (result[f"{name}_int8_{m}"]["timing"] for m in ("static", "dynamic"))
        print(f"(16) {name} int8 at B={TRAIN_BATCH}: dynamic / static clips/s graphed "
              f"{st['graphed']['ms'] / dy['graphed']['ms']:.3f}, eager "
              f"{st['eager']['ms'] / dy['eager']['ms']:.3f}", flush=True)
    print(f"(16) launches in the phase {launches}; phase 16 took "
          f"{time.perf_counter() - t_phase:.1f} s on {card}", flush=True)
    if failures:
        raise SystemExit(f"phase 16 failed: {failures}")
    if min(launches[k] for k in ("spatial_conv", "temporal_conv", "conv3d_s8",
                                 "quantize_s8")) == 0:
        raise SystemExit(f"(16) a kernel of the graphed path was launched no time: {launches}")
    return dict(result=result, launches=launches)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    card = phase_card()
    phase_build()
    host_resize = phase_host_resize(card)
    native_build = start_native_build()
    agg = phase_kernels(card)
    phase_functions()
    k4 = phase_fused_kernel(card)
    micro_run = phase_micro(card)
    serving = phase_path(card)
    train = phase_train(card)
    ev = phase_eval(card)
    with tempfile.TemporaryDirectory() as tmp:  # phase 7's packs, read again in 8 and 10
        fit_run = phase_fit(card, train["routes"], tmp)
        entry = phase_entry_points(card, tmp, train, fit_run)
        acc_sites = phase_accuracy_sites()
        zoo = phase_zoo(card)
        int8 = phase_int8(card, entry["paths"])
        families = phase_int8_families(card)
        export = phase_export(card, tmp)
        native = phase_native(card, tmp, export, native_build)
        par = phase_parallel(card, tmp)
    profiler = phase_step_profiler(card)
    acc = phase_accuracy_scripts(card)
    graphs = phase_graphs(card)
    int8["launches"]["graphs"] = {k: graphs["launches"][k] for k in q8.launch_counts}
    int8["launches"]["int8_families"] = families["launches"]
    int8["launches"]["export"] = export["launches"]
    int8["launches"]["native"] = native["launches"]
    for run, counts in profiler["launches"].items():
        int8["launches"][f"step_profiler_{run}"] = counts
    for run, counts in acc["launches"].items():
        int8["launches"][f"accuracy_{run}"] = {k: counts.get(k, 0) for k in q8.launch_counts}
    entries = []
    for kernel, meta in KERNELS.items():
        runs = {"serving": serving[kernel], "train_step": train["launches"][kernel],
                **{f"eval_{e}": ev[e]["launches"][kernel] for e in FORWARD_LAUNCHES},
                "fit": fit_run["launches"][kernel],
                **{run: c[kernel] for run, c in entry["launches"].items()},
                **{run: c[kernel] for run, c in zoo["launches"].items()},
                "export": export["launches"].get(kernel, 0),
                "native": native["launches"].get(kernel, 0),
                **{f"parallel_{run}": c[kernel] for run, c in par["launches"].items()},
                "int8_families": families["launches"].get(kernel, 0),
                **{f"step_profiler_{run}": c[kernel]
                   for run, c in profiler["launches"].items()},
                **{f"accuracy_{run}": c.get(kernel, 0) for run, c in acc["launches"].items()},
                "graphs": graphs["launches"].get(kernel, 0)}
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
    entries += int8_entries(int8)
    print(json.dumps({"train": train["routes"], "eval": ev, "micro": micro_run["bench"],
                      "fit": {k: v for k, v in fit_run.items() if k not in ("launches", "packs")},
                      "entry_points": entry["result"],
                      "zoo": {k: zoo[k] for k in ("serving", "train", "entry", "sites")},
                      "int8": {"tagger": int8["tagger"], "entry": int8["entry"]},
                      "export": {k: export[k] for k in ("export_s", "artifacts", "dynamic",
                                                        "dispatch")},
                      "native": {k: v for k, v in native.items() if k != "launches"},
                      "parallel": par["result"], "host_resize": host_resize,
                      "int8_families": {k: families[k] for k in ("result", "q1_sites", "q2_sites",
                                                                 "worst")},
                      "step_profiler": profiler["result"],
                      "accuracy_scripts": acc["result"], "graphs": graphs["result"],
                      "card": card}))
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
