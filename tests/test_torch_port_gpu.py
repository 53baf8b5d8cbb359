"""K1 / K2 / K3 / K4 and the micro-benchmark's K5-K9 against their plain
versions on the card (marker ``gpu``), and the fused serving engine on K4
against the model forward.

Skipped without a CUDA card (decided inside the fixture, so every pytest
worker collects the same tests). On the card, from the repository root —
the JAX-importing tests/conftest.py is left out, since the card's machine
has no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q

Shapes: the R(2+1)D-18 serving path's (clip_batch 8, 16x112x112) and ragged
ones (C or Co not a multiple of 8, k = 5, row counts that are not a multiple
of the 128-row tile); for K1 also the dx widths (C = 144 -> 64, 1152 -> 512:
contractions that are not a multiple of the 64-deep slice), one clip of
frames smaller than 8 x 8, and Co = 8; for K2 the dx widths, split plans
and its pad pass. Kernel and plain version take the same bf16 inputs and
sum in f32, so they agree within 1e-2 of the output's largest magnitude
(bf16 output rounding). K3's output is f32 and differs from its plain
version by summation order only: 1e-3 of the largest magnitude. The dx
routes run K1 / K2 on the flipped, channel-transposed weights (C and Co
swapped, so the ragged side is the output's) and are held to autograd
through the plain versions. K5-K9 (ops/temporal_micro.py) at small ragged
shapes, with their default tiles and with 8-column tiles (several S tiles
a clip), T = 1 and 2 among them; K7 and K9 write f32 and are held to 1e-3
and to two bitwise-equal launches, and K7 (the dw ring's clipped walk) to
K9 at every shape.

The loader-fed training path: ``device_prefetch`` returns the host batches
bitwise at depths 1-3 (the consumer overwriting each batch before the
next) and its producer thread has ended, a checkpoint of a train state on the card restores onto the card
bitwise, and ``fit`` on the card takes two r2plus1d_18 steps from a pack.

The int8 engine's kernels (ops/int8_conv.py) at r2plus1d_18's int8 sites:
Q1 in form (a) against its plain version (the identity epilogue bitwise,
the real one within a bf16 ulp), forms (b) and (c) bit for bit against its
plain version and the unfused chain of kernels, Q2 bitwise in its three
modes (static, dynamic with its amax pass, dynamic from an amax given); the
next site's dynamic amax that Q1's epilogue reduces, bit for bit against
its plain version and against Q2's amax pass on the bf16 output; the
engine's launches (28 Q1; Q2 once static, 26 dynamic with 1 amax pass) and
its logits against the same engine on the plain versions.

The train step's knobs: the device cache's rows gathered on the card equal
the loader's frames bitwise and feed a step; each remat policy equals
'none' on the kernels (loss, gradients, BN statistics within 1e-6); and
K1-K3 at the hard accuracy benchmark's sites (B = 64, 8x32x32 clips, down to
T = 1 and 2x2 frames).
"""

import os
import threading

import numpy as np
import pytest
import torch

from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as fused
from fastvideotagging_tpu_torch.ops import temporal_micro as micro
from fastvideotagging_tpu_torch.ops.fused_infer import r2plus1d_fused_infer

pytestmark = pytest.mark.gpu

TOL = 1e-2

SPATIAL = [  # x (N, H, W, C), Co, k
    ((128, 56, 56, 64), 144, 3), ((64, 28, 28, 128), 288, 3),
    ((32, 14, 14, 256), 576, 3), ((16, 7, 7, 512), 1152, 3),
    ((3, 9, 11, 45), 40, 3), ((2, 10, 7, 36), 21, 5), ((1, 5, 5, 32), 8, 3),
    ((128, 56, 56, 144), 64, 3), ((16, 7, 7, 1152), 512, 3),  # dx widths
    ((3, 9, 11, 48), 200, 3),   # M = 297, Co > 144 and divided by no tile
    ((1, 6, 5, 40), 8, 5),      # N = 1, H and W < 8, Co = 8
]
TEMPORAL = [  # x (B, T, S, C), Co, k
    ((8, 16, 3136, 45), 64, 3), ((8, 16, 3136, 144), 64, 3),
    ((8, 8, 784, 288), 128, 3), ((8, 4, 196, 576), 256, 3), ((8, 2, 49, 1152), 512, 3),
    ((2, 5, 13, 45), 19, 3), ((1, 7, 9, 40), 24, 5), ((3, 2, 1, 33), 8, 3),
    ((2, 3, 50, 70), 200, 3),   # C = 70: the pad pass, Co > 144 (the tile GEMM)
    ((1, 4, 33, 63), 45, 5),    # the pad pass with k = 5, Co = 45
]


DW = [  # x (B, T, S, C), Co, k
    ((8, 16, 3136, 45), 64, 3), ((8, 16, 3136, 144), 64, 3),
    ((8, 8, 784, 288), 128, 3), ((8, 4, 196, 576), 256, 3), ((8, 2, 49, 1152), 512, 3),
    ((2, 5, 13, 45), 19, 3), ((1, 7, 9, 40), 24, 5), ((3, 2, 1, 33), 8, 3),
    ((2, 2, 50, 72), 130, 5),   # T = 2 with k = 5: the outer taps have no rows
    ((1, 3, 700, 64), 64, 3),   # several chunks, the last one ragged
    # K3's path sites at B = 2: the stem (C = 45, padded by the kernel's pad
    # pass), stage 1 (C = 144 in one tile), stages 2-4 (2 x 2 to 8 x 8 tiles,
    # T down to 2)
    ((2, 16, 3136, 45), 64, 3), ((2, 16, 3136, 144), 64, 3), ((2, 8, 784, 288), 128, 3),
    ((2, 4, 196, 576), 256, 3), ((2, 2, 49, 1152), 512, 3),
]
DW_TOL = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _close(got, ref):
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= TOL * ref.float().abs().max().item(), err


@pytest.mark.parametrize("x_shape,co,k", SPATIAL)
def test_spatial_kernel_matches_plain(cuda, x_shape, co, k):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, k, x_shape[-1], co), generator=g, device=cuda)
         / (k * k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    before = ops.launch_counts["spatial_conv"]
    got = ops.spatial_conv_cuda(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["spatial_conv"] == before + 1
    _close(got, ops.spatial_conv_plain(x, w))


@pytest.mark.parametrize("x_shape,co,k", [
    ((128, 56, 56, 144), 64, 3), ((16, 7, 7, 1152), 512, 3), ((3, 9, 11, 40), 45, 3),
    ((2, 10, 7, 21), 36, 5), ((1, 5, 6, 8), 32, 3)])
def test_spatial_dx_kernel_matches_plain(cuda, x_shape, co, k):
    """K1 as dx: g (N, H, W, Co) -> (N, H, W, C) with x_shape's C = Co of
    the forward weight (k, k, co, C); ragged widths are padded to 8."""
    g = torch.Generator(device=cuda).manual_seed(7)
    gy = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, k, co, x_shape[-1]), generator=g, device=cuda)
         / (k * k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    before = ops.launch_counts["spatial_conv"]
    got = ops.spatial_conv_dx_cuda(gy, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["spatial_conv"] == before + 1
    assert got.shape == x_shape[:3] + (co,)
    _close(got, ops.spatial_conv_dx_plain(gy, w))
    # the same conv through the forward wrapper, on the flipped weights
    fwd = ops.spatial_conv_cuda(gy, w.flip(0, 1).transpose(2, 3).contiguous())
    assert torch.equal(got, fwd)


@pytest.mark.parametrize("x_shape,co,dx", [
    ((16, 7, 7, 512), 1152, False), ((16, 7, 7, 1152), 512, True),  # stage 4 at 8 clips
    ((1, 9, 9, 256), 21, False), ((1, 9, 9, 256), 40, True)])       # one tile, ragged Co
def test_spatial_split_kappa_is_bitwise_deterministic(cuda, x_shape, co, dx):
    """Where the plan splits the contraction, the f32 partial sums are added
    in chunk order by a second kernel: two launches are bitwise equal."""
    n, h, w, c = x_shape
    assert ops.spatial_plan(x_shape, co, 3).splits > 1
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w_shape = (3, 3, co, c) if dx else (3, 3, c, co)
    w = (torch.randn(w_shape, generator=g, device=cuda) / (9 * c) ** 0.5).to(torch.bfloat16)
    run, plain = ((ops.spatial_conv_dx_cuda, ops.spatial_conv_dx_plain) if dx
                  else (ops.spatial_conv_cuda, ops.spatial_conv_plain))
    before = ops.launch_counts["spatial_conv"]
    got, again = run(x, w), run(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["spatial_conv"] == before + 2  # the reduce is part of a launch
    assert torch.equal(got, again)
    _close(got, plain(x, w))


@pytest.mark.parametrize("w_shape,dx", [
    ((3, 3, 512, 1152), False), ((3, 3, 512, 1152), True), ((3, 3, 45, 40), False),
    ((5, 5, 36, 21), True), ((3, 3, 64, 144), True)])
def test_spatial_weight_layout_kernel_matches_plain(cuda, w_shape, dx):
    """The weight layout K1 writes into its scratch: bit for bit the plain
    version's (a transpose per tap forward, a row copy for dx, zero pads)."""
    g = torch.Generator(device=cuda).manual_seed(10)
    w = torch.randn(w_shape, generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn((1, 5, 6, w_shape[3] if dx else w_shape[2]), generator=g,
                    device=cuda).to(torch.bfloat16)
    _, wk = ops._k1_launch(x, w, dx=dx)
    torch.cuda.synchronize()
    assert torch.equal(wk, ops.spatial_weight_layout_plain(w, dx=dx))


def test_spatial_kernel_takes_a_misaligned_view(cuda):
    """A contiguous view that starts 2 bytes into its buffer: the wrapper
    copies it to an aligned tensor for the kernel's 16-byte loads."""
    g = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.randn(1 + 2 * 6 * 7 * 32, generator=g, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(2, 6, 7, 32)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    w = torch.randn((3, 3, 32, 16), generator=g, device=cuda).to(torch.bfloat16)
    _close(ops.spatial_conv_cuda(x, w), ops.spatial_conv_plain(x, w))


@pytest.mark.parametrize("x_shape,co,k", TEMPORAL)
def test_temporal_kernel_matches_plain(cuda, x_shape, co, k):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, x_shape[-1], co), generator=g, device=cuda)
         / (k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    before = ops.launch_counts["temporal_conv"]
    got = ops.temporal_conv_cuda(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["temporal_conv"] == before + 1
    _close(got, ops.temporal_conv_plain(x, w))


@pytest.mark.parametrize("x_shape,co,k", [
    ((8, 16, 3136, 64), 45, 3), ((8, 16, 3136, 64), 144, 3), ((8, 8, 784, 128), 288, 3),
    ((8, 2, 49, 512), 1152, 3), ((2, 5, 13, 19), 45, 3), ((1, 7, 9, 24), 40, 5),
    ((2, 3, 5, 45), 21, 3)])
def test_temporal_dx_kernel_matches_plain(cuda, x_shape, co, k):
    """K2 as dx: g (B, T, S, Co) -> (B, T, S, C) with x_shape's C = Co of the
    forward weight (k, co, C): the weight laid out straight from the forward
    weight, the taps read in reverse; a ragged g goes through the pad pass."""
    g = torch.Generator(device=cuda).manual_seed(13)
    gy = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, co, x_shape[-1]), generator=g, device=cuda)
         / (k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    before = ops.launch_counts["temporal_conv"]
    got = ops.temporal_conv_dx_cuda(gy, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["temporal_conv"] == before + 1
    assert got.shape == x_shape[:3] + (co,)
    _close(got, ops.temporal_conv_dx_plain(gy, w))
    # the same conv through the forward wrapper, on the flipped weights
    fwd = ops.temporal_conv_cuda(gy, w.flip(0).transpose(1, 2).contiguous())
    assert torch.equal(got, fwd)


@pytest.mark.parametrize("x_shape,co,dx", [
    ((8, 2, 49, 1152), 512, False), ((8, 2, 49, 512), 1152, True),  # stage 4 at 8 clips
    ((8, 4, 196, 576), 256, False),                                # stage 3 at 8 clips
    ((1, 3, 40, 512), 45, True)])                                  # one tile, Co = 45
def test_temporal_split_kappa_is_bitwise_deterministic(cuda, x_shape, co, dx):
    """Where K2's plan splits the contraction, two launches are bitwise
    equal (partials added in chunk order by the reduce)."""
    c = x_shape[-1]
    assert ops.temporal_plan(x_shape, co, 3).splits > 1
    g = torch.Generator(device=cuda).manual_seed(14)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w_shape = (3, co, c) if dx else (3, c, co)
    w = (torch.randn(w_shape, generator=g, device=cuda) / (3 * c) ** 0.5).to(torch.bfloat16)
    run, plain = ((ops.temporal_conv_dx_cuda, ops.temporal_conv_dx_plain) if dx
                  else (ops.temporal_conv_cuda, ops.temporal_conv_plain))
    before = ops.launch_counts["temporal_conv"]
    got, again = run(x, w), run(x, w)
    torch.cuda.synchronize()
    assert ops.launch_counts["temporal_conv"] == before + 2  # the reduce is part of a launch
    assert torch.equal(got, again)
    _close(got, plain(x, w))


@pytest.mark.parametrize("x_shape,co,k", [
    ((2, 16, 3136, 45), 64, 3), ((2, 5, 13, 45), 19, 3), ((3, 2, 1, 33), 8, 3),
    ((1, 9, 7, 63), 45, 5)])
def test_temporal_pad_pass_matches_plain_and_prepadded(cuda, x_shape, co, k):
    """Rows of C % 8 != 0 channels go through K2's pad pass: the result is
    the plain version's, forward and dx, and bit for bit the same call's on
    channels padded beforehand (the same contraction, in the same order)."""
    g = torch.Generator(device=cuda).manual_seed(15)
    c = x_shape[-1]
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, c, co), generator=g, device=cuda) / (k * c) ** 0.5).to(torch.bfloat16)
    got = ops.temporal_conv_cuda(x, w)
    _close(got, ops.temporal_conv_plain(x, w))
    assert torch.equal(got, ops._k2_launch(ops._pad_channels(x), w, False)[0])
    w_dx = (torch.randn((k, co, c), generator=g, device=cuda) / (k * c) ** 0.5).to(torch.bfloat16)
    _close(ops.temporal_conv_dx_cuda(x, w_dx), ops.temporal_conv_dx_plain(x, w_dx))


@pytest.mark.parametrize("w_shape,dx,c_in", [
    ((3, 45, 64), False, 45), ((3, 64, 45), True, 45), ((3, 1152, 512), False, 1152),
    ((3, 512, 1152), True, 1152), ((5, 36, 21), True, 21), ((3, 70, 8), False, 70)])
def test_temporal_weight_layout_kernel_matches_plain(cuda, w_shape, dx, c_in):
    """The weight layout K2 writes into its scratch: bit for bit the plain
    version's (zero-padded to a multiple of 8 channels)."""
    g = torch.Generator(device=cuda).manual_seed(16)
    w = torch.randn(w_shape, generator=g, device=cuda).to(torch.bfloat16)
    x = torch.randn((1, 5, 6, c_in), generator=g, device=cuda).to(torch.bfloat16)
    _, wk = ops._k2_launch(x, w, dx=dx)
    torch.cuda.synchronize()
    assert torch.equal(wk, ops.temporal_weight_layout_plain(w, dx=dx))


def test_temporal_kernel_takes_a_misaligned_view(cuda):
    """Contiguous views that start 2 bytes into their buffers (C = 45, the
    pad pass, and C = 64): the wrapper copies each to an aligned tensor."""
    g = torch.Generator(device=cuda).manual_seed(17)
    for c in (45, 64):
        flat = torch.randn(1 + 2 * 6 * 50 * c, generator=g, device=cuda).to(torch.bfloat16)
        x = flat[1:].view(2, 6, 50, c)
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
        w = torch.randn((3, c, 24), generator=g, device=cuda).to(torch.bfloat16)
        _close(ops.temporal_conv_cuda(x, w), ops.temporal_conv_plain(x, w))


@pytest.mark.parametrize("x_shape,co,k", DW)
def test_temporal_dw_kernel_matches_plain_and_is_deterministic(cuda, x_shape, co, k):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    gy = torch.randn(x_shape[:3] + (co,), generator=g, device=cuda).to(torch.bfloat16)
    torch.backends.cuda.matmul.allow_tf32 = False
    before = ops.launch_counts["temporal_dw"]
    got = ops.temporal_dw_cuda(x, gy, k)
    again = ops.temporal_dw_cuda(x, gy, k)
    torch.cuda.synchronize()
    assert ops.launch_counts["temporal_dw"] == before + 2
    ref = ops.temporal_dw_plain(x, gy, k)
    assert got.dtype == torch.float32 and got.shape == ref.shape == (k, x_shape[-1], co)
    assert torch.equal(got, again)  # bitwise: no atomics, fixed reduction order
    err = (got - ref).abs().max().item()
    assert err <= DW_TOL * ref.abs().max().item(), err


@pytest.mark.parametrize("x_shape,co,k,split", [
    ((2, 16, 3136, 144), 64, 3, True),   # one tile over the card: 131 chunks
    ((1, 3, 700, 64), 64, 3, True),      # 4 chunks, the last one short
    ((2, 2, 49, 1152), 512, 3, False),   # 64 tiles, 4 slabs: one chunk, no reduce
    ((1, 7, 9, 40), 24, 5, False),       # k = 5: two tap groups, one chunk
])
def test_temporal_dw_split_and_single_chunk_plans(cuda, x_shape, co, k, split):
    """K3 with its contraction split over blocks (f32 partials added in
    chunk order by the reduce) and with one chunk (the blocks write dw):
    both match the plain version, and two launches are bitwise equal."""
    plan = ops.temporal_dw_plan(x_shape, co, k, ops._sm_count(torch.device(cuda)))
    assert (plan.chunks > 1) == split
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    gy = torch.randn(x_shape[:3] + (co,), generator=g, device=cuda).to(torch.bfloat16)
    got, again = ops.temporal_dw_cuda(x, gy, k), ops.temporal_dw_cuda(x, gy, k)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    ref = ops.temporal_dw_plain(x, gy, k)
    assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def test_temporal_dw_kernel_takes_misaligned_views(cuda):
    """Contiguous views that start 2 bytes into their buffers (x with 8 | C,
    g with Co = 45): the kernel's pad pass copies each to an aligned,
    channel-padded scratch tensor for the 16-byte copies."""
    g = torch.Generator(device=cuda).manual_seed(12)
    shape = (2, 6, 50, 64)
    flat = torch.randn(1 + 2 * 6 * 50 * 64, generator=g, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(shape)
    flat_g = torch.randn(1 + 2 * 6 * 50 * 45, generator=g, device=cuda).to(torch.bfloat16)
    gy = flat_g[1:].view(2, 6, 50, 45)
    assert x.data_ptr() % 16 != 0 and gy.data_ptr() % 16 != 0 and x.is_contiguous()
    got = ops.temporal_dw_cuda(x, gy, 3)
    ref = ops.temporal_dw_plain(x, gy, 3)
    assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def _grads(fn, x, w, gy):
    x = x.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    fn(x, w).backward(gy)
    return x.grad, w.grad


@pytest.mark.parametrize("x_shape,co,k", [
    ((2, 4, 14, 14, 64), 144, 3), ((1, 2, 9, 11, 45), 40, 3), ((1, 2, 10, 7, 36), 21, 5),
    ((2, 2, 7, 7, 512), 1152, 3)])
def test_spatial_conv_backward_runs_the_kernel(cuda, x_shape, co, k):
    g = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, k, x_shape[-1], co), generator=g, device=cuda)
         / (k * k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    gy = torch.randn(x_shape[:4] + (co,), generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    # a non-contiguous incoming gradient is made contiguous, not refused
    dx, dw = _grads(ops.spatial_conv, x, w, gy.transpose(2, 3).contiguous().transpose(2, 3))
    assert ops.launch_counts == {"spatial_conv": 2, "temporal_conv": 0, "temporal_dw": 0,
                                 "fused_block": 0}

    def plain(x, w):
        b, t, h, wd, c = x.shape
        return ops.spatial_conv_plain(x.reshape(b * t, h, wd, c), w).reshape(b, t, h, wd, -1)
    rdx, rdw = _grads(plain, x.float(), w.float(), gy.float())  # f32 reference
    _close(dx, rdx)
    _close(dw, rdw)


@pytest.mark.parametrize("x_shape,co,k", [
    ((2, 4, 14, 14, 144), 64, 3), ((2, 8, 6, 6, 45), 64, 3), ((1, 7, 3, 3, 40), 24, 5),
    ((2, 2, 7, 7, 1152), 512, 3), ((1, 4, 5, 5, 64), 45, 3)])
def test_temporal_conv_backward_runs_the_kernels(cuda, x_shape, co, k):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, x_shape[-1], co), generator=g, device=cuda)
         / (k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    gy = torch.randn(x_shape[:4] + (co,), generator=g, device=cuda).to(torch.bfloat16)
    ops.reset_launch_counts()
    dx, dw = _grads(ops.temporal_conv, x, w, gy)
    assert ops.launch_counts == {"spatial_conv": 0, "temporal_conv": 2, "temporal_dw": 1,
                                 "fused_block": 0}

    def plain(x, w):
        b, t, h, wd, c = x.shape
        return ops.temporal_conv_plain(x.reshape(b, t, h * wd, c), w).reshape(b, t, h, wd, -1)
    rdx, rdw = _grads(plain, x.float(), w.float(), gy.float())  # f32 reference
    _close(dx, rdx)
    _close(dw, rdw)


def test_backward_honours_needs_input_grad(cuda):
    x = torch.randn((1, 4, 6, 6, 64), device=cuda).to(torch.bfloat16)
    w = torch.randn((3, 64, 32), device=cuda).to(torch.bfloat16).requires_grad_(True)
    ops.reset_launch_counts()
    ops.temporal_conv(x, w).float().sum().backward()
    assert ops.launch_counts == {"spatial_conv": 0, "temporal_conv": 1, "temporal_dw": 1,
                                 "fused_block": 0}
    assert w.grad is not None and torch.isfinite(w.grad).all()


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((1, 4, 4, 32), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((3, 3, 32, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.spatial_conv_cuda(x.float(), w)
    with pytest.raises(ValueError, match="contiguous"):
        ops.spatial_conv_cuda(x.transpose(1, 2), w)
    with pytest.raises(ValueError, match="w must be"):
        ops.spatial_conv_cuda(x, w[:, :, :16])
    with pytest.raises(ValueError, match="odd"):
        ops.temporal_conv_cuda(x, torch.zeros((2, 32, 8), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="w must be"):
        ops.temporal_conv_dx_cuda(x, torch.zeros((3, 8, 16), device=cuda, dtype=torch.bfloat16))
    gy = torch.zeros((1, 4, 4, 8), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16"):
        ops.temporal_dw_cuda(x, gy.float(), 3)
    with pytest.raises(ValueError, match="share B, T, S"):
        ops.temporal_dw_cuda(x, gy[:, :2].contiguous(), 3)
    with pytest.raises(ValueError, match="odd"):
        ops.temporal_dw_cuda(x, gy, 2)


def test_model_kernels_agree_with_library_convs(cuda):
    g = torch.Generator().manual_seed(0)
    state = get_model("r2plus1d_18", num_classes=16, device="cpu", generator=g).state_dict()
    models = {}
    for backend in ("cuda", "torch"):
        models[backend] = get_model("r2plus1d_18", num_classes=16, device=cuda,
                                    backend=backend)
        models[backend].load_state_dict(state)
    x = torch.randn((2, 16, 112, 112, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        a = models["cuda"](x)
        b = models["torch"](x)
    assert ops.launch_counts == {"spatial_conv": 13, "temporal_conv": 14, "temporal_dw": 0,
                                 "fused_block": 0}
    assert torch.isfinite(a).all()
    assert (a - b).abs().max().item() <= 5e-2 * b.abs().max().item()


# K4: x (B, T, H, W, C), M, Co, k. The four r2plus1d_18 stride-1 sites (at
# B = 2), ragged widths, and T = 1, 2, 16 (a halo frame contributes zero to
# the temporal conv, not ReLU(bias)).
FUSED = [
    ((2, 16, 56, 56, 64), 144, 64, 3), ((2, 8, 28, 28, 128), 288, 128, 3),
    ((2, 4, 14, 14, 256), 576, 256, 3), ((2, 2, 7, 7, 512), 1152, 512, 3),
    ((2, 1, 9, 11, 40), 50, 24, 3), ((1, 2, 6, 7, 40), 50, 24, 3),
    ((3, 16, 5, 5, 33), 21, 70, 3), ((1, 5, 8, 6, 36), 40, 16, 5),
]


def _fused_inputs(cuda, x_shape, m, co, k, seed=6):
    g = torch.Generator(device=cuda).manual_seed(seed)
    c = x_shape[-1]
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w_sp = (torch.randn((k, k, c, m), generator=g, device=cuda)
            / (k * k * c) ** 0.5).to(torch.bfloat16)
    w_tmp = (torch.randn((k, m, co), generator=g, device=cuda) / (k * m) ** 0.5).to(torch.bfloat16)
    gamma = torch.rand(m, generator=g, device=cuda) + 0.5
    beta = torch.randn(m, generator=g, device=cuda) * 0.1 + 0.3  # ReLU(bias) > 0 mostly
    mean = torch.randn(m, generator=g, device=cuda) * 0.1
    var = torch.rand(m, generator=g, device=cuda) + 0.5
    scale, bias = fused.fold_bn(gamma, beta, mean, var)
    return x, w_sp, scale, bias, w_tmp


@pytest.mark.parametrize("x_shape,m,co,k", FUSED)
def test_fused_block_kernel_matches_plain(cuda, x_shape, m, co, k):
    args = _fused_inputs(cuda, x_shape, m, co, k)
    assert fused.fused_supported(x_shape, k, m, co)
    before = ops.launch_counts["fused_block"]
    got = fused.fused_block_cuda(*args)
    again = fused.fused_block_cuda(*args)
    torch.cuda.synchronize()
    assert ops.launch_counts["fused_block"] == before + 2
    assert torch.equal(got, again)
    _close(got, fused.fused_block_plain(*args))


# K4 with its plan forced: (x shape, M, Co, k, rows per block, mid channels
# per group). Several groups (f32 partials added in group order by the
# reduce) and one group (the block writes y), at the path's stage-4 and
# stage-2 shapes and at ragged widths (M = 50 in one group of 64; M = 297
# in 3 groups of 144, the last ragged; Co = 70 past one 64-wide tile).
FORCED = [
    ((2, 2, 7, 7, 512), 1152, 512, 3, 64, 64), ((2, 2, 7, 7, 512), 1152, 512, 3, 128, 144),
    ((2, 8, 28, 28, 128), 288, 128, 3, 64, 144), ((2, 8, 28, 28, 128), 288, 128, 3, 128, 64),
    ((1, 3, 9, 11, 40), 50, 24, 3, 128, 64), ((2, 3, 6, 5, 48), 297, 70, 3, 64, 144),
    ((1, 4, 6, 7, 40), 144, 64, 5, 64, 144),
]


@pytest.mark.parametrize("x_shape,m,co,k,bm,mg", FORCED)
def test_fused_block_forced_plans_match_plain_and_repeat_bitwise(cuda, x_shape, m, co, k, bm,
                                                                 mg):
    ct = next((n for n in (64, 128, 256) if n >= co), 256)
    plan = fused._make_plan(x_shape, k, m, co, 132, bm, mg, ct)
    assert plan is not None and (plan.bm, plan.mg) == (bm, mg)
    args = _fused_inputs(cuda, x_shape, m, co, k, seed=11)
    got = fused.fused_block_cuda(*args, plan=plan)
    again = fused.fused_block_cuda(*args, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got, again)  # bitwise: partials added in group order, no atomics
    _close(got, fused.fused_block_plain(*args))


def test_fused_block_takes_a_misaligned_view(cuda):
    """A contiguous x that starts 2 bytes into its buffer, C = 36: the
    wrapper pads the channels and copies to an aligned tensor for the
    kernel's 16-byte loads."""
    g = torch.Generator(device=cuda).manual_seed(12)
    _, w_sp, scale, bias, w_tmp = _fused_inputs(cuda, (1, 3, 6, 7, 36), 40, 24, 3)
    flat = torch.randn(1 + 3 * 6 * 7 * 36, generator=g, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(1, 3, 6, 7, 36)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _close(fused.fused_block_cuda(x, w_sp, scale, bias, w_tmp),
           fused.fused_block_plain(x, w_sp, scale, bias, w_tmp))


def test_fused_block_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    x, w_sp, scale, bias, w_tmp = _fused_inputs(cuda, (1, 2, 6, 6, 32), 40, 16, 3)
    with pytest.raises(ValueError, match="bfloat16"):
        fused.fused_block_cuda(x.float(), w_sp, scale, bias, w_tmp)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_block_cuda(x.transpose(2, 3), w_sp, scale, bias, w_tmp)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.fused_block_cuda(x.cpu(), w_sp, scale, bias, w_tmp)
    with pytest.raises(ValueError, match="scale must be"):
        fused.fused_block_cuda(x, w_sp, scale.to(torch.bfloat16), bias, w_tmp)
    with pytest.raises(ValueError, match="w_sp must be"):
        fused.fused_block_cuda(x, w_sp, scale, bias, w_tmp[:, :8].contiguous())
    # the routed entry point sends a CUDA tensor to the kernel, never the plain version
    before = ops.launch_counts["fused_block"]
    fused.conv2plus1d_fused(x, w_sp, scale, bias, w_tmp)
    assert ops.launch_counts["fused_block"] == before + 1


def test_fused_engine_on_the_card_matches_the_model(cuda):
    g = torch.Generator().manual_seed(0)
    model = get_model("r2plus1d_18", num_classes=16, device="cpu", generator=g)
    state = model.state_dict()
    rng = torch.Generator().manual_seed(1)
    for name, v in state.items():  # move the BN statistics off the identity
        if name.endswith((".mean", ".var")):
            v += torch.rand(v.shape, generator=rng) * 0.1
    state = {k: v.to(cuda) for k, v in state.items()}
    net = get_model("r2plus1d_18", num_classes=16, device=cuda)
    net.load_state_dict(state)
    x = torch.randn((2, 16, 112, 112, 3), generator=torch.Generator(device=cuda).manual_seed(2),
                    device=cuda)
    ops.reset_launch_counts()
    got = r2plus1d_fused_infer(state, x)
    again = r2plus1d_fused_infer(state, x)
    torch.cuda.synchronize()
    assert ops.launch_counts == {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0,
                                 "fused_block": 26}
    with torch.inference_mode():
        ref = net(x)
    assert torch.equal(got, again) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


# K5-K9: x (B, T, S, C), Co, k. Ragged C and Co, k = 5, T = 1 and 2 (taps
# with no rows), S prime (v2's halving ends at a 1-column tile), a stage-1
# width at 2 clips. For the frame ring (K5, K6, K8): S = 100 (a partial
# 64-column tile), T = 16 at C = 256 (more frames than ring slots, two
# 64-wide Co tiles), C = 144 (not a multiple of 64), Co = 200 (two Co
# tiles), Co = 288 (two 144-wide Co tiles, stored from registers), C = 512
# (two channel groups added by the reduce), k = 15 (two tap groups; at T =
# 1 K6's second group reaches no frame), and each micro-benchmark shape's
# widths at clip batch 2. The same shapes give K9's dw ring partial items,
# one 144-wide C tile (C = 144), two and four 128-wide ones (C = 256, 512),
# four and five 64-wide Co tiles (Co = 200, 288), channel-pad copies (C =
# 45, 63; Co = 19, 45) and tap groups of 3 and 2 (k = 5) or five of 3 (k =
# 15).
MICRO = [
    ((2, 5, 13, 45), 19, 3), ((1, 7, 9, 40), 24, 5), ((3, 2, 24, 32), 8, 3),
    ((2, 1, 24, 40), 24, 3), ((1, 4, 33, 63), 45, 5), ((2, 16, 196, 144), 64, 3),
    ((2, 4, 100, 40), 72, 3), ((2, 16, 100, 256), 128, 3), ((2, 4, 100, 144), 64, 3),
    ((2, 8, 100, 64), 200, 3), ((2, 4, 100, 64), 288, 3), ((1, 4, 70, 512), 64, 3),
    ((2, 4, 100, 64), 72, 15), ((1, 1, 70, 40), 24, 15),
    ((2, 16, 3136, 128), 128, 3), ((2, 16, 3136, 144), 64, 3), ((2, 8, 784, 256), 128, 3),
]
# (launch-count key, forward or dw wrapper, plain version)
MICRO_FWD = {
    "v2": (micro.temporal_v2_cuda, micro.temporal_v2_plain),
    "v3": (micro.temporal_v3_cuda, micro.temporal_v3_plain),
    "v3p": (micro.temporal_v3p_cuda, micro.temporal_v3p_plain),
    "dx_v3": (micro.temporal_dx_v3_cuda, micro.temporal_dx_v3_plain),
}
MICRO_DW = {
    "dw_v3": (micro.temporal_dw_v3_cuda, micro.temporal_dw_v3_plain),
    "dw_v2": (micro.temporal_dw_v2_cuda, micro.temporal_dw_v2_plain),
}


def _micro_inputs(cuda, x_shape, co, k, seed=8):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(x_shape, generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((k, x_shape[-1], co), generator=g, device=cuda)
         / (k * x_shape[-1]) ** 0.5).to(torch.bfloat16)
    gy = torch.randn(x_shape[:3] + (co,), generator=g, device=cuda).to(torch.bfloat16)
    return x, w, gy


@pytest.mark.parametrize("tile", [None, 8])
@pytest.mark.parametrize("design", list(MICRO_FWD))
@pytest.mark.parametrize("x_shape,co,k", MICRO)
def test_micro_forward_kernels_match_plain(cuda, x_shape, co, k, design, tile):
    """K5, K6 (and its dx), K8 against their plain versions; a tile of 8
    (``tile_s`` / ``max_tile``) cuts each clip into several S tiles."""
    x, w, gy = _micro_inputs(cuda, x_shape, co, k)
    run, plain = MICRO_FWD[design]
    key = "v3" if design == "dx_v3" else design
    args = (gy, w, k) if design == "dx_v3" else (x, w, k)
    args += (tile,) if tile else ()
    before = dict(micro.launch_counts)
    got = run(*args)
    torch.cuda.synchronize()
    assert micro.launch_counts == dict(before, **{key: before[key] + 1})
    want = x_shape if design == "dx_v3" else x_shape[:3] + (co,)
    assert got.shape == want
    _close(got, plain(*args))


@pytest.mark.parametrize("tile", [None, 8])
@pytest.mark.parametrize("design", list(MICRO_DW))
@pytest.mark.parametrize("x_shape,co,k", MICRO)
def test_micro_dw_kernels_match_plain_and_repeat_bitwise(cuda, x_shape, co, k, design, tile):
    """K7 and K9 against their plain versions (f32, summation order only:
    1e-3 of the largest |dw|); two launches bitwise equal (partials added in
    chunk order, no atomics)."""
    x, _, gy = _micro_inputs(cuda, x_shape, co, k)
    run, plain = MICRO_DW[design]
    args = (x, gy, k) + ((tile,) if tile else ())
    before = micro.launch_counts[design]
    got = run(*args)
    again = run(*args)
    torch.cuda.synchronize()
    assert micro.launch_counts[design] == before + 2
    ref = plain(*args)
    assert got.dtype == torch.float32 and got.shape == (k, x_shape[-1], co)
    assert torch.equal(got, again)
    assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def test_micro_dw_kernels_split_into_chunks(cuda):
    """More chunks than one: K7's and K9's (clip, 64-column) items beyond
    the SMs, several items a chunk (both take ``dw_ring_plan``); one item:
    a single chunk written directly."""
    sms = ops._sm_count(cuda)
    for x_shape, co, tile in (((300, 2, 8, 16), 16, 1), ((1, 3, 32, 24), 8, 32)):
        x, _, gy = _micro_inputs(cuda, x_shape, co, 3)
        ring = micro.dw_ring_plan(x_shape, co, 3, sms)
        assert (ring.chunks > 1) == (ring.cols_per_chunk > 1) == (x_shape[0] == 300)
        for run, plain in MICRO_DW.values():
            got = run(x, gy, 3, tile)
            ref = plain(x, gy, 3, tile)
            assert torch.equal(got, run(x, gy, 3, tile))
            assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def test_micro_k5_and_k6_launch_no_pad_pass(cuda):
    """K5 (v2) reads its halo frames as the TMA box's zero fill: no pad
    copy is launched for aligned inputs (nor by K6, K8 and K9, which has no
    pad pass of its own any more); K5 and K6 agree with their plain
    versions there at T = 1, 2, 16."""
    for x_shape, co in (((2, 1, 64, 64), 64), ((2, 2, 100, 128), 128), ((1, 16, 64, 256), 128)):
        x, w, gy = _micro_inputs(cuda, x_shape, co, 3)
        before = micro.channel_pad_launches()
        for run, plain in (MICRO_FWD["v2"], MICRO_FWD["v3"]):
            _close(run(x, w, 3), plain(x, w, 3))
        micro.temporal_v3p_cuda(x, w, 3)
        micro.temporal_dw_v2_cuda(x, gy, 3)
        torch.cuda.synchronize()
        assert micro.channel_pad_launches() == before


def test_micro_k9_launches_no_pad_pass(cuda):
    """K9 (dw v2) reads its halo frames as the TMA box's zero fill: for
    aligned x and g it launches the ring (and the reduce where it has
    several chunks) and no pad copy, at T = 1, 2, 16 and k = 3, 5; a copy
    only where TMA cannot read a tensor's rows (C or Co % 8 != 0), one a
    tensor. Against the plain version each time."""
    for x_shape, co, k in (((2, 1, 64, 64), 64, 3), ((2, 2, 100, 128), 128, 5),
                           ((1, 16, 64, 256), 128, 3), ((2, 4, 70, 40), 24, 3)):
        x, _, gy = _micro_inputs(cuda, x_shape, co, k)
        before = micro.channel_pad_launches()
        got = micro.temporal_dw_v2_cuda(x, gy, k)
        torch.cuda.synchronize()
        assert micro.channel_pad_launches() == before
        ref = micro.temporal_dw_v2_plain(x, gy, k)
        assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()
    for x_shape, co, copies in (((2, 4, 70, 45), 24, 1), ((2, 4, 70, 40), 19, 1),
                                ((2, 4, 70, 45), 19, 2)):
        x, _, gy = _micro_inputs(cuda, x_shape, co, 3)
        before = micro.channel_pad_launches()
        got = micro.temporal_dw_v2_cuda(x, gy, 3)
        torch.cuda.synchronize()
        assert micro.channel_pad_launches() == before + copies
        ref = micro.temporal_dw_v2_plain(x, gy, 3)
        assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


@pytest.mark.parametrize("x_shape,co,k", MICRO)
def test_micro_k7_matches_k9_and_pads_only_ragged_channels(cuda, x_shape, co, k):
    """K7 (the dw ring's clipped walk) against K9 (the padded walk) on the
    same inputs, within DW_TOL (summation order only: the padded walk's
    extra products are zeros), at every MICRO shape; one channel-pad copy
    a tensor whose channels are not a multiple of 8, none for aligned
    inputs."""
    x, _, gy = _micro_inputs(cuda, x_shape, co, k)
    copies = (x_shape[-1] % 8 != 0) + (co % 8 != 0)
    before = micro.channel_pad_launches()
    got = micro.temporal_dw_v3_cuda(x, gy, k)
    torch.cuda.synchronize()
    assert micro.channel_pad_launches() == before + copies
    ref = micro.temporal_dw_v2_cuda(x, gy, k)
    assert got.shape == ref.shape == (k, x_shape[-1], co)
    assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def test_micro_ring_plans_fit_the_card(cuda):
    """The ring's plan (K5, K6 and its dx, and K8, which runs on K5's walk
    with the same plan and the same entry-point arguments) at the
    micro-benchmark's shapes (forward and dx) and the GPU tests' shapes:
    one block an SM, shared memory within the card's opt-in limit, k + 1
    frame slots at least, x in one channel group where C <= 256; at k = 15
    two tap groups of 8 and 7 taps with 9 slots at least, and a 144-wide Co
    tile that does not cover Co stores from registers."""
    assert micro._ARGTYPES["v3p"] == micro._ARGTYPES["v2"] == micro._ARGTYPES["v3"]
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    sms = ops._sm_count(cuda)
    shapes = [(x_shape, co) for x_shape, co, _ in MICRO] + [
        ((32, 16, 3136, 128), 128), ((32, 16, 3136, 144), 64), ((32, 8, 784, 256), 128),
        ((32, 16, 3136, 64), 144), ((32, 8, 784, 128), 256)]
    for x_shape, co in shapes:
        plan = micro.ring_plan(x_shape, co, 3, sms)
        assert plan.smem <= min(limit, micro.RING_SMEM_MAX) and plan.slots >= 4
        assert plan.blocks <= sms and plan.groups == (1 if x_shape[-1] <= 256 else 2)
        assert plan.tap_groups == 1
    for x_shape, co, k in MICRO:
        if k == 15:
            plan = micro.ring_plan(x_shape, co, k, sms)
            assert (plan.taps, plan.tap_groups) == (8, 2) and plan.slots >= 9
            assert plan.smem <= min(limit, micro.RING_SMEM_MAX)
    assert micro.ring_plan((2, 4, 100, 64), 288, 3, sms)[:6] == (144, 2, 1, 1, 8, 0)


def test_micro_dw_ring_plans_fit_the_card(cuda):
    """K9's plan at every MICRO shape and the micro-benchmark's: shared
    memory within the card's opt-in limit, taps + 1 x slots and 2 g slots
    at least, at most one block an SM where the tiles fit the SMs (else one
    chunk), every tile once a chunk, and the chunks covering the items."""
    limit = torch.cuda.get_device_properties(cuda).shared_memory_per_block_optin
    sms = ops._sm_count(cuda)
    shapes = MICRO + [((32, 16, 3136, 128), 128, 3), ((32, 16, 3136, 144), 64, 3),
                      ((32, 8, 784, 256), 128, 3)]
    for x_shape, co, k in shapes:
        plan = micro.dw_ring_plan(x_shape, co, k, sms)
        assert plan.smem <= min(limit, micro.RING_SMEM_MAX)
        assert plan.xslots >= plan.taps + 1 and plan.gslots >= 2
        assert plan.blocks == plan.tiles * plan.chunks
        assert plan.blocks <= sms or plan.chunks == 1
        assert plan.chunks * plan.cols_per_chunk >= plan.cols > (
            plan.chunks - 1) * plan.cols_per_chunk
        assert plan.tap_groups * plan.taps >= k > (plan.tap_groups - 1) * plan.taps


def test_micro_kernels_take_a_misaligned_view(cuda):
    flat = torch.randn(1 + 2 * 4 * 24 * 40, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(2, 4, 24, 40)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    _, w, gy = _micro_inputs(cuda, (2, 4, 24, 40), 24, 3)
    for run, plain in MICRO_FWD.values():
        if run is not micro.temporal_dx_v3_cuda:
            _close(run(x, w, 3, 8), plain(x, w, 3, 8))
    for run, plain in MICRO_DW.values():
        ref = plain(x, gy, 3, 8)
        assert (run(x, gy, 3, 8) - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


def test_micro_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, w, gy = _micro_inputs(cuda, (1, 4, 6, 32), 8, 3)
    for run in (micro.temporal_v2_cuda, micro.temporal_v3_cuda, micro.temporal_v3p_cuda):
        with pytest.raises(ValueError, match="bfloat16"):
            run(x.float(), w, 3)
        with pytest.raises(ValueError, match="contiguous"):
            run(x.transpose(1, 2), w, 3)
        with pytest.raises(ValueError, match="CUDA tensor"):
            run(x, w.cpu(), 3)
        with pytest.raises(ValueError, match="odd"):
            run(x, w[:2].contiguous(), 2)
        with pytest.raises(ValueError, match="w must be"):
            run(x, w[:, :16].contiguous(), 3)
    with pytest.raises(ValueError, match="bfloat16"):
        micro.temporal_dx_v3_cuda(gy.float(), w, 3)
    for run in (micro.temporal_dw_v3_cuda, micro.temporal_dw_v2_cuda):
        with pytest.raises(ValueError, match="bfloat16"):
            run(x, gy.float(), 3)
        with pytest.raises(ValueError, match="contiguous"):
            run(x.transpose(1, 2), gy.transpose(1, 2), 3)
        with pytest.raises(ValueError, match="CUDA tensor"):
            run(x.cpu(), gy, 3)
        with pytest.raises(ValueError, match="share B, T, S"):
            run(x, gy[:, :2].contiguous(), 3)
        with pytest.raises(ValueError, match="odd"):
            run(x, gy, 2)
    # the routed entry points send a CUDA tensor to the kernel
    micro.reset_launch_counts()
    micro.temporal_v2(x, w, 3)
    micro.temporal_v3(x, w, 3)
    micro.temporal_dx_v3(gy, w, 3)
    micro.temporal_v3p(x, w, 3)
    micro.temporal_dw_v3(x, gy, 3)
    micro.temporal_dw_v2(x, gy, 3)
    assert micro.launch_counts == {"v2": 1, "v3": 2, "dw_v3": 1, "v3p": 1, "dw_v2": 1}


# --------------------------------------------------------------------------
# the loader-fed training path: device prefetch, checkpoints, fit
# --------------------------------------------------------------------------


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"frames": rng.integers(0, 256, (2, 4, 40, 56, 3), dtype=np.uint8),
             "labels": rng.integers(0, 3, (2,)).astype(np.int32),
             "flips": rng.uniform(size=2) < 0.5,
             "weights": rng.uniform(size=2).astype(np.float32)} for _ in range(n)]


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_device_prefetch_returns_the_host_batches(cuda, depth):
    """Bitwise the host batches, in order, on the card. The consumer writes
    into each batch (on its stream) before it takes the next one, so a
    buffer shared with a copy still in flight would show in a later batch."""
    from fastvideotagging_tpu_torch.data.pipeline import device_prefetch

    host = _host_batches(7)
    seen = []
    for batch in device_prefetch(iter(host), device=cuda, depth=depth):
        assert all(t.device.type == "cuda" for t in batch.values())
        seen.append({k: v.cpu().numpy().copy() for k, v in batch.items()})
        for t in batch.values():
            t.zero_()
        batch["frames"].add_(255)  # a long pass on the consumer's stream
    assert len(seen) == len(host)
    assert not any(t.name == "device_prefetch" for t in threading.enumerate())
    for got, want in zip(seen, host):
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert (got[k] == want[k]).all(), k


def test_checkpoint_round_trip_restores_onto_the_card(cuda, tmp_path):
    from fastvideotagging_tpu_torch import config as tconfig
    from fastvideotagging_tpu_torch.train.checkpoint import CheckpointManager
    from fastvideotagging_tpu_torch.train.loop import make_train_step
    from fastvideotagging_tpu_torch.train.state import create_train_state

    cfg = tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="tiny3d", num_classes=3),
        data=tconfig.DataConfig(resize_hw=(40, 56), crop_hw=(32, 32),
                                sampler=tconfig.ClipSamplerConfig(clip_len=4)))
    state = create_train_state(cfg, 2, device=cuda, generator=torch.Generator().manual_seed(0))
    batch = _host_batches(1)[0]
    batch.update(crop_tops=np.zeros(2, np.int32), crop_lefts=np.zeros(2, np.int32))
    state, _ = make_train_step(state.model, cfg)(state, batch)
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state, {"epoch": 0})
    fresh = create_train_state(cfg, 2, device=cuda, generator=torch.Generator().manual_seed(1))
    _, extra = mgr.restore(fresh)
    assert extra == {"epoch": 0} and fresh.step == 1
    for k, v in state.model.state_dict().items():
        got = fresh.model.state_dict()[k]
        assert got.device.type == "cuda" and torch.equal(got, v), k
    want = state.optimizer.state_dict()["state"]
    for i, s in fresh.optimizer.state_dict()["state"].items():
        assert s["momentum_buffer"].device.type == "cuda"
        assert torch.equal(s["momentum_buffer"], want[i]["momentum_buffer"])


def test_fit_runs_two_steps_on_the_card(cuda, tmp_path):
    from fastvideotagging_tpu_torch import config as tconfig
    from fastvideotagging_tpu_torch.data.packed import write_pack_from_arrays
    from fastvideotagging_tpu_torch.data.synthetic import make_frames
    from fastvideotagging_tpu_torch.train.fit import fit

    pack = str(tmp_path / "train.fvtpack")
    write_pack_from_arrays([(f"v{i}.mp4", i % 3, (), make_frames(i % 3, 20, 128, 171, seed=i))
                            for i in range(4)], pack, (128, 171))
    cfg = tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="r2plus1d_18", num_classes=3),
        data=tconfig.DataConfig(num_workers=2),
        train=tconfig.TrainConfig(batch_size=2, num_epochs=1, log_every=1,
                                  checkpoint_dir=str(tmp_path / "ckpt")))
    ops.reset_launch_counts()
    state = fit(cfg, pack, metrics_path=str(tmp_path / "m.jsonl"))
    assert state.step == 2
    assert next(state.model.parameters()).device.type == "cuda"
    # one r2plus1d_18 step launches K1 / K2 / K3 26 / 28 / 14 times
    assert ops.launch_counts["spatial_conv"] == 2 * 26
    assert ops.launch_counts["temporal_conv"] == 2 * 28
    assert ops.launch_counts["temporal_dw"] == 2 * 14
    with open(tmp_path / "m.jsonl") as f:
        assert sum('"loss"' in line for line in f) == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_2.pt"]


# --------------------------------------------------------------------------
# the train step's last knobs on the card, and the accuracy run's shapes
# --------------------------------------------------------------------------


def test_device_cache_gathers_the_loaders_frames_on_the_card(cuda, tmp_path):
    """The pack copied to the card; the rows of its index batches gathered
    there equal the loader's frames bitwise; a cache step runs the kernels."""
    from fastvideotagging_tpu_torch import config as tconfig
    from fastvideotagging_tpu_torch.data.device_cache import build_cache, train_index_batches
    from fastvideotagging_tpu_torch.data.packed import PackedDataset, write_pack_from_arrays
    from fastvideotagging_tpu_torch.data.pipeline import train_batches
    from fastvideotagging_tpu_torch.data.synthetic import make_frames
    from fastvideotagging_tpu_torch.train.loop import make_train_step
    from fastvideotagging_tpu_torch.train.state import create_train_state

    pack = str(tmp_path / "train.fvtpack")
    write_pack_from_arrays([(f"v{i}.mp4", i % 3, (), make_frames(i % 3, 6 + i, 40, 56, seed=i))
                            for i in range(5)], pack, (40, 56))
    cfg = tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="r2plus1d_18", num_classes=3),
        data=tconfig.DataConfig(resize_hw=(40, 56), crop_hw=(32, 32), num_workers=2,
                                sampler=tconfig.ClipSamplerConfig(clip_len=4, stride=2)),
        train=tconfig.TrainConfig(batch_size=2))
    ds = PackedDataset(pack, cfg.data, mode="train", seed=3)
    cache = build_cache(ds)
    assert cache.frames.device.type == "cuda" and cache.frames.dtype == torch.uint8
    for got, want in zip(train_index_batches(ds, cache, 2, 1), train_batches(ds, 2, 1,
                                                                             num_workers=2)):
        rows = torch.as_tensor(got["rows"], device=cuda).long()
        assert np.array_equal(cache.frames[rows].cpu().numpy(), want["frames"])
    counts = []
    for device_cache in (True, False):  # the same launches as a step fed by frames
        state = create_train_state(cfg, 2, device=cuda)
        step = make_train_step(state.model, cfg, device_cache=device_cache)
        ops.reset_launch_counts()
        if device_cache:
            state, metrics = step(state, next(train_index_batches(ds, cache, 2, 0)), None,
                                  cache.frames)
        else:
            state, metrics = step(state, next(train_batches(ds, 2, 0, num_workers=2)))
        assert np.isfinite(float(metrics["loss"]))
        counts.append(dict(ops.launch_counts))
    assert counts[0] == counts[1] and counts[0]["temporal_dw"] > 0


@pytest.mark.parametrize("policy", ["full", "dots", "mid", "conv"])
def test_remat_equals_none_on_the_card(cuda, policy):
    """r2plus1d_18 with reduced depth ((1, 1, 1, 1) blocks), bf16 on the
    kernels: one forward and backward under each policy against 'none' from
    the same weights. The recompute repeats the same kernels on the same
    inputs, so loss, gradients and BN statistics agree within 1e-6 of each
    tensor's largest |value|."""
    from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D

    x = torch.randn((2, 8, 32, 32, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    labels = torch.tensor([0, 2], device=cuda)
    out = {}
    for name in ("none", policy):
        model = R2Plus1D((1, 1, 1, 1), num_classes=3, remat=name,
                         generator=torch.Generator().manual_seed(1)).to(cuda).train()
        loss = torch.nn.functional.cross_entropy(model(x), labels)
        loss.backward()
        out[name] = (loss.detach(), {k: p.grad for k, p in model.named_parameters()},
                     {k: v for k, v in model.state_dict().items()
                      if k.endswith((".mean", ".var"))})
    (l0, g0, s0), (l1, g1, s1) = out["none"], out[policy]
    assert torch.allclose(l1, l0, rtol=1e-6, atol=0)
    for ref, got in ((g0, g1), (s0, s1)):
        for k, v in ref.items():
            assert (got[k].float() - v.float()).abs().max() <= 1e-6 * v.float().abs().max(), k


ACCURACY_SITES = [  # r2plus1d_18 at the hard benchmark's B = 64, 8x32x32: (B, T, H, W, C), Co
    ((64, 8, 16, 16, 64), 144), ((64, 4, 8, 8, 128), 288), ((64, 2, 4, 4, 256), 576),
    ((64, 1, 2, 2, 512), 1152),
]
ACCURACY_TEMPORAL = [((64, 8, 16, 16, 45), 64), ((64, 8, 16, 16, 144), 64),
                     ((64, 4, 8, 8, 288), 128), ((64, 2, 4, 4, 576), 256),
                     ((64, 1, 2, 2, 1152), 512)]


@pytest.mark.parametrize("x_shape,co", ACCURACY_SITES)
def test_spatial_kernel_at_the_accuracy_sites(cuda, x_shape, co):
    """K1 forward and dx at 16x16 to 2x2 frames (2x2, below k, is sent to
    F.conv3d by the model, as by the JAX routing)."""
    b, t, h, w, c = x_shape
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((b * t, h, w, c), generator=g, device=cuda).to(torch.bfloat16)
    wt = (torch.randn((3, 3, c, co), generator=g, device=cuda) / (9 * c) ** 0.5).to(
        torch.bfloat16)
    _close(ops.spatial_conv_cuda(x, wt), ops.spatial_conv_plain(x, wt))
    gy = torch.randn((b * t, h, w, co), generator=g, device=cuda).to(torch.bfloat16)
    _close(ops.spatial_conv_dx_cuda(gy, wt), ops.spatial_conv_dx_plain(gy, wt))


@pytest.mark.parametrize("x_shape,co", ACCURACY_TEMPORAL)
def test_temporal_kernels_at_the_accuracy_sites(cuda, x_shape, co):
    """K2 forward and dx and K3 at T = 8 down to T = 1 (where only the
    centre tap is in range; the model sends T = 1 to F.conv3d)."""
    b, t, h, w, c = x_shape
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((b, t, h * w, c), generator=g, device=cuda).to(torch.bfloat16)
    wt = (torch.randn((3, c, co), generator=g, device=cuda) / (3 * c) ** 0.5).to(torch.bfloat16)
    gy = torch.randn((b, t, h * w, co), generator=g, device=cuda).to(torch.bfloat16)
    _close(ops.temporal_conv_cuda(x, wt), ops.temporal_conv_plain(x, wt))
    _close(ops.temporal_conv_dx_cuda(gy, wt), ops.temporal_conv_dx_plain(gy, wt))
    dw, ref = ops.temporal_dw_cuda(x, gy, 3), ops.temporal_dw_plain(x, gy, 3)
    assert (dw - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


# The int8 engine's kernels (ops/int8_conv.py): Q1 at each of r2plus1d_18's
# int8 sites (stages 1-3 and the stem at 16x112x112, B = 2): (x shape (N, T,
# H, W, C), kernel, strides, Co, relu, out_f32, padding: None for k//2)
INT8_SITES = [
    ((2, 16, 112, 112, 3), (1, 7, 7), (1, 2, 2), 45, True, False, None),
    ((2, 16, 56, 56, 45), (3, 1, 1), (1, 1, 1), 64, True, False, None),
    ((2, 16, 56, 56, 64), (1, 3, 3), (1, 1, 1), 144, True, False, None),
    ((2, 16, 56, 56, 144), (3, 1, 1), (1, 1, 1), 64, True, False, None),
    ((2, 16, 56, 56, 144), (3, 1, 1), (1, 1, 1), 64, False, True, None),  # a block's last conv
    ((2, 16, 56, 56, 64), (1, 3, 3), (1, 2, 2), 230, True, False, None),
    ((2, 16, 28, 28, 230), (3, 1, 1), (2, 1, 1), 128, True, False, None),
    ((2, 16, 56, 56, 64), (1, 1, 1), (2, 2, 2), 128, False, True, None),  # downsample
    ((2, 8, 28, 28, 128), (1, 3, 3), (1, 1, 1), 288, True, False, None),
    ((2, 8, 28, 28, 288), (3, 1, 1), (1, 1, 1), 128, True, False, None),
    ((2, 8, 28, 28, 128), (1, 3, 3), (1, 2, 2), 460, True, False, None),
    ((2, 8, 14, 14, 460), (3, 1, 1), (2, 1, 1), 256, True, False, None),
    ((2, 8, 28, 28, 128), (1, 1, 1), (2, 2, 2), 256, False, True, None),
    ((2, 4, 14, 14, 256), (1, 3, 3), (1, 1, 1), 576, True, False, None),
    ((2, 4, 14, 14, 576), (3, 1, 1), (1, 1, 1), 256, False, True, None),
    ((2, 5, 7, 8, 3), (3, 7, 7), (2, 2, 2), 8, True, False, "same_tf"),  # I3D's stem
]
# the other covered families' int8 geometries (ops/arch_spec.py's specs) at
# narrow widths: Co and C below or off Q1's 16-channel alignment, many taps
# over C = 3, strides and TF-SAME's asymmetric pads
INT8_FAMILY_SITES = [
    ((2, 8, 32, 32, 3), (7, 7, 7), (2, 2, 2), 64, True, False, "same_tf"),  # I3D's stem, 343 taps
    ((2, 4, 8, 8, 512), (1, 1, 1), (1, 1, 1), 24, True, False, None),  # Co = 24 (I3D, S3D)
    ((2, 8, 16, 16, 16), (1, 3, 3), (1, 1, 1), 48, True, False, None),  # S3D's separable conv
    ((2, 8, 32, 32, 3), (5, 7, 7), (1, 2, 2), 8, True, False, None),  # SlowFast's fast stem
    ((2, 8, 16, 16, 8), (1, 3, 3), (1, 1, 1), 8, True, False, None),  # C = Co = 8
    ((2, 8, 16, 16, 8), (3, 1, 1), (1, 1, 1), 8, False, True, None),
    ((2, 8, 16, 16, 8), (5, 1, 1), (4, 1, 1), 16, True, False, None),  # a lateral, stride 4 in T
    ((2, 8, 16, 16, 8), (1, 1, 1), (1, 2, 2), 16, False, True, None),  # the fast pathway's down
    ((2, 8, 16, 16, 64), (3, 3, 3), (1, 1, 1), 128, True, False, None),  # C3D
    ((2, 8, 16, 16, 45), (3, 3, 3), (2, 2, 2), 24, True, False, "same_tf"),  # pads (0, 1)
]


def _bf16_ulp(t):
    """One bf16 ulp at each value of t (bf16 holds 8 significant bits)."""
    _, e = torch.frexp(t.float())
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("xs,kernel,strides,co,relu,out_f32,padding", INT8_SITES)
def test_int8_kernels_match_plain(cuda, xs, kernel, strides, co, relu, out_f32, padding):
    """Q2 against its plain version bitwise in both modes; Q1 bitwise with
    the identity epilogue (the exact int32 sums as f32) and within one bf16
    ulp with the real one."""
    _int8_kernels_match_plain(cuda, xs, kernel, strides, co, relu, out_f32, padding)


@pytest.mark.parametrize("xs,kernel,strides,co,relu,out_f32,padding", INT8_FAMILY_SITES)
def test_int8_kernels_match_plain_at_family_sites(cuda, xs, kernel, strides, co, relu, out_f32,
                                                  padding):
    """The same checks at the other families' geometries, and two launches
    of Q1 bitwise equal."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    got, args = _int8_kernels_match_plain(cuda, xs, kernel, strides, co, relu, out_f32, padding)
    assert torch.equal(got, q8.conv3d_s8_cuda(*args))


def _int8_kernels_match_plain(cuda, xs, kernel, strides, co, relu, out_f32, padding):
    from fastvideotagging_tpu_torch.ops import int8_conv as q8
    from fastvideotagging_tpu_torch.ops.arch_spec import tf_same_pads

    g = torch.Generator(device=cuda).manual_seed(sum(xs) + co)
    c = xs[-1]
    y = torch.randn(xs, generator=g, device=cuda).to(torch.bfloat16)
    inv_f = torch.rand(c, generator=g, device=cuda) * 3 + 0.1
    s = torch.tensor(0.03, device=cuda)
    before = dict(q8.launch_counts)
    q, s_out = q8.quantize_s8_cuda(y, inv_f, s)
    qd, sd = q8.quantize_s8_cuda(y, inv_f)
    torch.cuda.synchronize()
    assert q8.launch_counts["quantize_s8"] == before["quantize_s8"] + 2
    assert q8.launch_counts["quantize_s8_amax"] == before["quantize_s8_amax"] + 1
    assert torch.equal(q, q8.quantize_s8_plain(y, inv_f, s)[0]) and torch.equal(s_out, s)
    qdp, sdp = q8.quantize_s8_plain(y, inv_f)
    assert torch.equal(qd, qdp) and torch.equal(sd, sdp)
    w = torch.randint(-127, 128, kernel + (c, co), generator=g, device=cuda, dtype=torch.int8)
    wk = q8.weight_layout(w)
    if padding == "same_tf":  # asymmetric pads from the input's shape
        pads = tuple(tf_same_pads(xs[1 + i], kernel[i], strides[i]) for i in range(3))
    else:
        pads = tuple((k // 2, k // 2) for k in kernel)
    one, zero = torch.ones(co, device=cuda), torch.zeros(co, device=cuda)
    unit = torch.tensor(1.0, device=cuda)
    got = q8.conv3d_s8_cuda(q, wk, kernel, one, zero, unit, strides, pads, False, True)
    torch.cuda.synchronize()
    assert q8.launch_counts["conv3d_s8"] == before["conv3d_s8"] + 1
    assert torch.equal(got, q8.conv3d_s8_plain(q, wk, kernel, one, zero, unit, strides, pads,
                                               False, True))
    mul = torch.rand(co, generator=g, device=cuda) * 1e-3
    add = torch.randn(co, generator=g, device=cuda)
    got = q8.conv3d_s8_cuda(q, wk, kernel, mul, add, s, strides, pads, relu, out_f32)
    ref = q8.conv3d_s8_plain(q, wk, kernel, mul, add, s, strides, pads, relu, out_f32)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert ((got.float() - ref.float()).abs() <= _bf16_ulp(ref)).all()
    return got, (q, wk, kernel, mul, add, s, strides, pads, relu, out_f32)


def _fused_forms(q8, g, cuda, out_shape, co, relu):
    """Q1's fused epilogue forms at a site, as (residual, requant) pairs: a
    site with its own ReLU takes form (b) (the next site's quantize, with
    and without the bf16 kept); a block's last conv (no ReLU) form (c), each
    residual quantized or stored as bf16 alone."""
    def requant(keep):
        return q8.Requant(torch.rand(co, generator=g, device=cuda) * 3 + 0.1,
                          torch.tensor(0.06, device=cuda), keep)

    if relu:
        return [(None, requant(False)), (None, requant(True))]
    t = torch.randn(out_shape, generator=g, device=cuda).to(torch.bfloat16)
    inv_f = torch.rand(co, generator=g, device=cuda) * 3 + 0.1
    q_in, s_in = q8.quantize_s8_cuda(t, inv_f, torch.tensor(0.04, device=cuda))
    residuals = [q8.Residual("dequant", q_in, inv_f, s_in),
                 q8.Residual("f32", torch.randn(out_shape, generator=g, device=cuda) * 4),
                 q8.Residual("bf16", t)]
    return [(r, rq) for r in residuals for rq in (requant(False), None)] + [
        (residuals[2], requant(True))]


@pytest.mark.parametrize("xs,kernel,strides,co,relu,out_f32,padding",
                         INT8_SITES + INT8_FAMILY_SITES)
def test_int8_fused_forms_match_plain_and_unfused(cuda, xs, kernel, strides, co, relu, out_f32,
                                                  padding):
    """Q1's fused epilogue forms (b) and (c) at each int8 site, bit for bit
    against Q1's plain version (the composition of the plain steps) and
    against the unfused chain of kernels: Q1 in form (a), the block tail's
    torch ops on the card, Q2. Bitwise also on the card: the requant
    epilogue's and the dequant residual's multiply-adds are one rounding in
    the kernel (__fmaf_rn) and in torch's addcmul on the card."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8
    from fastvideotagging_tpu_torch.ops.arch_spec import tf_same_pads

    g = torch.Generator(device=cuda).manual_seed(sum(xs) + co + 1)
    c = xs[-1]
    y = torch.randn(xs, generator=g, device=cuda).to(torch.bfloat16)
    s = torch.tensor(0.03, device=cuda)
    q, _ = q8.quantize_s8_cuda(y, torch.rand(c, generator=g, device=cuda) * 3 + 0.1, s)
    w = torch.randint(-127, 128, kernel + (c, co), generator=g, device=cuda, dtype=torch.int8)
    wk = q8.weight_layout(w)
    if padding == "same_tf":
        pads = tuple(tf_same_pads(xs[1 + i], kernel[i], strides[i]) for i in range(3))
    else:
        pads = tuple((k // 2, k // 2) for k in kernel)
    mul = torch.rand(co, generator=g, device=cuda) * 1e-3
    add = torch.randn(co, generator=g, device=cuda)
    out_shape = q8._out_shape(q, kernel, strides, pads, co)
    for res, rq in _fused_forms(q8, g, cuda, out_shape, co, relu):
        args = (q, wk, kernel, mul, add, s, strides, pads, relu or res is not None, False, res, rq)
        before = q8.launch_counts["conv3d_s8"]
        got = q8.conv3d_s8_cuda(*args)
        torch.cuda.synchronize()
        assert q8.launch_counts["conv3d_s8"] == before + 1
        want = q8.conv3d_s8_plain(*args)
        if res is None:
            y1 = q8.conv3d_s8_cuda(q, wk, kernel, mul, add, s, strides, pads, relu, False)
        else:
            zf = q8.conv3d_s8_cuda(q, wk, kernel, mul, add, s, strides, pads, False, True)
            if res.kind == "dequant":
                z = torch.addcmul(zf, res.t[..., :co].float(), res.s / res.inv_f)
            else:
                z = zf + res.t.float()
            y1 = torch.relu(z).to(torch.bfloat16)
        form = (res and res.kind, rq and rq.keep_bf16)
        if rq is None:
            assert torch.equal(got, want) and torch.equal(got, y1), form
            continue
        chain = q8.quantize_s8_cuda(y1, rq.inv_f, rq.s)[0]
        assert got[0].shape[-1] == q8.padded_channels(co) and not got[0][..., co:].any()
        assert torch.equal(got[0], want[0]), (form, (got[0] != want[0]).sum().item())
        assert torch.equal(got[0], chain), form
        assert (got[2] is None) == (not rq.keep_bf16)
        if rq.keep_bf16:
            assert torch.equal(got[2], want[2]) and torch.equal(got[2], y1), form


def _amax_forms(q8, g, cuda, out_shape, co, relu):
    """The dynamic walk's Q1 calls with the next site's amax at a site: form
    (a) bf16 (the conv's ReLU); at a block's last conv (no ReLU) form (c)
    with each residual and the bf16 store."""
    if relu:
        return [None]
    t = torch.randn(out_shape, generator=g, device=cuda).to(torch.bfloat16)
    inv_f = torch.rand(co, generator=g, device=cuda) * 3 + 0.1
    q_in, s_in = q8.quantize_s8_cuda(t, inv_f)
    return [None, q8.Residual("dequant", q_in, inv_f, s_in),
            q8.Residual("f32", torch.randn(out_shape, generator=g, device=cuda) * 4),
            q8.Residual("bf16", t)]


@pytest.mark.parametrize("xs,kernel,strides,co,relu,out_f32,padding", INT8_SITES)
def test_int8_q1_amax_matches_plain_and_unfused(cuda, xs, kernel, strides, co, relu, out_f32,
                                                 padding):
    """Q1's bf16 output with the next site's dynamic amax reduced in its
    epilogue, at each int8 site: the bf16 output and the amax bit for bit
    against Q1's plain version and against the unfused chain (Q1's bf16
    store, then Q2's amax pass on it); a slot that holds a larger partial
    max keeps it, one that holds a smaller one takes the call's."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8
    from fastvideotagging_tpu_torch.ops.arch_spec import tf_same_pads

    g = torch.Generator(device=cuda).manual_seed(sum(xs) + co + 2)
    c = xs[-1]
    y = torch.randn(xs, generator=g, device=cuda).to(torch.bfloat16)
    s = torch.tensor(0.03, device=cuda)
    q, _ = q8.quantize_s8_cuda(y, torch.rand(c, generator=g, device=cuda) * 3 + 0.1, s)
    w = torch.randint(-127, 128, kernel + (c, co), generator=g, device=cuda, dtype=torch.int8)
    wk = q8.weight_layout(w)
    if padding == "same_tf":
        pads = tuple(tf_same_pads(xs[1 + i], kernel[i], strides[i]) for i in range(3))
    else:
        pads = tuple((k // 2, k // 2) for k in kernel)
    mul = torch.rand(co, generator=g, device=cuda) * 1e-3
    add = torch.randn(co, generator=g, device=cuda)
    inv_f = torch.rand(co, generator=g, device=cuda) * 3 + 0.1
    out_shape = q8._out_shape(q, kernel, strides, pads, co)
    for res in _amax_forms(q8, g, cuda, out_shape, co, relu):
        args = (q, wk, kernel, mul, add, s, strides, pads, relu or res is not None, False, res)
        before = dict(q8.launch_counts)
        got_y, got_a = q8.conv3d_s8_cuda(*args, None, q8.Amax(inv_f))
        torch.cuda.synchronize()
        assert q8.launch_counts["conv3d_s8"] == before["conv3d_s8"] + 1
        want_y, want_a = q8.conv3d_s8_plain(*args, None, q8.Amax(inv_f))
        chain_y = q8.conv3d_s8_cuda(*args)
        slot = q8.ScaleSlots(1, cuda).take()
        q8.quantize_s8_cuda(chain_y, inv_f, None, None, slot)
        form = res and res.kind
        assert got_y.dtype == torch.bfloat16 and torch.equal(got_y, want_y), form
        assert torch.equal(got_y, chain_y), form
        assert got_a.item() > 0 and torch.equal(got_a, want_a), (form, got_a, want_a)
        assert torch.equal(got_a, slot[0]), (form, got_a, slot[0])
        for partial in (got_a * 2, got_a * 0.5):
            out = partial.clone()
            q8.conv3d_s8_cuda(*args, None, q8.Amax(inv_f, out))
            assert torch.equal(out, torch.maximum(partial, got_a)), form


@pytest.mark.parametrize("xs,kernel,strides,co,relu,out_f32,padding", INT8_SITES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_int8_q2_given_amax_matches_plain_and_two_passes(cuda, xs, kernel, strides, co, relu,
                                                         out_f32, padding, dtype):
    """Q2's quantize pass from an amax given (the dynamic mode where Q1's
    epilogue reduced it) at each int8 site's activation: q and s bit for
    bit against its plain version and against the two passes (the amax
    pass, then the quantize pass), one launch and no amax pass; the static
    mode against its plain version."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    g = torch.Generator(device=cuda).manual_seed(sum(xs) + co + 3)
    c = xs[-1]
    y = (torch.randn(xs, generator=g, device=cuda) * 2).to(dtype)
    inv_f = torch.rand(c, generator=g, device=cuda) * 3 + 0.1
    slots = q8.ScaleSlots(2, cuda)
    two = slots.take()
    q2, s2 = q8.quantize_s8_cuda(y, inv_f, None, None, two)
    given = slots.take()
    given[0].copy_((y.float() * inv_f).abs().amax())
    before = dict(q8.launch_counts)
    q, s_out = q8.quantize_s8_cuda(y, inv_f, None, given[0], given)
    torch.cuda.synchronize()
    assert q8.launch_counts["quantize_s8"] == before["quantize_s8"] + 1
    assert q8.launch_counts["quantize_s8_amax"] == before["quantize_s8_amax"]
    assert torch.equal(two[0], given[0]) and s_out.data_ptr() == given[1].data_ptr()
    qp, sp = q8.quantize_s8_plain(y, inv_f, None, given[0])
    assert torch.equal(q, qp) and torch.equal(s_out, sp)
    assert torch.equal(q, q2) and torch.equal(s_out, s2)
    assert q.shape[-1] == q8.padded_channels(c) and not q[..., c:].any()
    st = torch.tensor(0.05, device=cuda)
    assert torch.equal(q8.quantize_s8_cuda(y, inv_f, st)[0], q8.quantize_s8_plain(y, inv_f, st)[0])


@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_int8_engine_launches_and_plain_parity(cuda, dynamic, monkeypatch):
    """One r2plus1d_18 int8 forward (2 clips, 16x112x112, 400 classes): 28
    Q1 launches; Q2 once in the static mode (the input site: every other
    quantize is fused into the conv before it) and 26 times in the dynamic
    mode, with 1 amax pass (the input site: every other amax is reduced in
    the epilogue of the conv before it); K1 / K2 for stage 4's stride-1 convs; its
    logits against the same engine with Q1 and Q2's plain versions, on the
    same qpack, within 5e-2 of the largest |logit|."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8
    from fastvideotagging_tpu_torch.ops import int8_infer

    model = get_model("r2plus1d_18", num_classes=400, device=cuda,
                      generator=torch.Generator().manual_seed(0))
    model.eval()
    sd = model.state_dict()
    x = torch.randn((2, 16, 112, 112, 3), generator=torch.Generator().manual_seed(1)).to(
        cuda).to(torch.bfloat16)
    qpack = int8_infer.quantize_variables(sd, int8_infer.calibrate(sd, [x]))
    q8.reset_launch_counts()
    ops.reset_launch_counts()
    logits = int8_infer.r2plus1d_int8_infer(qpack, x, dynamic=dynamic)
    torch.cuda.synchronize()
    assert q8.launch_counts == {"conv3d_s8": 28, "quantize_s8": 26 if dynamic else 1,
                                "quantize_s8_amax": 1 if dynamic else 0}
    assert (ops.launch_counts["spatial_conv"], ops.launch_counts["temporal_conv"]) == (3, 3)
    monkeypatch.setattr(q8, "conv3d_s8_cuda", q8.conv3d_s8_plain)
    monkeypatch.setattr(q8, "quantize_s8_cuda", q8.quantize_s8_plain)
    ref = int8_infer.r2plus1d_int8_infer(qpack, x, dynamic=dynamic)
    assert logits.shape == (2, 400) and torch.isfinite(logits).all()
    assert (logits - ref).abs().max().item() <= 5e-2 * ref.abs().max().item()


# ---------------------------------------------------------------------------
# The serving kernels as custom ops (ops/library.py) and the serving export
# (evaluation/serving.py) on the card
# ---------------------------------------------------------------------------


def _cuda_opcheck_cases():
    """Every ``fvt::*`` op on small CUDA inputs of the dtypes its kernel
    takes: K1 / K2 bf16, Q1 in each epilogue form, Q2 in its three modes
    (the dynamic ones on views of one scale buffer, as ScaleSlots hands
    them out)."""
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(4)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dev, dtype)

    def s8(*shape):
        return torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(dev)

    co = 40
    inv_f = torch.rand(co, generator=g).to(dev) + 0.5
    slots = torch.zeros((3, 2), device=dev)
    yield "spatial_conv", (rand(6, 9, 11, 48, dtype=torch.bfloat16),
                           rand(3, 3, 48, 40, dtype=torch.bfloat16))
    yield "temporal_conv", (rand(2, 5, 13, 45, dtype=torch.bfloat16),
                            rand(3, 45, 40, dtype=torch.bfloat16))
    conv = (s8(2, 4, 6, 6, 32), s8(co, 27, 32), [3, 3, 3], torch.rand(co, generator=g).to(dev)
            * 1e-3, rand(co), torch.tensor(0.05, device=dev), [1, 1, 1], [1, 1, 1, 1, 1, 1])
    res = {"": ("", None, None, None),
           "dequant": ("dequant", s8(2, 4, 6, 6, 48), inv_f, torch.tensor(0.02, device=dev)),
           "f32": ("f32", rand(2, 4, 6, 6, co), None, None),
           "bf16": ("bf16", rand(2, 4, 6, 6, co, dtype=torch.bfloat16), None, None)}
    for kind, r in res.items():
        name = kind or "plain"
        relu = not kind
        yield f"conv3d_s8[{name}]", (*conv, relu, False, *r)
        yield f"conv3d_s8[{name},f32]", (*conv, relu, True, *r)
        yield f"conv3d_s8_requant[{name}]", (*conv, relu, *r, inv_f,
                                             torch.tensor(0.03, device=dev))
        yield f"conv3d_s8_requant_bf16[{name}]", (*conv, relu, *r, inv_f,
                                                  torch.tensor(0.03, device=dev))
        yield f"conv3d_s8_amax[{name}]", (*conv, relu, *r, inv_f, slots[0, 0])
    y = rand(2, 3, 5, co, dtype=torch.bfloat16)
    yield "quantize_s8", (y, inv_f, torch.tensor(0.04, device=dev))
    yield "quantize_s8_dynamic", (y, inv_f, slots[1, 0], slots[1, 1])
    yield "quantize_s8_given", (y, inv_f, torch.tensor(3.5, device=dev), slots[2, 1])


_CUDA_OPCHECK_IDS = ["spatial_conv", "temporal_conv"] + [
    f"{op}[{kind}{suffix}]" for kind in ("plain", "dequant", "f32", "bf16")
    for op, suffix in (("conv3d_s8", ""), ("conv3d_s8", ",f32"), ("conv3d_s8_requant", ""),
                       ("conv3d_s8_requant_bf16", ""), ("conv3d_s8_amax", ""))] + [
    "quantize_s8", "quantize_s8_dynamic", "quantize_s8_given"]


@pytest.mark.parametrize("case", _CUDA_OPCHECK_IDS)
def test_opcheck_every_fvt_op_on_the_card(cuda, case):
    """``torch.library.opcheck`` (schema and mutations, the fake
    implementation against the kernel's outputs, the op under AOT dispatch)
    with CUDA inputs: the kernels, not their plain versions."""
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    args = dict(_cuda_opcheck_cases())[case]
    q8.reset_launch_counts()
    ops.reset_launch_counts()
    torch.library.opcheck(getattr(torch.ops.fvt, case.split("[")[0]), args)
    torch.cuda.synchronize()
    assert sum(q8.launch_counts.values()) + sum(ops.launch_counts.values()) > 0


def _launches():
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    torch.cuda.synchronize()
    return {**q8.launch_counts, "spatial_conv": ops.launch_counts["spatial_conv"],
            "temporal_conv": ops.launch_counts["temporal_conv"]}


def _reset_launches():
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    torch.cuda.synchronize()
    q8.reset_launch_counts()
    ops.reset_launch_counts()


@pytest.mark.parametrize("engine", ["bf16", "int8", "int8_dynamic"])
def test_export_on_the_card_matches_the_eager_engine(cuda, engine, tmp_path):
    """r2plus1d_18 (5 classes, bf16) at 4x32x32 clips from 40x56 frames:
    ``export_serving`` -> ``load_serving`` on the card gives the eager
    serving fn's scores bit for bit, with the same kernel launches a
    forward (bf16: K1 / K2; int8: Q1 / Q2, the dynamic engine's in-place
    amax reductions included)."""
    from fastvideotagging_tpu_torch.config import (
        ClipSamplerConfig,
        DataConfig,
        ExperimentConfig,
        ModelConfig,
    )
    from fastvideotagging_tpu_torch.evaluation import serving

    cfg = ExperimentConfig(
        model=ModelConfig(name="r2plus1d_18", num_classes=5, multilabel=True, dropout=0.0),
        data=DataConfig(resize_hw=(40, 56), crop_hw=(32, 32),
                        sampler=ClipSamplerConfig(clip_len=4)))
    sd = get_model("r2plus1d_18", num_classes=5, device=cuda,
                   generator=torch.Generator().manual_seed(0)).state_dict()
    clips = torch.randint(0, 256, (2, 4, 40, 56, 3), generator=torch.Generator().manual_seed(1),
                          dtype=torch.uint8)
    qpack = (serving.quantize_for_serving(cfg, sd, [clips.numpy()], device=cuda)
             if engine != "bf16" else None)
    fn = serving.ServingFn(cfg, sd, qpack=qpack, device=cuda, dynamic=engine == "int8_dynamic")
    x = clips.to(cuda)
    with torch.no_grad():
        fn(x)  # builds the kernels
        _reset_launches()
        want = fn(x)
        eager = _launches()
        program = torch.export.export(fn, (x,))
    path = str(tmp_path / "serving.pt2")
    torch.export.save(program, path)
    run = serving.load_serving(path)
    _reset_launches()
    got = run(clips.numpy())
    loaded = _launches()
    assert got.device.type == "cuda" and got.shape == (2, 5)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert loaded == eager
    if engine == "bf16":
        assert loaded["spatial_conv"] > 0 and loaded["temporal_conv"] > 0
    else:
        assert loaded["conv3d_s8"] == 28
        assert (loaded["quantize_s8"], loaded["quantize_s8_amax"]) == (
            (26, 1) if engine == "int8_dynamic" else (1, 0))


# ---------------------------------------------------------------------------
# parallelism: two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

_HALO_ON_CARD = r"""
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.parallel import temporal as tp
import torch.distributed as dist
data = torch.load(os.path.join(work, "inputs.pt"))
x, w, gy = (data[k].to(mesh.device) for k in ("x", "w", "gy"))
group = mesh.group
out["transport"] = tp.halo_transport(group, x.device)
xl = tp.time_shard(x, group).clone().requires_grad_(True)
wl = w.clone().requires_grad_(True)
ops.reset_launch_counts()
y = tp.halo_temporal_conv(xl, wl, group)
y.backward(tp.time_shard(gy, group))
torch.cuda.synchronize()
out["launches"] = dict(ops.launch_counts)
out["halo"] = dict(tp.halo_counts)
parts = [torch.empty_like(y) for _ in range(world)]
dist.all_gather(parts, y.detach().contiguous(), group=group)
out["y"] = torch.cat(parts, 1).cpu()
parts = [torch.empty_like(xl.grad) for _ in range(world)]
dist.all_gather(parts, xl.grad.contiguous(), group=group)
out["dx"] = torch.cat(parts, 1).cpu()
dw = wl.grad.float()
dist.all_reduce(dw, group=group)
out["dw"] = dw.cpu()
"""


def test_halo_conv_on_the_card_over_gloo(cuda, tmp_path):
    """Two ranks sharing the card over a gloo group (gloo's point-to-point
    takes no CUDA tensors: the halos go through the host): the halo conv of
    a 16-frame clip, 8 frames a rank, runs K2 over each 10-frame slab and
    K2's dx and K3 in the backward, and equals the unsharded conv (f32
    F.conv3d from the same bf16 inputs) within 1e-2 of each output's
    largest magnitude, gradients too."""
    from test_torch_port_multiproc import RankJob

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, 28, 28, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(3, 64, 128, generator=g) / 14).to(torch.bfloat16)
    gy = torch.randn(2, 16, 28, 28, 128, generator=g).to(torch.bfloat16)
    torch.save({"x": x, "w": w, "gy": gy}, tmp_path / "inputs.pt")
    job = RankJob(2, _HALO_ON_CARD, tmp_path, device="cuda", timeout=300)
    res = job.results()
    xf = x.to(cuda).float().requires_grad_(True)
    wf = w.to(cuda).float().requires_grad_(True)
    yf = ops.conv3d_nthwc(xf, wf[:, None, None], (1, 1, 1), (1, 0, 0))
    yf.backward(gy.to(cuda).float())
    for r in res:
        assert r["transport"] == "host"
        assert r["halo"]["k2_slabs"] == 1
        assert r["launches"]["temporal_conv"] == 2 and r["launches"]["temporal_dw"] == 1
        for got, ref in ((r["y"], yf), (r["dx"], xf.grad), (r["dw"], wf.grad)):
            ref = ref.detach().cpu()
            err = (got.float() - ref).abs().max().item()
            assert err <= TOL * ref.abs().max().item(), err


def test_sync_and_step_timer_on_the_card(cuda):
    """``sync`` waits for the card (its stream is idle after), and
    ``StepTimer`` counts as on the host with a positive time a step."""
    from fastvideotagging_tpu_torch.utils.profiling import StepTimer, sync

    a = torch.randn(2048, 2048, device=cuda)
    timer = StepTimer(warmup=2, sync_every=3)
    for _ in range(11):
        for _ in range(8):
            a = torch.tanh(a @ a)
        timer.step({"out": [a]})
    sync({"out": (a,)})
    assert torch.cuda.current_stream().query()
    assert timer.timed_steps == 9 and timer.seconds_per_step > 0


def test_step_profiler_places_every_hand_kernel_on_the_card(cuda, tmp_path):
    """A small r2plus1d_18 train step and int8 forward, traced: the device
    time attributed equals the busy time within 2 %, and every K1-K3, Q1
    and Q2 launch lies under a conv site."""
    from fastvideotagging_tpu_torch.utils import step_profiler as sp

    for run in (lambda d: sp.profile_train_step(batch_size=2, clip_len=8, crop=32,
                                                source_hw=(36, 40), n_steps=2, trace_dir=d),
                lambda d: sp.profile_eval_step(batch_size=2, clip_len=8, crop=32, n_steps=2,
                                               trace_dir=d, int8="dynamic")):
        for attempt in range(3):
            try:
                rows, cats, info = run(str(tmp_path / f"t{attempt}"))
                break
            except RuntimeError as e:
                if "no device activity" not in str(e) or attempt == 2:
                    raise
        assert info["steps_captured"] == 2 and info["hand_kernels"] > 0
        assert not info["hand_kernels_unplaced"]
        assert abs(info["attributed_us_per_step"] - info["device_us_per_step"]) <= \
            0.02 * info["device_us_per_step"]


# The serving forwards as captured CUDA graphs (evaluation/graphed.py).

def _graph_counts():
    from fastvideotagging_tpu_torch.ops import int8_conv as q8

    torch.cuda.synchronize()
    return {**{k: ops.launch_counts[k] for k in ("spatial_conv", "temporal_conv")},
            **q8.launch_counts}


def _delta(before):
    return {k: v - before[k] for k, v in _graph_counts().items()}


def test_graphed_bf16_forward_matches_the_eager_walk(cuda):
    """r2plus1d_18 bf16 at 8 clips through Tagger's graphed forward: bit for
    bit the eager walk's scores (its library calls pick the same algorithms
    under capture as outside it), K1 / K2 launches of k replays equal to k
    eager walks, a call on other clips leaving the last result as it was,
    one capture for the fixed chunk shape."""
    from fastvideotagging_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig
    from fastvideotagging_tpu_torch.evaluation.tagger import Tagger

    cfg = ExperimentConfig(model=ModelConfig(name="r2plus1d_18", num_classes=5),
                           data=DataConfig(resize_hw=(36, 40), crop_hw=(32, 32)))
    state = get_model("r2plus1d_18", num_classes=5, device="cpu",
                      generator=torch.Generator().manual_seed(0)).state_dict()
    tagger = Tagger(cfg, state, clip_batch=8, device=cuda)
    fwd = tagger._bf16_apply
    g = torch.Generator(device=cuda).manual_seed(0)
    x, x2 = (torch.randn((8, 8, 32, 32, 3), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    with torch.inference_mode():
        first = fwd(x)  # the warm-up's result; the graph is captured after it
        before = _graph_counts()
        eager = fwd.fn(x)
        walk = _delta(before)
        before = _graph_counts()
        outs = [fwd(x) for _ in range(3)]
        assert _delta(before) == {k: 3 * v for k, v in walk.items()}
        kept = outs[-1].clone()
        other, other_eager = fwd(x2), fwd.fn(x2)
        torch.cuda.synchronize()
    assert walk["spatial_conv"] > 0
    assert torch.equal(outs[-1], kept)  # a clone: the next replay left it alone
    for out in [first] + outs:
        assert torch.equal(out, eager), float((out - eager).abs().max())
    assert torch.equal(other, other_eager) and not torch.equal(other, eager)
    assert fwd.captures == 1


@pytest.mark.parametrize("name", ["i3d", "s3d"])
@pytest.mark.parametrize("dynamic", [False, True], ids=["static", "dynamic"])
def test_graphed_int8_engine_matches_the_eager_walk(cuda, name, dynamic):
    """``make_int8_engine`` on the card (2 clips, 8x32x32): every replay bit
    for bit the eager walk, Q1 / Q2 launches of k replays equal to k eager
    walks, a call on other clips leaving the first call's result as it was,
    a second qpack copied in (its own scores, no second capture) and the
    first served again after it."""
    from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_engine, quantize_for

    model = get_model(name, num_classes=5, device="cpu",
                      generator=torch.Generator().manual_seed(0)).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(1)
    x, x2 = (torch.randn((2, 8, 32, 32, 3), generator=g, device=cuda).to(torch.bfloat16)
             for _ in range(2))
    sd = model.state_dict()
    qpack, qpack2 = quantize_for(name, sd, [x]), quantize_for(name, sd, [x2])
    engine = make_int8_engine(name, dynamic=dynamic)
    with torch.inference_mode():
        first = engine(qpack, x)
        before = _graph_counts()
        eager = engine.fn(qpack, x)
        walk = _delta(before)
        before = _graph_counts()
        outs = [engine(qpack, x) for _ in range(3)]
        replays = _delta(before)
        kept = outs[-1].clone()
        other = engine(qpack, x2)
        other_eager = engine.fn(qpack, x2)
        second = engine(qpack2, x)
        second_eager = engine.fn(qpack2, x)
        back = engine(qpack, x)
        torch.cuda.synchronize()
    assert walk["conv3d_s8"] > 0 and replays == {k: 3 * v for k, v in walk.items()}
    for out in [first] + outs + [back]:
        assert torch.equal(out, eager)
    assert torch.equal(outs[-1], kept) and torch.equal(other, other_eager)
    assert torch.equal(second, second_eager) and not torch.equal(second, eager)
    assert engine.captures == 1


def test_graphed_capture_failure_raises(cuda):
    """A forward that syncs the host (``.item()``) cannot be captured: the
    call raises, naming the forward and the step, and falls back to
    nothing."""
    from fastvideotagging_tpu_torch.evaluation.graphed import Graphed

    fwd = Graphed(lambda x: x * float(x.sum().item()), "the syncing forward")
    with pytest.raises(RuntimeError, match="the syncing forward: the CUDA graph's capture"):
        fwd(torch.ones(4, device=cuda))
