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
and to two bitwise-equal launches.
"""

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
# width at 2 clips.
MICRO = [
    ((2, 5, 13, 45), 19, 3), ((1, 7, 9, 40), 24, 5), ((3, 2, 24, 32), 8, 3),
    ((2, 1, 24, 40), 24, 3), ((1, 4, 33, 63), 45, 5), ((2, 16, 196, 144), 64, 3),
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
    """More (b, s-tile) steps than twice the SMs: several steps a chunk,
    the last chunk shorter; one step: a single chunk written directly."""
    for x_shape, co, tile in (((300, 2, 8, 16), 16, 1), ((1, 3, 32, 24), 8, 32)):
        x, _, gy = _micro_inputs(cuda, x_shape, co, 3)
        # both tile rules give `tile` here
        plan = micro.dw_plan(x_shape, co, tile, ops._sm_count(cuda))
        assert (plan.chunks > 1) == (x_shape[0] == 300)
        for run, plain in MICRO_DW.values():
            got = run(x, gy, 3, tile)
            ref = plain(x, gy, 3, tile)
            assert torch.equal(got, run(x, gy, 3, tile))
            assert (got - ref).abs().max().item() <= DW_TOL * ref.abs().max().item()


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
