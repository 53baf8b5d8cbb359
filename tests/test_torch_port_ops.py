"""The port's (2+1)D conv ops against the JAX package's Pallas kernels.

On CPU tensors the port's ``spatial_conv`` / ``temporal_conv`` take the
plain versions of K1 / K2 (``*_plain``); the JAX functions run their Pallas
kernels in interpret mode, as tests/test_ops_pallas.py does. Inputs come from
a numpy seed; f32, tolerance 1e-4 (tests/test_ops_pallas.py:51). The plain
versions are also held to ``F.conv3d``, the library yardstick.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.ops import conv2plus1d as jops
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import conv2plus1d as tops

TOL = 1e-4


def _inputs(x_shape, w_shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    fan_in = int(np.prod(w_shape[:-1]))
    w = (rng.normal(size=w_shape) / np.sqrt(fan_in)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape,co,k,stride", [
    ((1, 2, 8, 8, 45), 40, 3, 1),     # C not a multiple of 8, Co not of 16
    ((1, 2, 6, 7, 144), 64, 3, 1),    # the stage-1 mid width
    ((2, 1, 8, 8, 32), 24, 5, 1),     # k = 5
    ((1, 2, 9, 8, 64), 40, 3, 2),     # strided: the library conv
    ((1, 2, 8, 8, 3), 16, 7, 2),      # the stem: 3 channels, stride 2
])
def test_spatial_conv_matches_jax(shape, co, k, stride):
    x, w = _inputs(shape, (k, k, shape[-1], co))
    ref = np.asarray(jops.spatial_conv(x, w, stride=stride))
    got = tops.spatial_conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k,stride", [
    ((1, 4, 3, 5, 45), 64, 3, 1),     # the stem's temporal conv: C = 45
    ((2, 3, 2, 4, 144), 40, 3, 1),    # C = 144, Co not a multiple of 16
    ((1, 5, 4, 4, 32), 24, 5, 1),     # k = 5
    ((1, 8, 4, 4, 64), 32, 3, 2),     # strided: the library conv
    ((1, 1, 4, 4, 64), 32, 3, 1),     # T = 1: the library conv
])
def test_temporal_conv_matches_jax(shape, co, k, stride):
    x, w = _inputs(shape, (k, shape[-1], co))
    ref = np.asarray(jops.temporal_conv(x, w, stride=stride))
    got = tops.temporal_conv(torch.from_numpy(x), torch.from_numpy(w), stride=stride)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [((3, 7, 9, 45), 21, 3), ((2, 5, 5, 36), 8, 5)])
def test_spatial_plain_matches_conv3d(shape, co, k):
    x, w = _inputs(shape, (k, k, shape[-1], co), seed=1)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = F.conv2d(xt.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1), padding=k // 2)
    got = tops.spatial_conv_plain(xt, wt)
    torch.testing.assert_close(got, ref.permute(0, 2, 3, 1), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape,co,k", [((2, 6, 10, 45), 19, 3), ((1, 3, 4, 40), 8, 5)])
def test_temporal_plain_matches_conv3d(shape, co, k):
    x, w = _inputs(shape, (k, shape[-1], co), seed=2)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    # (B, T, S, C) -> (B, C, T, S, 1) for a k x 1 x 1 conv3d
    ref = F.conv3d(xt.permute(0, 3, 1, 2)[..., None],
                   wt.permute(2, 1, 0)[..., None, None], padding=(k // 2, 0, 0))
    got = tops.temporal_conv_plain(xt, wt)
    torch.testing.assert_close(got, ref[..., 0].permute(0, 2, 3, 1), rtol=TOL, atol=TOL)


def test_eligibility_mirrors_jax_routing():
    # the JAX routing (ops/conv2plus1d.py:181, 333) without its VMEM-halo term
    assert tops.spatial_eligible((1, 2, 8, 8, 32), 3, 1)
    assert not tops.spatial_eligible((1, 2, 8, 8, 31), 3, 1)
    assert not tops.spatial_eligible((1, 2, 8, 8, 64), 3, 2)
    assert not tops.spatial_eligible((1, 2, 2, 8, 64), 3, 1)
    assert tops.temporal_eligible((1, 2, 1, 1, 45), 3, 1)
    assert not tops.temporal_eligible((1, 1, 4, 4, 64), 3, 1)
    assert not tops.temporal_eligible((1, 4, 4, 4, 64), 3, 2)


def test_kernel_wrappers_reject_cpu_tensors():
    x = torch.zeros((1, 4, 4, 32), dtype=torch.bfloat16)
    before = dict(tops.launch_counts)
    with pytest.raises(ValueError, match="CUDA"):
        tops.spatial_conv_cuda(x, torch.zeros((3, 3, 32, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.spatial_conv_dx_cuda(x[..., :8].contiguous(),
                                  torch.zeros((3, 3, 32, 8), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.temporal_conv_cuda(x, torch.zeros((3, 32, 8), dtype=torch.bfloat16))
    assert tops.launch_counts == before


def test_cpu_route_takes_plain_version_without_a_launch():
    tops.reset_launch_counts()
    x, w = _inputs((1, 3, 5, 5, 32), (3, 3, 32, 16))
    tops.spatial_conv(torch.from_numpy(x), torch.from_numpy(w))
    tops.temporal_conv(torch.from_numpy(x), torch.from_numpy(w[0]))
    assert tops.launch_counts == {"spatial_conv": 0, "temporal_conv": 0, "temporal_dw": 0,
                                  "fused_block": 0}


def _k1_sites(b):
    """r2plus1d_18's K1 sites at 16x112x112: (x (N, H, W, C), Co) of the
    forward, and of its dx (C and Co swapped)."""
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        yield "fwd", (b * t, hw, hw, c), m
        yield "dx", (b * t, hw, hw, m), c


# the column tile: Co covered or divided with as few tiles as the kernel's
# instances allow
_K1_BN = {144: 144, 288: 144, 576: 144, 1152: 144, 64: 64, 128: 128, 256: 128, 512: 128}


@pytest.mark.parametrize("b", [8, 32])
def test_spatial_plan_at_every_path_site(b):
    for role, xs, co in _k1_sites(b):
        plan = tops.spatial_plan(xs, co, 3)
        # two blocks share an SM: its 228 KB, 1 KB of it reserved per block
        assert 2 * (plan.smem_bytes + 1024) <= 233_472, (role, xs)
        assert plan.bn % 8 == 0 and plan.bn <= 256 and plan.bn == _K1_BN[co]
        rows = xs[0] * xs[1] * xs[2]
        assert (plan.row_tiles - 1) * 128 < rows <= plan.row_tiles * 128
        assert (plan.col_tiles - 1) * plan.bn < co <= plan.col_tiles * plan.bn
        assert co % plan.bn == 0 and xs[-1] % 8 == 0  # no path site is ragged or padded
        tiles = plan.row_tiles * plan.col_tiles
        assert plan.grid == tiles * plan.splits
        slices = -(-9 * xs[-1] // 64)
        if tiles >= 132:
            assert plan.splits == 1
        else:  # the contraction split until the card is full, in chunks of >= 8 slices
            assert plan.grid >= 132 or slices // (plan.splits + 1) < 8
            assert slices // plan.splits >= 8
    # stage 4 at 8 clips: 7 row tiles x 8 column tiles, the 72 slices in 3 chunks
    assert tops.spatial_plan((16, 7, 7, 512), 1152, 3).splits == 3
    assert tops.spatial_plan((16, 7, 7, 512), 1152, 3, sms=56).splits == 1


@pytest.mark.parametrize("shape,co,k,splits", [
    ((2, 9, 11, 48), 40, 3, 1),   # 7 slices: too few to split
    ((1, 9, 9, 256), 21, 3, 4),   # 36 slices, one tile
    ((1, 6, 5, 40), 8, 5, 2),     # k = 5: 25 taps of 40 channels, 16 slices
    ((2, 9, 11, 48), 300, 3, 1),  # Co divided by no tile
])
def test_spatial_plan_takes_ragged_widths(shape, co, k, splits):
    plan = tops.spatial_plan(shape, co, k)
    assert plan.col_tiles * plan.bn >= co and plan.smem_bytes <= tops.SMEM_LIMIT
    assert plan.splits == splits


def _k1_emulated(x, wk, co, k, flip):
    """K1's arithmetic as the kernel indexes it, in plain tensors: row m,
    kappa = tap * C + c; A[m, kappa] is x at the tap's shifted pixel (zero
    outside the frame), B[kappa, n] = wk[n, tap (reversed when flip), c]."""
    n, h, w, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    a = torch.cat([xp[:, dh:dh + h, dw:dw + w] for dh in range(k) for dw in range(k)], -1)
    b = (wk.flip(1) if flip else wk).reshape(co, k * k * c).T
    return (a.reshape(n * h * w, k * k * c) @ b).reshape(n, h, w, co)


@pytest.mark.parametrize("shape,co,k", [
    ((2, 6, 7, 64), 144, 3),   # the stage-1 widths: no padding
    ((3, 5, 9, 45), 40, 3),    # C = 45 padded to 48
    ((1, 4, 3, 36), 21, 5),    # k = 5, Co ragged
])
@pytest.mark.parametrize("dx", [False, True])
def test_k1_operands_match_plain(shape, co, k, dx):
    """K1's K-major weights (for dx straight from the forward weight, taps
    read in reverse) and zero-padded channels give the plain version's
    result through K1's indexing."""
    n, h, w, c = shape
    x, wt = _inputs((n, h, w, co if dx else c), (k, k, c, co), seed=3)
    x, wt = torch.from_numpy(x), torch.from_numpy(wt)
    xk, wk = tops._pad_channels(x), tops.spatial_weight_layout_plain(wt, dx=dx)
    out = c if dx else co
    assert xk.shape[-1] % 8 == 0 and wk.shape == (out, k * k, xk.shape[-1])
    assert wk.is_contiguous() and torch.equal(xk[..., :x.shape[-1]], x)
    got = _k1_emulated(xk, wk, out, k, flip=dx)
    if dx:
        ref = tops.spatial_conv_dx_plain(x, wt)
        # and the dx of the forward conv, by the library
        lib = torch.nn.grad.conv2d_input((n, c, h, w), wt.permute(3, 2, 0, 1),
                                         x.permute(0, 3, 1, 2), padding=k // 2)
        torch.testing.assert_close(ref, lib.permute(0, 2, 3, 1), rtol=TOL, atol=TOL)
    else:
        ref = tops.spatial_conv_plain(x, wt)
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
