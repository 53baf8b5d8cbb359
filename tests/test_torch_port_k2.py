"""K2 (the temporal k x 1 x 1 conv, csrc/spatial_conv.cu) off the card: its
launch plans at every path site, its arithmetic as the kernels index it, its
ctypes binding, and the even-k convs that the kernels refuse.

K2 is K1's implicit GEMM: rows m = (b*T + t)*S + s, kappa = tap*cp + c,
the weight K-major (``temporal_weight_layout_plain``), the taps read in
reverse for dx, x's channels zero-padded to cp (a multiple of 8) by the
kernel's pad pass where they are not. The emulation below indexes x that
way and is held to the plain version and to the library's conv, in f32,
tolerance 1e-4 (tests/test_ops_pallas.py:51).
"""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fastvideotagging_tpu.models.layers import symmetric_padding
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import conv2plus1d as tops

TOL = 1e-4


def _inputs(x_shape, w_shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=x_shape).astype(np.float32)
    w = (rng.normal(size=w_shape) / np.sqrt(np.prod(w_shape[:-1]))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _k2_sites(b):
    """r2plus1d_18's K2 sites at 16x112x112: (role, x (B, T, S, C), Co) of
    the forward, and of its dx (C and Co swapped)."""
    sites = [("fwd", (b, 16, 3136, 45), 64), ("dx", (b, 16, 3136, 64), 45)]
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        m = r2plus1d_mid_channels(c, c)
        sites += [("fwd", (b, t, hw * hw, m), c), ("dx", (b, t, hw * hw, c), m)]
    return sites


@pytest.mark.parametrize("b", [8, 32])
def test_temporal_plan_at_every_path_site(b):
    for role, xs, co in _k2_sites(b):
        plan = tops.temporal_plan(xs, co, 3)
        # the blocks the plan counts on fit an SM's 228 KB, 1 KB reserved each
        assert plan.blocks_per_sm >= 2, (role, xs)
        assert plan.blocks_per_sm * (plan.smem_bytes + 1024) <= tops.SMEM_PER_SM
        assert plan.smem_bytes <= tops.SMEM_LIMIT
        # the column tile covers Co in one tile or divides it
        assert (plan.col_tiles == 1 and co <= plan.bn) or co % plan.bn == 0, (role, xs, co)
        rows = xs[0] * xs[1] * xs[2]
        assert (plan.row_tiles - 1) * 128 < rows <= plan.row_tiles * 128
        assert plan.cp == -(-xs[-1] // 8) * 8  # the stem's 45 padded to 48, the rest as they are
        tiles = plan.row_tiles * plan.col_tiles
        assert plan.grid == tiles * plan.splits
        slices = -(-3 * plan.cp // 64)
        if tiles >= 132:
            assert plan.splits == 1
        else:  # the contraction split until the card is full, in chunks of >= 8 slices
            assert plan.grid >= 132 or slices // (plan.splits + 1) < 8
            assert slices // plan.splits >= 8
    # stage 4 at 8 clips: 7 row tiles x 4 column tiles, its 54 slices in 5 chunks
    plan = tops.temporal_plan((8, 2, 49, 1152), 512, 3)
    assert (plan.row_tiles, plan.col_tiles, plan.splits) == (7, 4, 5)
    # the dx of stage 1: Co = 144 in one tile (the WMMA K2 ran 3 tiles of 64)
    plan = tops.temporal_plan((8, 16, 3136, 64), 144, 3)
    assert (plan.bn, plan.col_tiles) == (144, 1)
    # K1 and K2 share the rule: the same rows, taps and widths, the same plan
    assert tops.temporal_plan((8, 16, 3136, 64), 144, 3) == tops._taps_plan(
        8 * 16 * 3136, 64, 144, 3, tops.SMS)


def _k2_emulated(x, wk, co, k, flip):
    """K2's tile GEMM as the kernel indexes it, in plain tensors: row m =
    (b*T + t)*S + s, kappa = tap*cp + c; A[m, kappa] is x's row m + (tap -
    p)*S (element (m + (tap - p)*S)*cp + c of the flat x), zero where t +
    tap - p falls outside [0, T); B[kappa, n] = wk[n, tap (reversed when
    flip), c]."""
    b, t, s, c = x.shape
    cp = wk.shape[-1]
    rows, p = b * t * s, k // 2
    xf = x.reshape(-1)
    m = torch.arange(rows)
    frame = (m // s) % t
    a = torch.zeros((rows, k * cp), dtype=x.dtype)
    for tap in range(k):
        d = tap - p
        inside = (frame + d >= 0) & (frame + d < t)
        start = (m[inside] + d * s) * c
        a[inside, tap * cp: tap * cp + c] = xf[start[:, None] + torch.arange(c)]
    w = (wk.flip(1) if flip else wk).reshape(co, k * cp)
    return (a @ w.T).reshape(b, t, s, co)


@pytest.mark.parametrize("shape,co,k", [
    ((2, 5, 13, 45), 64, 3),    # the stem's C = 45, padded to 48
    ((2, 6, 7, 144), 64, 3),    # stage 1's widths: no padding
    ((1, 7, 9, 40), 24, 5),     # k = 5
    ((2, 4, 5, 36), 19, 3),     # Co ragged
])
@pytest.mark.parametrize("dx", [False, True])
def test_k2_arithmetic_matches_plain(shape, co, k, dx):
    """K2's K-major weights (for dx straight from the forward weight, taps
    read in reverse) and its indexing of x give the plain version's result,
    and the library's conv and conv3d_input; the dx cases take Co = 45 as
    their output where the forward has C = 45."""
    b, t, s, c = shape
    x, w = _inputs((b, t, s, co if dx else c), (k, c, co), seed=3)
    out = c if dx else co
    wk = tops.temporal_weight_layout_plain(w, dx=dx)
    xk = tops._pad_channels(x)  # what the kernel's pad pass writes
    assert wk.shape == (out, k, xk.shape[-1]) and wk.is_contiguous()
    got = _k2_emulated(xk, wk, out, k, flip=dx)
    conv_w = w.permute(2, 1, 0)[..., None, None]  # (Co, C, k, 1, 1)
    if dx:
        ref = tops.temporal_conv_dx_plain(x, w)
        lib = torch.nn.grad.conv3d_input((b, c, t, s, 1), conv_w, x.permute(0, 3, 1, 2)[..., None],
                                         padding=(k // 2, 0, 0))
    else:
        ref = tops.temporal_conv_plain(x, w)
        lib = torch.nn.functional.conv3d(x.permute(0, 3, 1, 2)[..., None], conv_w,
                                         padding=(k // 2, 0, 0))
    torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)
    torch.testing.assert_close(ref, lib[..., 0].permute(0, 2, 3, 1), rtol=TOL, atol=TOL)


def test_temporal_conv_argtypes_match_its_c_signature():
    """The ctypes binding of K2's entry point has one type per parameter of
    the C function, in the same kinds (pointers, 64-bit and 32-bit ints)."""
    with open(os.path.join(_build.CSRC, "spatial_conv.cu")) as f:
        src = f.read()
    params = re.search(r"int fvt_temporal_conv_bf16\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    assert tops._K2_ARGTYPES == [kind(q) for q in params]
    assert len(params) == 21


# Even k: the kernels take odd k only, and the port sends an even k to the
# library conv with k // 2 frames (pixels) on both sides, as the JAX
# package's XLA route (models/layers.py, symmetric_padding) does: T + 1
# frames out (H + 1, W + 1 pixels). The JAX package's Pallas route returns
# T, but its custom VJP's dx (the forward on flipped weights with the same
# k // 2 padding) is the gradient only for odd k; the port holds even k to
# the XLA route.
@pytest.mark.parametrize("k", [2, 4])
def test_even_k_temporal_conv_matches_the_jax_xla_route(k):
    x, w = _inputs((1, 4, 2, 2, 32), (k, 32, 8), seed=4)
    assert not tops.temporal_eligible(x.shape, k, 1)
    ref = lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy())[:, None, None], (1, 1, 1),
        symmetric_padding((k, 1, 1)), dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    got = tops.temporal_conv(x, w)
    assert got.shape == ref.shape == (1, 5, 2, 2, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k", [2, 4])
def test_even_k_spatial_conv_matches_the_jax_xla_route(k):
    x, w = _inputs((1, 2, 6, 6, 32), (k, k, 32, 8), seed=5)
    assert not tops.spatial_eligible(x.shape, k, 1)
    ref = lax.conv_general_dilated(
        jnp.asarray(x.numpy()), jnp.asarray(w.numpy())[None], (1, 1, 1),
        symmetric_padding((1, k, k)), dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))
    got = tops.spatial_conv(x, w)
    assert got.shape == ref.shape == (1, 2, 7, 7, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL, atol=TOL)
