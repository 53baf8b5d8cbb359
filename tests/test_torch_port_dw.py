"""K3's launch plan and schedule on the CPU (the kernel itself runs only on
the card: tests/test_torch_port_gpu.py).

``temporal_dw_plan`` is held to the kernel's limits at every r2plus1d_18
site of K3 (the stem's temporal conv and the four stages' stride-1 ones, at
16x112x112) at 8 and 32 clips: its tiles cover C and Co, its chunks cover
the stream of slabs, its shared memory fits, its accumulators fit the
register file. Then the kernel's schedule, written out here in plain
tensors in the plan's order (tiles, chunks of the slab stream, the t walk,
taps skipped at the T edges, partials added in chunk order), is held to
``temporal_dw_plain`` and to the JAX package's Pallas ``_temporal_dw`` (as
tests/test_torch_port_grads.py runs it) within 1e-3 of the largest |dw|:
the two differ by summation order only. f32 inputs from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.ops import conv2plus1d as jops
from fastvideotagging_tpu_torch.ops import conv2plus1d as tops

TOL = 1e-3
SMEM_PER_SM = 233_472  # an H100 SM's 228 KB, of which 1 KB is reserved per block
REGISTERS_PER_SM = 65_536
THREADS = 384  # three warpgroups, one per tap of a block


def _k3_sites(b):
    """K3's sites in one r2plus1d_18 training step at 16x112x112: x (B, T,
    S, C), Co, launches."""
    yield (b, 16, 3136, 45), 64, 1  # the stem's temporal conv
    t, hw = 16, 56
    for stage in range(4):
        c = 64 * 2 ** stage
        if stage:
            t, hw = t // 2, hw // 2
        mid = {64: 144, 128: 288, 256: 576, 512: 1152}[c]
        yield (b, t, hw * hw, mid), c, 4 if stage == 0 else 3


def _check_plan(plan, x_shape, co, k, sms):
    b, t, s, c = x_shape
    cp, cop = -(-c // 8) * 8, -(-co // 8) * 8
    assert (plan.c_tiles - 1) * plan.bn < cp <= plan.c_tiles * plan.bn
    assert (plan.co_tiles - 1) * 64 < cop <= plan.co_tiles * 64
    assert (plan.tap_groups - 1) * 3 < k <= plan.tap_groups * 3
    assert plan.tile_s % 16 == 0  # whole k16 steps of wgmma
    assert plan.columns == -(-b * s // plan.tile_s) and plan.steps == plan.columns * t
    spc = plan.steps_per_chunk
    assert plan.chunks * spc >= plan.steps > (plan.chunks - 1) * spc  # no empty chunk
    assert plan.grid == plan.tiles * plan.chunks
    assert plan.smem_bytes + 1024 <= SMEM_PER_SM and plan.smem_bytes <= tops.SMEM_LIMIT
    # one tap's 64 x bn f32 tile a warpgroup, with room for the loaders'
    # rows and registers and the loop's indices
    budget = REGISTERS_PER_SM // THREADS
    assert plan.acc_registers == plan.bn // 2 and plan.acc_registers + 80 <= min(budget, 255)
    if plan.chunks > 1:  # split only as far as the card fills, in runs of >= 8 slabs
        assert plan.grid <= 2 * sms and spc >= 8
    return plan


# the input tile at each site: C covered (the stem's 45 padded to 48) or
# divided by 144
_BN = {45: 48, 144: 144, 288: 144, 576: 144, 1152: 144}


@pytest.mark.parametrize("b", [8, 32])
def test_temporal_dw_plan_at_every_path_site(b):
    for xs, co, _ in _k3_sites(b):
        plan = _check_plan(tops.temporal_dw_plan(xs, co, 3), xs, co, 3, tops.SMS)
        c = xs[-1]
        assert plan.bn == _BN[c] and plan.tap_groups == 1, xs
        # every tap of a tile in one block: x is read once per 64 output
        # channels, g once per input tile
        assert plan.x_reads == co // 64 and plan.g_reads == -(-c // plan.bn)
        # the card is filled, about one block per SM, but for stage 4 at 8
        # clips: its 64 tiles walk 14 slabs, too few to split
        if (b, xs[1]) != (8, 2):
            assert plan.grid >= 0.95 * tops.SMS, (xs, plan)
    # stage 1 is one tile split over the card; stage 4 is 64 tiles in 1 or 2 chunks
    assert tops.temporal_dw_plan((b, 16, 3136, 144), 64, 3).tiles == 1
    assert tops.temporal_dw_plan((b, 2, 49, 1152), 512, 3).chunks == (1 if b == 8 else 2)
    # a smaller card gets fewer chunks
    assert tops.temporal_dw_plan((b, 16, 3136, 144), 64, 3, sms=66).chunks <= 66


@pytest.mark.parametrize("x_shape,co,k,bn,groups,chunks", [
    ((2, 5, 13, 45), 19, 3, 48, 1, 1),    # one column of 26 rows: too short to split
    ((1, 7, 9, 40), 24, 5, 48, 2, 1),     # k = 5: two tap groups
    ((2, 2, 50, 72), 130, 5, 144, 2, 1),  # T = 2 with k = 5, Co ragged
    ((1, 3, 700, 64), 64, 3, 144, 1, 4),  # several chunks, the last one short
    ((4, 4, 196, 200), 8, 1, 48, 1, 6),   # k = 1; C = 200 is divided by no tile
])
def test_temporal_dw_plan_takes_ragged_widths(x_shape, co, k, bn, groups, chunks):
    plan = _check_plan(tops.temporal_dw_plan(x_shape, co, k), x_shape, co, k, tops.SMS)
    assert (plan.bn, plan.tap_groups, plan.chunks) == (bn, groups, chunks)


def test_temporal_dw_plan_refuses_an_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        tops.temporal_dw_plan((1, 4, 8, 32), 16, 2)


def _walk(x, g, k, plan):
    """K3's arithmetic in the kernel's order, in plain tensors: per tile and
    chunk, the chunk's steps (column, t), each step's slabs (tile_s rows of
    the flattened b * S + s at t), the taps whose t + dt - p lies in [0, T)
    of the block's tap group; one f32 partial per chunk, the partials added
    in chunk order."""
    b, t, s, c = x.shape
    co = g.shape[-1]
    p = k // 2
    cp, cop = plan.c_tiles * plan.bn, plan.co_tiles * 64
    rows = plan.columns * plan.tile_s
    # (T, rows, C): the (b, s) rows at each t, zero past the last (b, s)
    xr = F.pad(x.permute(1, 0, 2, 3).reshape(t, b * s, c), (0, cp - c, 0, rows - b * s))
    gr = F.pad(g.permute(1, 0, 2, 3).reshape(t, b * s, co), (0, cop - co, 0, rows - b * s))
    parts = torch.zeros((plan.chunks, plan.tap_groups * 3, cp, cop), dtype=torch.float32)
    for tile in range(plan.tiles):
        c0 = tile % plan.c_tiles * plan.bn
        n0 = tile // plan.c_tiles % plan.co_tiles * 64
        tg = tile // (plan.c_tiles * plan.co_tiles)
        for chunk in range(plan.chunks):
            first = chunk * plan.steps_per_chunk
            for i in range(first, min(first + plan.steps_per_chunk, plan.steps)):
                col, tt = divmod(i, t)
                sl = slice(col * plan.tile_s, (col + 1) * plan.tile_s)
                gs = gr[tt, sl, n0:n0 + 64]
                for dt in range(tg * 3, min(tg * 3 + 3, k)):
                    tx = tt + dt - p
                    if 0 <= tx < t:
                        xs = xr[tx, sl, c0:c0 + plan.bn]
                        parts[chunk, dt, c0:c0 + plan.bn, n0:n0 + 64] += (gs.T @ xs).T
    dw = parts[0].clone()
    for chunk in range(1, plan.chunks):
        dw += parts[chunk]
    return dw[:k, :c, :co]


@pytest.mark.parametrize("x_shape,co,k", [
    ((2, 16, 100, 45), 64, 3),   # the stem's widths: C = 45 padded to 48, split
    ((8, 2, 90, 144), 64, 3),    # stage 1's widths at T = 2, 3 chunks
    ((1, 16, 40, 144), 24, 1),   # k = 1, T = 16
    ((2, 5, 30, 40), 72, 5),     # k = 5: two tap groups, outer taps with few rows
    ((1, 3, 700, 288), 128, 3),  # 2 x 2 tiles, 4 chunks, the last one short
])
def test_walk_in_plan_order_matches_plain_and_pallas(x_shape, co, k):
    rng = np.random.default_rng(5)
    x = rng.normal(size=x_shape).astype(np.float32)
    g = rng.normal(size=x_shape[:3] + (co,)).astype(np.float32)
    plan = tops.temporal_dw_plan(x_shape, co, k)
    got = _walk(torch.from_numpy(x), torch.from_numpy(g), k, plan)
    plain = tops.temporal_dw_plain(torch.from_numpy(x), torch.from_numpy(g), k)
    ref = np.asarray(jops._temporal_dw(jnp.asarray(x), jnp.asarray(g), k))
    scale = np.abs(ref).max()
    assert tuple(got.shape) == ref.shape == (k, x_shape[-1], co)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=0, atol=TOL * scale)
