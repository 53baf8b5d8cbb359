"""K4's plan (``ops/fused_block.py::fused_plan``) and its arithmetic in the
plan's order, on the CPU.

The walk below is what csrc/fused_block.cu does, in its order: rows of the
flattened B*H*W plane in tiles, mid channels in groups, each block walking
t with a ring of k mid frames, the temporal taps outside [0, T) skipped,
the weights in the kernel's K-major layouts, and one f32 partial of y per
group added in group order and rounded once. It is held to
``fused_block_plain`` and to the JAX package's ``conv2plus1d_fused`` (its
Pallas kernel in interpret mode) within 2e-3, the JAX test's fused
tolerance (tests/test_fused_block.py:42), at ragged C, M and Co, k = 3 and
5, T = 1, 2 and 16, with one group and several.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.ops import fused_block as jfused
from fastvideotagging_tpu_torch.models.layers import r2plus1d_mid_channels
from fastvideotagging_tpu_torch.ops import conv2plus1d as ops
from fastvideotagging_tpu_torch.ops import fused_block as fused

BLOCK_TOL = 2e-3
REGISTERS = 128  # f32 accumulators a thread may hold beside its addressing (255 in all)

# the four stride-1 (2+1)D pairs of r2plus1d_18 at 16x112x112: (T, H=W, C, M, Co)
SITES = [(16 // 2 ** s, 56 // 2 ** s, 64 * 2 ** s, r2plus1d_mid_channels(64 * 2 ** s, 64 * 2 ** s),
          64 * 2 ** s) for s in range(4)]
# the GPU tests' FUSED shapes (tests/test_torch_port_gpu.py): x, M, Co, k
GPU_FUSED = [
    ((2, 16, 56, 56, 64), 144, 64, 3), ((2, 8, 28, 28, 128), 288, 128, 3),
    ((2, 4, 14, 14, 256), 576, 256, 3), ((2, 2, 7, 7, 512), 1152, 512, 3),
    ((2, 1, 9, 11, 40), 50, 24, 3), ((1, 2, 6, 7, 40), 50, 24, 3),
    ((3, 16, 5, 5, 33), 21, 70, 3), ((1, 5, 8, 6, 36), 40, 16, 5),
]


def _all_plan_cases():
    cases = [((b, t, hw, hw, c), m, co, 3) for b in (8, 32) for t, hw, c, m, co in SITES]
    return cases + GPU_FUSED


def _check_plan(plan, x_shape, k, m, co):
    b, _, h, w, _ = x_shape
    rows = b * h * w
    assert plan.bm in fused._K4_BMS and plan.mg in fused._K4_MGS and plan.mg % 16 == 0
    # the row tiles cover the flattened plane, the groups cover M, each once
    assert plan.row_tiles == -(-rows // plan.bm) and (plan.row_tiles - 1) * plan.bm < rows
    assert plan.groups == -(-m // plan.mg) and (plan.groups - 1) * plan.mg < m
    # no grid-z recompute: one block per (row tile, group), nothing else
    assert plan.grid == plan.row_tiles * plan.groups
    # the Co passes cover Co; the spatial (mg / 2) and temporal (ct / 2)
    # accumulators, never live together, stay within the register budget
    assert plan.ct in fused._K4_CTS and plan.co_passes == -(-co // plan.ct)
    assert plan.acc_registers <= REGISTERS
    assert plan.threads == 2 * plan.bm  # a warpgroup per 64 rows
    # shared memory: the kernel's layout, within the 227 KB a block may use
    ring, smem = fused._k4_smem(plan.bm, plan.mg, plan.ct, k, plan.stages)
    assert plan.ring_bytes == ring == k * plan.bm * plan.mg * 2
    assert plan.smem_bytes == smem <= ops.SMEM_LIMIT
    assert plan.stages == fused._K4_STAGES


@pytest.mark.parametrize("x_shape,m,co,k", _all_plan_cases())
def test_fused_plan_covers_every_site_within_shared_memory_and_registers(x_shape, m, co, k):
    plan = fused.fused_plan(x_shape, k, m, co)
    assert plan is not None and fused.fused_supported(x_shape, k, m, co)
    _check_plan(plan, x_shape, k, m, co)
    # every tiling the plan chose among is itself a valid plan (or None)
    for bm in fused._K4_BMS:
        for mg in fused._K4_MGS:
            other = fused._make_plan(x_shape, k, m, co, ops.SMS, bm, mg, plan.ct)
            if other is not None:
                _check_plan(other, x_shape, k, m, co)


def test_fused_plan_takes_the_tilings_measured_fastest():
    """At 8 clips the cost model picks, at each site, the tiling that ran
    fastest on the card (chip_smoke.py phase 3c times the others): one
    group of 144 at stage 1, two at stage 2, nine groups of 64 at stage 3,
    and 64-row tiles at stage 4, whose 392 rows would leave 128-row tiles
    23 % empty."""
    got = [fused.fused_plan((8, t, hw, hw, c), 3, m, co) for t, hw, c, m, co in SITES]
    assert [(p.bm, p.mg, p.groups, p.ct, p.grid) for p in got] == [
        (128, 144, 1, 64, 196), (128, 144, 2, 128, 98), (128, 64, 9, 256, 117),
        (64, 64, 18, 256, 126)]
    # stage 4 fills 7 tiles of 64 rows (the first K4 needed 16 of 32)
    assert got[3].row_tiles == 7
    # the plan fills the card it is given: fewer SMs, fewer, wider blocks
    few = fused.fused_plan((8, 2, 7, 7, 512), 3, 1152, 512, sms=16)
    assert few.grid < got[3].grid


def test_ring_steps_count_the_taps_inside_the_clip():
    """The temporal slices of a block cover, per output frame, only its
    taps whose frame lies in [0, T): T = 1 keeps the centre tap alone."""
    plan = fused._make_plan((1, 1, 8, 8, 40), 3, 50, 24, ops.SMS, 64, 64, 64)
    spatial, temporal = fused._ring_steps(plan, (1, 1, 8, 8, 40), 3)
    assert spatial == -(-9 * 40 // 64)
    tk = fused._k4_stage(64, 64, 64) // (64 * 128) * 64
    assert temporal == -(-64 // tk)  # one tap of 64 channels
    plan16 = fused._make_plan((1, 16, 8, 8, 40), 3, 50, 24, ops.SMS, 64, 64, 64)
    _, t16 = fused._ring_steps(plan16, (1, 16, 8, 8, 40), 3)
    assert t16 == 2 * -(-2 * 64 // tk) + 14 * -(-3 * 64 // tk)


def test_fused_weight_layout_plain_is_k_major_and_zero_padded():
    rng = np.random.default_rng(3)
    w_sp = torch.from_numpy(rng.standard_normal((3, 3, 33, 21)).astype(np.float32))
    w_tmp = torch.from_numpy(rng.standard_normal((3, 21, 70)).astype(np.float32))
    wsp, wt = fused.fused_weight_layout_plain(w_sp, w_tmp)
    assert wsp.shape == (21, 9, 40) and wt.shape == (70, 3, 24)
    assert wsp.is_contiguous() and wt.is_contiguous()
    assert torch.equal(wsp[5, 4, :33], w_sp[1, 1, :, 5]) and not wsp[..., 33:].any()
    assert torch.equal(wt[7, 2, :21], w_tmp[2, :, 7]) and not wt[..., 21:].any()


def _walk(x, w_sp, scale, bias, w_tmp, plan):
    """K4's arithmetic in the order of csrc/fused_block.cu under ``plan``."""
    b, t, h, w, c = x.shape
    k, m, co = w_sp.shape[0], w_sp.shape[-1], w_tmp.shape[-1]
    p, hw, rows = k // 2, h * w, b * h * w
    acc_dtype = ops._acc_dtype(x)
    wsp, wt = fused.fused_weight_layout_plain(w_sp, w_tmp)  # (M, k*k, Cp), (Co, k, Mp)
    xp = F.pad(x, (0, wsp.shape[-1] - c)).reshape(b * t, hw, -1)
    n = torch.arange(rows)
    nb, ns = n // hw, n % hw
    nh, nw = ns // w, ns % w
    partials = torch.zeros((plan.groups, b, t, hw, co), dtype=acc_dtype)
    for g in range(plan.groups):
        g0 = g * plan.mg
        mv = min(plan.mg, m - g0)
        w_g = torch.zeros((plan.mg, k * k, wsp.shape[-1]), dtype=acc_dtype)
        w_g[:mv] = wsp[g0:g0 + mv].to(acc_dtype)
        wt_g = torch.zeros((co, k, plan.mg), dtype=acc_dtype)
        wt_g[:, :, :min(plan.mg, wt.shape[-1] - g0)] = wt[:, :, g0:g0 + plan.mg].to(acc_dtype)
        sc = torch.zeros(plan.mg, dtype=acc_dtype)
        bi = torch.zeros(plan.mg, dtype=acc_dtype)
        sc[:mv], bi[:mv] = scale[g0:g0 + mv].to(acc_dtype), bias[g0:g0 + mv].to(acc_dtype)
        for n0 in range(0, rows, plan.bm):  # one block
            r = n[n0:n0 + plan.bm]
            rb, rh, rw, rs = nb[r], nh[r], nw[r], ns[r]
            ring = {}
            for t_in in range(t + p):
                if t_in < t:  # the spatial GEMM over kappa, then epilogue 1
                    acc = torch.zeros((len(r), plan.mg), dtype=acc_dtype)
                    for tap in range(k * k):
                        hh, ww = rh + tap // k - p, rw + tap % k - p
                        inside = (hh >= 0) & (hh < h) & (ww >= 0) & (ww < w)
                        src = xp[rb * t + t_in, (hh * w + ww).clamp(0, hw - 1)].to(acc_dtype)
                        acc += (src * inside[:, None]) @ w_g[:, tap].T
                    mid = torch.relu(acc * sc + bi).to(x.dtype)
                    mid[:, mv:] = 0
                    ring[t_in % k] = mid.to(acc_dtype)
                t_out = t_in - p
                if t_out < 0:
                    continue
                for pas in range(plan.co_passes):  # the temporal GEMM, taps inside [0, T)
                    cols = slice(pas * plan.ct, min(co, (pas + 1) * plan.ct))
                    acc = torch.zeros((len(r), cols.stop - cols.start), dtype=acc_dtype)
                    for dt in range(k):
                        f = t_out + dt - p
                        if 0 <= f < t:
                            acc += ring[f % k] @ wt_g[cols, dt].T
                    partials[g, rb, t_out, rs, cols] = acc
    y = partials[0]
    for g in range(1, plan.groups):  # in group order, rounded once
        y = y + partials[g]
    return y.to(x.dtype).reshape(b, t, h, w, co)


def _inputs(shape, m, co, k, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    w_sp = (rng.standard_normal((k, k, c, m)) / np.sqrt(k * k * c)).astype(np.float32)
    w_tmp = (rng.standard_normal((k, m, co)) / np.sqrt(k * m)).astype(np.float32)
    bn = ((np.abs(rng.standard_normal(m)) + 0.5).astype(np.float32),
          (rng.standard_normal(m) * 0.1 + 0.2).astype(np.float32),
          (rng.standard_normal(m) * 0.1).astype(np.float32),
          (np.abs(rng.standard_normal(m)) + 0.5).astype(np.float32))
    return x, w_sp, w_tmp, bn


@pytest.mark.parametrize("shape,m,co,k,tiling", [
    ((2, 2, 8, 8, 33), 21, 70, 3, None),          # ragged C, M, Co; T = 2; one group
    ((1, 1, 8, 8, 40), 150, 24, 3, (64, 64)),      # T = 1; three groups, the last of 22
    ((1, 16, 8, 8, 32), 150, 64, 3, (128, 144)),   # T = 16; two groups, the last of 6
    ((1, 5, 8, 8, 36), 100, 16, 5, (64, 64)),      # k = 5: two halo frames a side; 64 + 36
])
def test_plain_walk_in_the_plans_order_matches_plain_and_jax(shape, m, co, k, tiling):
    x, w_sp, w_tmp, bn = _inputs(shape, m, co, k, seed=4)
    if tiling is None:
        plan = fused.fused_plan(shape, k, m, co)
    else:
        ct = next((n for n in fused._K4_CTS if n >= co), fused._K4_CTS[-1])
        plan = fused._make_plan(shape, k, m, co, ops.SMS, *tiling, ct)
    assert plan is not None and (tiling is None or plan.groups > 1)
    ts, tb = fused.fold_bn(*(torch.from_numpy(a) for a in bn))
    args = (torch.from_numpy(x), torch.from_numpy(w_sp), ts, tb, torch.from_numpy(w_tmp))
    got = _walk(*args, plan)
    plain = fused.fused_block_plain(*args)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=BLOCK_TOL, atol=BLOCK_TOL)
    js, jb = jfused.fold_bn(*(jnp.asarray(a) for a in bn))
    ref = np.asarray(jfused.conv2plus1d_fused(jnp.asarray(x), jnp.asarray(w_sp), js, jb,
                                              jnp.asarray(w_tmp)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=BLOCK_TOL, atol=BLOCK_TOL)


def test_no_plan_where_the_smallest_ring_exceeds_shared_memory():
    """k = 25: even 64 rows x 64 channels x 25 frames (200 KB) and the
    ring's slices exceed the 227 KB a block may use."""
    assert fused._k4_smem(64, 64, 64, 25, fused._K4_STAGES)[1] > ops.SMEM_LIMIT
    assert fused.fused_plan((1, 4, 32, 32, 32), 25, 64, 64) is None
    assert not fused.fused_supported((1, 4, 32, 32, 32), 25, 64, 64)
