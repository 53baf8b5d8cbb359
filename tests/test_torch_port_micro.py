"""K5-K9, the temporal-conv micro-benchmark's designs (ops/temporal_micro.py,
csrc/temporal_micro.cu), and the port's micro-benchmark entry point, off
the card.

The JAX functions come from the JAX package's ``benchmarks/kernel_micro.py``
(loaded by path: the folder is no package) and run in Pallas interpret mode
on the CPU. Each plain version is held to its JAX kernel in f32 at ragged
widths (C = 40, Co = 24), several S tiles (``tile_s`` / ``max_tile`` 8) and
T = 1, 2, 4, with the JAX tests' tolerances (tests/test_ops_pallas.py:51,
66): 1e-4 forward and dx, 1e-3 dw. K6 at T = 1 is held to the library conv
instead: the JAX ``pallas_temporal_v3`` cannot run there (its +1 tap slices
past a one-frame block), while the port computes the conv (a deliberate
difference). The kernels' walks, written out here in plain tensors with
the CUDA source's index arithmetic, are held to the plain versions and the
JAX kernels: K5's and K6's frame ring (items of 64 columns x a Co tile x a
channel group, frames in walk order, K5's zero halo frames, K6's
centre-first and skipped taps, 16-channel k steps over 64-channel boxes,
columns clipped at S, the groups' partials added in order), K8's slabs and
slices across taps, the dw chunks added in order. Then the plans and tile
rules, the ctypes bindings, the routing of CPU tensors and the entry point
on the CPU.
"""

import ctypes
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fastvideotagging_tpu.ops.conv2plus1d import _pick_tile as jax_pick_tile
from fastvideotagging_tpu_torch.benchmarks import kernel_micro as tkm
from fastvideotagging_tpu_torch.ops import _build
from fastvideotagging_tpu_torch.ops import temporal_micro as micro

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_kernel_micro", os.path.join(_ROOT, "benchmarks", "kernel_micro.py"))
jkm = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jkm)

FWD_TOL = 1e-4
DW_TOL = 1e-3
B, S, C, CO, K = 2, 24, 40, 24, 3


def _inputs(t, seed=0, s=S, c=C, co=CO, k=K):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, t, s, c)).astype(np.float32)
    w = (rng.standard_normal((k, c, co)) / np.sqrt(k * c)).astype(np.float32)
    g = rng.standard_normal((B, t, s, co)).astype(np.float32)
    return x, w, g


def _close(got, ref, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


# (plain version, JAX kernel, tile argument name, dw?)
DESIGNS = {
    "v2": (micro.temporal_v2_plain, jkm.pallas_temporal_v2, "tile_s", False),
    "v3": (micro.temporal_v3_plain, jkm.pallas_temporal_v3, "max_tile", False),
    "dx_v3": (micro.temporal_dx_v3_plain, jkm.pallas_temporal_dx_v3, "max_tile", False),
    "v3p": (micro.temporal_v3p_plain, jkm.pallas_temporal_v3p, "max_tile", False),
    "dw_v3": (micro.temporal_dw_v3_plain, jkm.pallas_temporal_dw_v3, "max_tile", True),
    "dw_v2": (micro.temporal_dw_v2_plain, jkm.pallas_temporal_dw, "tile_s", True),
}


def _args(design, t, seed=0):
    x, w, g = _inputs(t, seed)
    if design == "dx_v3":
        return g, w
    return (x, g) if DESIGNS[design][3] else (x, w)


@pytest.mark.parametrize("design,t", [
    (design, t) for design in DESIGNS for t in (1, 2, 4)
    if t > 1 or design not in ("v3", "dx_v3")])  # K6 at T = 1: test_v3_at_one_frame
def test_plain_matches_the_jax_kernel(design, t):
    """Each plain version against its JAX kernel in interpret mode, with
    8-column tiles (three S tiles a clip)."""
    plain, jax_fn, tile_arg, is_dw = DESIGNS[design]
    a, b = _args(design, t)
    got = plain(torch.from_numpy(a), torch.from_numpy(b), K, **{tile_arg: 8})
    ref = jax_fn(jnp.asarray(a), jnp.asarray(b), K, **{tile_arg: 8})
    assert got.dtype == torch.float32
    _close(got, ref, DW_TOL if is_dw else FWD_TOL)


def test_v3_at_one_frame():
    """At T = 1 (k = 3) the JAX ``pallas_temporal_v3`` raises: its +1 tap
    slices rows [tile_s, tile_s) of a tile_s-row block (kernel_micro.py:
    141-147). The port's K6 skips taps with no rows and computes the conv:
    held to the library conv and to the JAX file's XLA reference."""
    x, w, g = _inputs(1)
    with pytest.raises(ValueError, match="Out of bound slice"):
        jkm.pallas_temporal_v3(jnp.asarray(x), jnp.asarray(w), K, max_tile=8)
    got = micro.temporal_v3_plain(torch.from_numpy(x), torch.from_numpy(w), K, 8)
    _close(got, tkm.library_temporal(torch.from_numpy(x), torch.from_numpy(w)), FWD_TOL)
    _close(got, jkm.xla_temporal(jnp.asarray(x), jnp.asarray(w)), FWD_TOL)
    dx = micro.temporal_dx_v3_plain(torch.from_numpy(g), torch.from_numpy(w), K, 8)
    _close(dx, tkm.library_temporal_dx(torch.from_numpy(g), torch.from_numpy(w)), FWD_TOL)


def test_library_yardsticks_match_the_jax_references():
    """The port's library calls compute what the JAX file's XLA references
    do (forward, direct-form dx, dw through the vjp)."""
    x, w, g = _inputs(4, seed=1)
    xt, wt, gt = map(torch.from_numpy, (x, w, g))
    xj, wj, gj = map(jnp.asarray, (x, w, g))
    _close(tkm.library_temporal(xt, wt), jkm.xla_temporal(xj, wj), FWD_TOL)
    _close(tkm.library_temporal_dx(gt, wt), jkm.xla_temporal_dx(gj, wj), FWD_TOL)
    _close(tkm.library_temporal_dw(xt, wt, gt), jkm.xla_temporal_dw(xj, wj, gj), DW_TOL)


# ---------------------------------------------------------------------------
# The kernels' walks (csrc/temporal_micro.cu), in plain tensors
# ---------------------------------------------------------------------------


def _fwd_walk(x, w, k, tile_s):
    """micro_fwd_kernel's arithmetic for K8 (v3p) in its order: per block
    (slab, 128-row tile, 64-wide Co tile) 32-deep slices of kappa = tap * C
    + c, across taps, A gathered as a_offset does (zeros for rows whose
    frame lies outside [0, T)), an f32 accumulator per block."""
    b, t, s, c = x.shape
    co = w.shape[-1]
    p = k // 2
    bm, bn, bk = micro.BM, micro.BN, 32
    xf = F.pad(x.reshape(-1, c), (0, 0, 0, 1))  # one zero row: the loader's zeros
    zero_row = xf.shape[0] - 1
    wf = F.pad(w.reshape(k * c, co), (0, 0, 0, bk))
    y = torch.zeros((b, t, s, co))
    plan = micro.forward_plan((b, t, s, c), co, tile_s)
    slices = [(i * bk, k * c) for i in range(-(-k * c // bk))]
    for slab in range(plan.slabs):
        bb, s0 = divmod(slab, s // tile_s)
        s0 *= tile_s
        for rt in range(plan.row_tiles):
            r = torch.arange(rt * bm, min((rt + 1) * bm, t * tile_s))
            tt, ss = r // tile_s, s0 + r % tile_s
            for n0 in range(0, co, bn):
                acc = torch.zeros((len(r), bn))
                for kbase, klimit in slices:
                    kappa = torch.arange(kbase, kbase + bk)
                    tap, ch = kappa // c, kappa % c
                    frame = tt[:, None] + tap[None] - p
                    ok = (kappa < klimit)[None] & (frame >= 0) & (frame < t)
                    rows = torch.where(ok, (bb * t + frame) * s + ss[:, None], zero_row)
                    a = xf[rows, torch.where(ok, ch[None], 0)]
                    wb = wf[kbase : kbase + bk, n0 : n0 + bn] * (kappa < klimit)[:, None]
                    acc[:, : wb.shape[1]] += a @ wb
                y[bb, tt, ss, n0 : n0 + bn] = acc[:, : min(bn, co - n0)]
    return y


def _dw_walk(x, g, k, plan, padded):
    """micro_dw_kernel's arithmetic in its order: per block (tap, 64 x 64
    tile, chunk) the chunk's (b, s-tile) slabs in 32-row slices of the rows
    [lo, hi) whose g row meets an x row of the tap (every row over the
    padded x), one f32 partial per chunk; the partials added in chunk
    order (micro_reduce_kernel)."""
    b, t, s, c = x.shape
    co = g.shape[-1]
    p = k // 2
    tile_s, dk = plan.tile_s, 32
    src = F.pad(x, (0, 0, 0, 0, p, p)) if padded else x
    tx = src.shape[1]
    xf, gf = src.reshape(-1, c), g.reshape(-1, co)
    parts = torch.zeros((plan.chunks, k, c, co))
    for tap in range(k):
        off = tap - p
        lo, hi = (0, t * tile_s) if padded else (max(0, -off) * tile_s,
                                                  (t - max(0, off)) * tile_s)
        for chunk in range(plan.chunks):
            first = chunk * plan.steps_per_chunk
            for step in range(first, min(first + plan.steps_per_chunk, plan.steps)):
                bb, s0 = divmod(step, s // tile_s)
                s0 *= tile_s
                for r0 in range(lo, hi, dk):
                    r = torch.arange(r0, min(r0 + dk, hi))
                    tt, ss = r // tile_s, s0 + r % tile_s
                    frame = tt + tap if padded else tt + off
                    xs, gs = xf[(bb * tx + frame) * s + ss], gf[(bb * t + tt) * s + ss]
                    parts[chunk, tap] += xs.T @ gs
    dw = parts[0].clone()
    for chunk in range(1, plan.chunks):
        dw += parts[chunk]
    return dw


def _ring_walk(x, w, k, variant, plan):
    """micro_ring_kernel's arithmetic in its order (K5: variant "v2", K6:
    "v3"): item q of the plan is (64-column tile q // W, weights q % W), W
    = co_tiles * groups * tap_groups, the weights index g = q % W //
    co_tiles (channel group g // tap_groups, tap group g % tap_groups) and
    the Co tile. An item of taps [d0, d1) loads each frame of its walk once
    as a (64 columns, chunks * 64 channels) box, zero past S and C (K5's
    walk [d0 - p, T + d1 - 1 - p): its halo frames are all zeros, as the
    TMA box's fill; K6's the same clipped to [0, T)); output frame t then
    takes the group's taps in the kernel's order (K5 in order; K6 the
    centre first, then the others, a tap whose frame lies outside [0, T)
    skipped; no tap at all gives zeros), each in 16-channel k steps over the
    group's channels, into one f32 accumulator; the rows and columns inside
    S and Co are stored, into y (one partial) or partial g, the partials
    added in order (micro_ring_reduce_kernel)."""
    b, t, s, c = x.shape
    co = w.shape[-1]
    p = k // 2
    box_c = plan.chunks * micro.RING_CH
    cols_per_clip = -(-s // micro.RING_COLS)
    assert plan.cols == b * cols_per_clip
    n_w = plan.co_tiles * plan.partials
    parts = torch.zeros((plan.partials, b, t, s, co))
    for q in range(plan.items):
        col, wi = divmod(q, n_w)
        g, ct = divmod(wi, plan.co_tiles)
        cg, tg = divmod(g, plan.tap_groups)
        bb, j = divmod(col, cols_per_clip)
        s0, n0, c0 = j * micro.RING_COLS, ct * plan.bn, cg * box_c
        d0 = tg * plan.taps
        d1 = min(k, d0 + plan.taps)
        wt = torch.zeros((k, box_c, plan.bn))  # the taps' weights, zero past C and Co
        blk = w[:, c0 : c0 + box_c, n0 : n0 + plan.bn]
        wt[:, : blk.shape[1], : blk.shape[2]] = blk
        lo, hi = d0 - p, t + d1 - 1 - p
        if variant == "v3":
            lo = max(lo, 0)
            hi = max(min(hi, t), lo)
        ring = {}
        for f in range(lo, hi):  # each frame of the walk loaded once
            box = torch.zeros((micro.RING_COLS, box_c))
            if 0 <= f < t:
                blk = x[bb, f, s0 : s0 + micro.RING_COLS, c0 : c0 + box_c]
                box[: blk.shape[0], : blk.shape[1]] = blk
            ring[f] = box
        ksteps = -(-min(c - c0, box_c) // 16)
        order = [p] + [d for d in range(k) if d != p] if variant == "v3" else list(range(k))
        for tt in range(t):
            acc = torch.zeros((micro.RING_COLS, plan.bn))  # a tap group with no tap: zeros
            first = True  # the first product starts the accumulator
            for dt in order:
                if not d0 <= dt < d1:
                    continue
                f = tt + dt - p
                if variant == "v3" and not 0 <= f < t:
                    continue
                for ks in range(ksteps):
                    kk = slice(16 * ks, 16 * ks + 16)
                    prod = ring[f][:, kk] @ wt[dt, kk]
                    acc = prod if first else acc + prod
                    first = False
            rows, cols = min(micro.RING_COLS, s - s0), min(plan.bn, co - n0)
            parts[g, bb, tt, s0 : s0 + rows, n0 : n0 + cols] = acc[:rows, :cols]
    y = parts[0].clone()
    for g in range(1, plan.partials):
        y += parts[g]
    return y


def _forced_plan(x_shape, co, k, **kw):
    """ring_plan with some fields forced (two Co tiles, two channel groups,
    tap groups), its counts kept consistent."""
    plan = micro.ring_plan(x_shape, co, k)._replace(**kw)
    co_tiles = -(-co // plan.bn)
    groups = -(-(-(-x_shape[-1] // micro.RING_CH)) // plan.chunks)
    tap_groups = -(-k // plan.taps)
    return plan._replace(co_tiles=co_tiles, groups=groups, tap_groups=tap_groups,
                         items=plan.cols * co_tiles * groups * tap_groups)


@pytest.mark.parametrize("t,k", [(1, 3), (2, 3), (4, 3), (3, 5)])
@pytest.mark.parametrize("variant", ["v2", "v3", "v3p"])
def test_forward_walk_matches_plain(variant, t, k):
    """The forward kernels' walks at ragged widths against the plain
    versions: K5's and K6's frame ring (S = 24: one partial 64-column tile a
    clip), K8's slabs of 8-column tiles (a row tile holds several frames'
    rows) with slices that straddle taps (C = 40 is not a multiple of
    32)."""
    x, w, _ = _inputs(t, seed=2, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = {"v2": micro.temporal_v2_plain, "v3": micro.temporal_v3_plain,
             "v3p": micro.temporal_v3p_plain}[variant]
    if variant == "v3p":
        got = _fwd_walk(xt, wt, k, 8)
    else:
        got = _ring_walk(xt, wt, k, variant, micro.ring_plan(tuple(x.shape), CO, k))
    _close(got, plain(xt, wt, k, 8), FWD_TOL)


def test_forward_walk_with_row_tiles_across_frames():
    """S = 384: K8's one 384-column tile takes nine 128-row tiles of a
    slab's 3 * 384 rows, the outer taps' clipped ranges starting and ending
    inside tiles; K5's and K6's ring walks six 64-column tiles a clip with
    Co = 72 in one 128-wide tile and in two 64-wide ones."""
    x, w, _ = _inputs(3, seed=3, s=384, c=16, co=72)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = micro.temporal_v3_plain(xt, wt, K)
    assert micro.forward_plan(tuple(x.shape), 72, 384).row_tiles == 9
    _close(_fwd_walk(xt, wt, K, 384), ref, FWD_TOL)
    plan = micro.ring_plan(tuple(x.shape), 72, K)
    assert (plan.bn, plan.co_tiles, plan.cols) == (128, 1, 12)
    for variant in ("v2", "v3"):
        _close(_ring_walk(xt, wt, K, variant, plan), ref, FWD_TOL)
        _close(_ring_walk(xt, wt, K, variant, _forced_plan(x.shape, 72, K, bn=64)), ref,
               FWD_TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_ring_walk_matches_plain_and_jax(variant, t, k):
    """K5's and K6's ring at S = 100 (a partial 64-column tile), C = 40,
    Co = 72 over two 64-wide Co tiles: against the plain version and the JAX
    Pallas kernel (interpret mode, one 100-column tile a clip; K6 at T <=
    k // 2 against the library conv: the JAX kernel's outer taps slice past
    its block there, as test_v3_at_one_frame says)."""
    x, w, _ = _inputs(t, seed=6, s=100, co=72, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = _forced_plan(x.shape, 72, k, bn=64)
    assert (plan.co_tiles, plan.groups, plan.cols) == (2, 1, 4)
    got = _ring_walk(xt, wt, k, variant, plan)
    plain = micro.temporal_v2_plain if variant == "v2" else micro.temporal_v3_plain
    _close(got, plain(xt, wt, k), FWD_TOL)
    if variant == "v3" and t <= k // 2:
        _close(got, tkm.library_temporal(xt, wt), FWD_TOL)
    else:
        jax_fn = jkm.pallas_temporal_v2 if variant == "v2" else jkm.pallas_temporal_v3
        tile = {"tile_s": 100} if variant == "v2" else {"max_tile": 100}
        _close(got, jax_fn(jnp.asarray(x), jnp.asarray(w), k, **tile), FWD_TOL)


@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_ring_walk_adds_channel_groups_in_order(variant):
    """C = 144 in two channel groups (two 64-channel boxes, then one 16
    channels wide: its k steps stop at C), each an f32 partial added in
    group order, against the plain version and against the walk in one
    group (the ring_plan at this shape)."""
    x, w, _ = _inputs(4, seed=7, s=70, c=144, co=24)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    one = micro.ring_plan(tuple(x.shape), 24, K)
    two = _forced_plan(x.shape, 24, K, chunks=2)
    assert (one.groups, one.chunks, two.groups, two.chunks) == (1, 3, 2, 2)
    got = _ring_walk(xt, wt, K, variant, two)
    plain = micro.temporal_v2_plain if variant == "v2" else micro.temporal_v3_plain
    _close(got, plain(xt, wt, K), FWD_TOL)
    _close(got, _ring_walk(xt, wt, K, variant, one), FWD_TOL)


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("variant", ["v2", "v3"])
def test_ring_walk_adds_tap_groups_in_order(variant, t):
    """k = 15: the taps' weights and 16 frame slots of one 64-channel box
    overflow a block, so ring_plan splits the taps into two groups (8 and
    7), each walking only the frames its taps read and writing an f32
    partial; at T = 1 K6's second group reaches no frame and adds zeros.
    Against the plain version, the JAX kernel (K6 at T <= 7: the library
    conv, as test_v3_at_one_frame says) and, forced to groups of 2 taps at
    k = 5, the walk in one group."""
    k = 15
    x, w, _ = _inputs(t, seed=9, s=70, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = micro.ring_plan(tuple(x.shape), CO, k)
    assert (plan.taps, plan.tap_groups, plan.groups, plan.partials) == (8, 2, 1, 2)
    got = _ring_walk(xt, wt, k, variant, plan)
    plain = micro.temporal_v2_plain if variant == "v2" else micro.temporal_v3_plain
    _close(got, plain(xt, wt, k), FWD_TOL)
    if variant == "v3":
        _close(got, tkm.library_temporal(xt, wt), FWD_TOL)
    else:
        _close(got, jkm.pallas_temporal_v2(jnp.asarray(x), jnp.asarray(w), k, tile_s=70),
               FWD_TOL)
    x5, w5, _ = _inputs(t, seed=10, s=70, k=5)
    x5, w5 = torch.from_numpy(x5), torch.from_numpy(w5)
    three = _forced_plan(tuple(x5.shape), CO, 5, taps=2)
    assert (three.tap_groups, three.items) == (3, 3 * three.cols)
    _close(_ring_walk(x5, w5, 5, variant, three), plain(x5, w5, 5), FWD_TOL)


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("design", ["dw_v3", "dw_v2"])
def test_dw_walk_in_chunk_order_matches_plain_and_jax(design, t):
    """K7's and K9's walk, with a plan of two steps a chunk (a card of two
    SMs: four chunks at most, three here), against the plain version (the
    same chunks) and the JAX kernel."""
    x, _, g = _inputs(t, seed=4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    plan = micro.dw_plan(tuple(x.shape), CO, 8, sms=2)
    assert (plan.steps, plan.chunks, plan.steps_per_chunk) == (6, 3, 2)
    got = _dw_walk(xt, gt, K, plan, padded=design == "dw_v2")
    ref = DESIGNS[design][1](jnp.asarray(x), jnp.asarray(g), K, **{DESIGNS[design][2]: 8})
    _close(got, ref, DW_TOL)
    # the plain version's chunks are the card's (132 SMs off the card): one step each
    _close(DESIGNS[design][0](xt, gt, K, 8), got, DW_TOL)


# ---------------------------------------------------------------------------
# Plans, tile rules, bindings, routing, the entry point
# ---------------------------------------------------------------------------


def test_pick_tile_matches_the_jax_packages_for_every_s():
    for s in range(1, 4097):
        for max_tile in (448, 224, 8):
            assert micro._pick_tile(s, max_tile) == jax_pick_tile(s, max_tile), (s, max_tile)


def test_halved_tile_matches_the_jax_v2s_for_every_s():
    """v2's tile, read from the grid of the JAX kernel's pallas_call. The
    tiles tried (512, 256, ..., 1) all divide 512, so the rule depends on S
    mod 512 only: S = 1..512 traced covers every S in 1..4096."""
    raw = jkm.pallas_temporal_v2.__wrapped__
    w = jax.ShapeDtypeStruct((K, 1, 1), jnp.float32)

    def jax_tile(s):
        x = jax.ShapeDtypeStruct((1, 1, s, 1), jnp.float32)
        eqn = next(e for e in jax.make_jaxpr(lambda x, w: raw(x, w, K))(x, w).jaxpr.eqns
                   if e.primitive.name == "pallas_call")
        return s // eqn.params["grid_mapping"].grid[1]

    by_class = {s: jax_tile(s) for s in range(1, 513)}
    for s in range(1, 4097):
        assert micro._halved_tile(s) == by_class[(s - 1) % 512 + 1], s
    # the benchmark shapes: 64 at S = 3136, 16 at S = 784
    assert micro._halved_tile(3136) == 64 and micro._halved_tile(784) == 16
    assert micro._pick_tile(3136, 448) == 448 and micro._pick_tile(784, 448) == 392


@pytest.mark.parametrize("k", [1, 3, 5, 15])
def test_ring_plan_covers_every_item_once_and_fits(k):
    """ring_plan at the micro-benchmark's shapes (forward and dx) and at
    ragged ones: every (clip, 64-column tile, Co tile, channel group, tap
    group) exactly once among the blocks' items, the Co tiles covering Co,
    the channel groups C and the tap groups k, shared memory within a
    block's 232,448 bytes, a group's taps + 1 frame slots at least (+ 2
    beside y staging tiles), staging only where its 64-channel store boxes
    stay inside the Co tile (BN = 144: one tile), one block an SM at most
    and a multiple of the weights' count where the card has as many SMs (a
    block's weights never change)."""
    shapes = [((32, 16, 3136, 128), 128), ((32, 16, 3136, 144), 64), ((32, 8, 784, 256), 128),
              ((32, 16, 3136, 64), 144), ((32, 8, 784, 128), 256), ((2, 4, 100, 40), 72),
              ((1, 4, 70, 512), 64), ((3, 1, 13, 45), 19), ((1, 2, 64, 1152), 512),
              ((2, 4, 100, 64), 288)]
    for x_shape, co in shapes:
        b, _, s, c = x_shape
        plan = micro.ring_plan(x_shape, co, k)
        assert plan.smem == micro._ring_smem(plan.taps, plan.chunks, plan.bn, plan.slots,
                                             plan.stage)
        assert plan.smem <= micro.RING_SMEM_MAX
        assert plan.slots >= plan.taps + 1 + (plan.stage > 0)
        assert plan.stage in (0, -(-plan.bn // micro.RING_CH) * micro.RING_BOX)
        assert plan.stage == 0 or (plan.partials == 1 and co % 8 == 0 and (
            plan.bn % micro.RING_CH == 0 or plan.co_tiles == 1))
        assert plan.bn in micro.RING_BNS and plan.co_tiles * plan.bn >= co > (
            plan.co_tiles - 1) * plan.bn
        boxes = -(-c // micro.RING_CH)
        assert plan.groups * plan.chunks >= boxes > (plan.groups - 1) * plan.chunks
        assert plan.tap_groups * plan.taps >= k > (plan.tap_groups - 1) * plan.taps
        assert (plan.tap_groups == 1) == (k < 15)
        n_w = plan.co_tiles * plan.partials
        assert plan.blocks <= micro.SMS and (plan.blocks % n_w == 0 or plan.blocks < n_w)
        seen = set()
        for blk in range(plan.blocks):
            for q in range(blk, plan.items, plan.blocks):
                col, wi = divmod(q, n_w)
                seen.add((divmod(col, -(-s // micro.RING_COLS)), wi))
        assert len(seen) == plan.items == b * -(-s // micro.RING_COLS) * n_w
    # the micro-benchmark's shapes at k = 3: x in one group and y through
    # the staging tiles beside k + 2 slots or more; tpu2's 256 channels take
    # 64-wide Co tiles, whose taps leave room for k + 1 slots and no staging
    assert micro.ring_plan((32, 16, 3136, 128), 128, 3)[:6] == (128, 1, 1, 2, 6, 16384)
    assert micro.ring_plan((32, 16, 3136, 144), 64, 3)[:6] == (64, 1, 1, 3, 5, 8192)
    assert micro.ring_plan((32, 8, 784, 256), 128, 3)[:6] == (64, 2, 1, 4, 4, 0)
    assert micro.ring_plan((32, 8, 784, 128), 256, 3)[:6] == (128, 2, 1, 2, 6, 16384)
    # staging needs one group and Co % 8 == 0 (TMA's 16-byte row stride)
    assert micro.ring_plan((3, 1, 13, 45), 19, 3).stage == 0
    assert micro.ring_plan((1, 4, 70, 512), 64, 3).stage == 0
    # BN = 144 over two Co tiles stores from registers: a staged tile's
    # third 64-channel box would write 48 channels of the next tile
    assert micro.ring_plan((2, 4, 100, 64), 288, 3)[:6] == (144, 2, 1, 1, 8, 0)
    assert micro.ring_plan((32, 16, 3136, 64), 144, 3)[:6] == (144, 1, 1, 1, 8, 24576)
    # k = 15 at one box: two tap groups of 8 and 7 taps, 13 slots
    plan = micro.ring_plan((1, 4, 64, 64), 64, 15)
    assert (plan.taps, plan.tap_groups, plan.slots, plan.stage) == (8, 2, 13, 0)


def test_dw_plan_caps_the_chunks_and_covers_the_steps():
    for shape, tile in (((32, 16, 3136, 128), 448), ((32, 16, 3136, 128), 64),
                        ((32, 8, 784, 256), 16), ((1, 3, 7, 5), 7), ((300, 2, 8, 16), 1)):
        plan = micro.dw_plan(shape, 64, tile)
        assert plan.steps == shape[0] * shape[2] // tile
        assert plan.chunks <= micro.DW_CHUNKS_PER_SM * micro.SMS
        spc = plan.steps_per_chunk
        assert plan.chunks * spc >= plan.steps > (plan.chunks - 1) * spc  # no empty chunk
    # tpu1: K7 one 448-column step a chunk (224), K9 six 64-column steps (262 chunks)
    assert micro.dw_plan((32, 16, 3136, 128), 128, 448)[1:4] == (224, 224, 1)
    assert micro.dw_plan((32, 16, 3136, 128), 128, 64)[1:4] == (1568, 262, 6)


def _c_params(name):
    with open(os.path.join(_build.CSRC, "temporal_micro.cu")) as f:
        src = f.read()
    params = re.search(rf"int fvt_micro_{name}_bf16\(([^)]*)\)", src).group(1).split(",")

    def kind(param):
        if "*" in param:
            return ctypes.c_void_p
        return ctypes.c_longlong if "long long" in param else ctypes.c_int

    return [kind(q) for q in params]


@pytest.mark.parametrize("name", list(micro.launch_counts))
def test_argtypes_match_their_c_signatures(name):
    """The ctypes binding of each entry point has one type per parameter of
    its C function, in the same kinds (pointers, 32-bit ints)."""
    assert micro._ARGTYPES[name] == _c_params(name)
    assert set(micro._ARGTYPES) == set(micro.launch_counts)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    x, w, g = map(torch.from_numpy, _inputs(4, seed=5))
    micro.reset_launch_counts()
    for design, (plain, _, tile_arg, is_dw) in DESIGNS.items():
        routed = getattr(micro, "temporal_" + design)
        a, b = (g, w) if design == "dx_v3" else ((x, g) if is_dw else (x, w))
        assert torch.equal(routed(a, b, K, 8), plain(a, b, K, 8))
    assert micro.launch_counts == {"v2": 0, "v3": 0, "dw_v3": 0, "v3p": 0, "dw_v2": 0}
    with pytest.raises(ValueError, match="no kernel for device"):
        micro.temporal_v3(x.to("meta"), w.to("meta"), K)


def test_entry_point_runs_on_the_cpu_at_a_tiny_shape(monkeypatch, capsys):
    monkeypatch.setitem(tkm.SHAPES, "tiny", (2, 4, 24, 40, 24))
    micro.reset_launch_counts()
    res = tkm.main(["--shape", "tiny", "--device", "cpu"])
    out = capsys.readouterr().out
    assert micro.launch_counts == {"v2": 0, "v3": 0, "dw_v3": 0, "v3p": 0, "dw_v2": 0}
    assert res["dims"] == [2, 4, 24, 40, 24] and res["device"].startswith("cpu")
    assert all(err <= tkm.FWD_TOL for err in res["parity"].values())
    names = ["library conv fwd", "v2 fwd", "v3 fwd tile<=448", "v3p fwd tile<=448",
             "v3 fwd tile<=224", "v3p fwd tile<=224", "v3 dx", "library conv dx",
             "library conv dw", "dw v2", "dw v3"]
    assert list(res["rows"]) == names
    # a CPU run prints host times only, under no device metric's name
    assert all(set(row) == {"host_ms"} for row in res["rows"].values())
    rows = [line for line in out.splitlines() if line.startswith(tuple(names))]
    assert len(rows) == len(names)
    assert not any("TFLOP/s" in row or "GB/s" in row or "bound" in row for row in rows)
    # the bound of the JAX file's tpu1 shape: 822.2 MB moved, bytes-bound
    flops, nbytes = tkm.work(32, 16, 3136, 128, 128, 3)
    assert tkm.bound_ms(flops, nbytes)[1] == "bytes"
    assert nbytes == 2 * 32 * 16 * 3136 * 256 + 2 * 3 * 128 * 128


def test_entry_point_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tkm.main(["--shape", "tpu2"])


def test_parity_failure_exits_non_zero(monkeypatch):
    """A kernel outside its tolerance stops the benchmark (unlike the JAX
    file, which prints)."""
    monkeypatch.setitem(tkm.SHAPES, "tiny", (1, 2, 8, 8, 8))
    monkeypatch.setattr(micro, "temporal_v3p", lambda x, w, k, max_tile=448:
                        micro.temporal_v3_plain(x, w, k) + 1.0)
    with pytest.raises(SystemExit, match="v3p"):
        tkm.main(["--shape", "tiny", "--device", "cpu"])


def test_chip_smoke_lists_the_micro_kernels_apart_from_the_main_path():
    """chip_smoke.py's K5-K9 entries come from phase 3d, keyed as the
    launch counts; the main path's kernel tables keep K1-K4 only."""
    import chip_smoke as cs

    assert list(cs.MICRO_KERNELS) == list(micro.launch_counts) == list(cs.MICRO_HEADLINE)
    assert list(cs.KERNELS) == ["spatial_conv", "temporal_conv", "temporal_dw", "fused_block"]
    assert {meta["source"] for meta in cs.MICRO_KERNELS.values()} == {
        "fastvideotagging_tpu_torch/csrc/temporal_micro.cu"}
    with open(os.path.join(_ROOT, "benchmarks", "kernel_micro.py")) as f:
        lines = f.read().splitlines()
    for meta in cs.MICRO_KERNELS.values():  # "benchmarks/kernel_micro.py:<line> (<function>)"
        line, fn = re.match(r"benchmarks/kernel_micro.py:(\d+) \((\w+)", meta["replaces"]).groups()
        assert lines[int(line) - 1].startswith(f"def {fn}("), meta["replaces"]
    x, w, g = map(torch.from_numpy, _inputs(4))
    cases = {label: (key, plan) for label, key, *_, plan in cs.micro_cases(x, w, g)}
    assert set(cs.MICRO_HEADLINE.values()) <= set(cases)
    assert {key for key, _ in cases.values()} == set(micro.launch_counts)
    # K5 and K6 on the ring (S = 24: one 64-column tile a clip), K8 on v3's
    # 24-column tiles, K9 on v2's 8-column ones
    ring = ("ring: 2 items of 64 columns x 1 Co tiles of 64 x 1 channel groups of 1 boxes "
            "on 2 blocks, 8 frame slots, y staged (8192 bytes a warpgroup), 107648 bytes of "
            "shared memory")
    assert cases["v2 fwd"][1] == cases["v3 fwd tile<=448"][1] == ring
    assert cases["v3p fwd tile<=448"][1].startswith("2 slabs of 24 columns")
    assert cases["dw v2"][1] == "6 steps of 8 columns in 6 chunks of 1, 18 blocks"
