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
JAX kernels: K5's, K6's and K8's frame ring (items of 64 columns x a Co
tile x a channel group, frames in walk order, K5's and K8's zero halo
frames, K6's centre-first and skipped taps, 16-channel k steps over
64-channel boxes, columns clipped at S, the groups' partials added in
order) and the dw ring of K9 and K7 (tiles of a tap group x a C tile x a
64-wide Co tile, chunks of 64-column items walked over T, 16-row k steps,
the chunks' partials added in order; K9 over the padded frames, K7 on the
clipped walk). Then the plans, the ctypes bindings, the routing of CPU
tensors and the entry point on the CPU.
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


def _dw_walk_ranges(t, k, d0, d1, clipped):
    """micro_dw_ring_kernel's walk of one item for taps [d0, d1): the g
    frames the producer loads, the x frames it loads, and per tap the
    output frames whose steps its warpgroup issues (K9: every output frame
    and the padded x frames [d0 - p, T + d1 - 1 - p); K7, ``clipped``: the
    same clipped to [0, T), a tap issued only where t + dt - p lies there)."""
    p = k // 2
    if not clipped:
        return range(t), range(d0 - p, t + d1 - 1 - p), {dt: range(t) for dt in range(d0, d1)}
    g_lo = max(0, p - d1 + 1)
    g_hi = max(g_lo, min(t, t + p - d0))
    f_lo = max(0, d0 - p)
    f_hi = max(f_lo, min(t, t + d1 - 1 - p))
    steps = {}
    for dt in range(d0, d1):
        t_lo = min(max(g_lo, p - dt), g_hi)
        steps[dt] = range(t_lo, max(t_lo, min(g_hi, t + p - dt)))
    return range(g_lo, g_hi), range(f_lo, f_hi), steps


def _dw_ring_walk(x, g, k, plan, clipped=False, loads=None):
    """micro_dw_ring_kernel's arithmetic in its order (K9; K7 where
    ``clipped``): block i is tile i % W of chunk i // W, W = tap_groups *
    c_tiles * co_tiles, the tile (tap group, C tile, 64-wide Co tile) in the
    kernel's index order. The block walks its chunk's items (64-column tiles
    of all clips, runs of cols_per_chunk) over T: each x frame of the walk
    (``_dw_walk_ranges``) loaded once as a (64 columns, boxes * 64 channels)
    box, zero past S and C and for K9's halo frames (TMA's fill), each g
    frame as a (64 columns, 64 channels) box, zero past S and Co; for output
    frame t the tap dt's f32 tile (64 x BN) adds g[t]^T x[t + dt - p] in four
    16-row k steps where the tap issues step t (K9: always, the halo's zeros
    included). The tiles, inside C and Co, go into the chunk's partial (k,
    C, Co), zero for a tap that issued no step; the partials are added as
    micro_dw_ring_reduce_kernel adds them (DW_REDUCE_GROUPS interleaved
    groups of chunks, each in order, then the groups in order). ``loads``,
    a dict, counts the frames loaded per (tap group, ring)."""
    b, t, s, c = x.shape
    co = g.shape[-1]
    p = k // 2
    m, cols_per_clip = micro.DW_RING_M, -(-s // micro.RING_COLS)
    box_c = -(-plan.bn // micro.RING_CH) * micro.RING_CH
    n_tiles = plan.tap_groups * plan.c_tiles * plan.co_tiles
    assert plan.cols == b * cols_per_clip and plan.blocks == n_tiles * plan.chunks

    def box(a, bb, f, s0, c0, width):
        out = torch.zeros((micro.RING_COLS, width))
        if 0 <= f < t:
            blk = a[bb, f, s0 : s0 + micro.RING_COLS, c0 : c0 + width]
            out[: blk.shape[0], : blk.shape[1]] = blk
        return out

    parts = torch.zeros((plan.chunks, k, c, co))
    for blk in range(plan.blocks):
        tile, chunk = blk % n_tiles, blk // n_tiles
        n0 = (tile % plan.co_tiles) * m
        c0 = (tile // plan.co_tiles % plan.c_tiles) * plan.bn
        tg = tile // (plan.co_tiles * plan.c_tiles)
        d0 = tg * plan.taps
        d1 = min(k, d0 + plan.taps)
        g_walk, x_walk, steps = _dw_walk_ranges(t, k, d0, d1, clipped)
        acc = torch.zeros((d1 - d0, m, plan.bn))
        col0 = chunk * plan.cols_per_chunk
        for col in range(col0, min(plan.cols, col0 + plan.cols_per_chunk)):
            bb, j = divmod(col, cols_per_clip)
            s0 = j * micro.RING_COLS
            ring = {f: box(x, bb, f, s0, c0, box_c)[:, : plan.bn] for f in x_walk}
            for tt in g_walk:
                gb = box(g, bb, tt, s0, n0, m)
                for dt in range(d0, d1):
                    if tt not in steps[dt]:
                        continue
                    for ks in range(micro.RING_COLS // 16):
                        rows = slice(16 * ks, 16 * ks + 16)
                        acc[dt - d0] += gb[rows].T @ ring[tt + dt - p][rows]
            if loads is not None:
                for ring_name, walk in (("x", x_walk), ("g", g_walk)):
                    loads[tg, ring_name] = loads.get((tg, ring_name), 0) + len(walk)
        cw, ow = min(plan.bn, c - c0), min(m, co - n0)
        parts[chunk, d0:d1, c0 : c0 + cw, n0 : n0 + ow] = acc[:, :ow, :cw].transpose(1, 2)
    sums = torch.zeros((micro.DW_REDUCE_GROUPS, k, c, co))
    for chunk in range(plan.chunks):
        sums[chunk % micro.DW_REDUCE_GROUPS] += parts[chunk]
    dw = sums[0].clone()
    for j in range(1, micro.DW_REDUCE_GROUPS):
        dw += sums[j]
    return dw


def _forced_dw_plan(x_shape, co, k, **kw):
    """dw_ring_plan with some fields forced (a narrower C tile, more chunks),
    its counts kept consistent."""
    plan = micro.dw_ring_plan(tuple(x_shape), co, k)._replace(**kw)
    c_tiles = -(-x_shape[-1] // plan.bn)
    tap_groups = -(-k // plan.taps)
    chunks = -(-plan.cols // plan.cols_per_chunk)
    return plan._replace(c_tiles=c_tiles, tap_groups=tap_groups, chunks=chunks,
                         blocks=tap_groups * c_tiles * plan.co_tiles * chunks,
                         partial_bytes=chunks * k * x_shape[-1] * co * 4 if chunks > 1 else 0)


def _ring_walk(x, w, k, variant, plan):
    """micro_ring_kernel's arithmetic in its order (K5: variant "v2", K6:
    "v3", K8: "v3p", K5's walk): item q of the plan is (64-column tile q // W, weights q % W), W
    = co_tiles * groups * tap_groups, the weights index g = q % W //
    co_tiles (channel group g // tap_groups, tap group g % tap_groups) and
    the Co tile. An item of taps [d0, d1) loads each frame of its walk once
    as a (64 columns, chunks * 64 channels) box, zero past S and C (K5's
    and K8's walk [d0 - p, T + d1 - 1 - p): its halo frames are all zeros,
    as the TMA box's fill; K6's the same clipped to [0, T)); output frame t
    then takes the group's taps in the kernel's order (K5 and K8 in order,
    the k steps in kappa = dt * C + c order; K6 the
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
    versions: K5's, K6's and K8's frame ring (S = 24: one partial 64-column
    tile a clip; C = 40: K8's packed k steps of 16 would straddle taps, and
    each tap's steps stop at C instead, over zeros past it)."""
    x, w, _ = _inputs(t, seed=2, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = {"v2": micro.temporal_v2_plain, "v3": micro.temporal_v3_plain,
             "v3p": micro.temporal_v3p_plain}[variant]
    got = _ring_walk(xt, wt, k, variant, micro.ring_plan(tuple(x.shape), CO, k))
    _close(got, plain(xt, wt, k, 8), FWD_TOL)


def test_forward_walk_with_row_tiles_across_frames():
    """S = 384: K5's, K6's and K8's ring walks six 64-column tiles a clip
    (the outer taps' frames of a tile inside and past [0, T)) with Co = 72
    in one 128-wide tile and in two 64-wide ones."""
    x, w, _ = _inputs(3, seed=3, s=384, c=16, co=72)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    ref = micro.temporal_v3_plain(xt, wt, K)
    _close(micro.temporal_v3p_plain(xt, wt, K, 384), ref, FWD_TOL)
    plan = micro.ring_plan(tuple(x.shape), 72, K)
    assert (plan.bn, plan.co_tiles, plan.cols) == (128, 1, 12)
    for variant in ("v2", "v3", "v3p"):
        _close(_ring_walk(xt, wt, K, variant, plan), ref, FWD_TOL)
        _close(_ring_walk(xt, wt, K, variant, _forced_plan(x.shape, 72, K, bn=64)), ref,
               FWD_TOL)


# the forward designs on the ring: plain version, JAX kernel, its tile argument
RING_DESIGNS = {
    "v2": (micro.temporal_v2_plain, jkm.pallas_temporal_v2, "tile_s"),
    "v3": (micro.temporal_v3_plain, jkm.pallas_temporal_v3, "max_tile"),
    "v3p": (micro.temporal_v3p_plain, jkm.pallas_temporal_v3p, "max_tile"),
}


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("variant", ["v2", "v3", "v3p"])
def test_ring_walk_matches_plain_and_jax(variant, t, k):
    """K5's, K6's and K8's ring at S = 100 (a partial 64-column tile), C =
    40, Co = 72 over two 64-wide Co tiles: against the plain version and the
    JAX Pallas kernel (interpret mode, one 100-column tile a clip; K6 at T
    <= k // 2 against the library conv: the JAX kernel's outer taps slice
    past its block there, as test_v3_at_one_frame says)."""
    x, w, _ = _inputs(t, seed=6, s=100, co=72, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plan = _forced_plan(x.shape, 72, k, bn=64)
    assert (plan.co_tiles, plan.groups, plan.cols) == (2, 1, 4)
    got = _ring_walk(xt, wt, k, variant, plan)
    plain, jax_fn, tile_arg = RING_DESIGNS[variant]
    _close(got, plain(xt, wt, k), FWD_TOL)
    if variant == "v3" and t <= k // 2:
        _close(got, tkm.library_temporal(xt, wt), FWD_TOL)
    else:
        _close(got, jax_fn(jnp.asarray(x), jnp.asarray(w), k, **{tile_arg: 100}), FWD_TOL)


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
@pytest.mark.parametrize("variant", ["v2", "v3", "v3p"])
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
    plain, jax_fn, tile_arg = RING_DESIGNS[variant]
    _close(got, plain(xt, wt, k), FWD_TOL)
    if variant == "v3":
        _close(got, tkm.library_temporal(xt, wt), FWD_TOL)
    else:
        _close(got, jax_fn(jnp.asarray(x), jnp.asarray(w), k, **{tile_arg: 70}), FWD_TOL)
    x5, w5, _ = _inputs(t, seed=10, s=70, k=5)
    x5, w5 = torch.from_numpy(x5), torch.from_numpy(w5)
    three = _forced_plan(tuple(x5.shape), CO, 5, taps=2)
    assert (three.tap_groups, three.items) == (3, 3 * three.cols)
    _close(_ring_walk(x5, w5, 5, variant, three), plain(x5, w5, 5), FWD_TOL)


# the dw designs on the ring: plain version, JAX kernel, its tile argument, K7's clipped walk?
DW_RING_DESIGNS = {
    "dw_v2": (micro.temporal_dw_v2_plain, jkm.pallas_temporal_dw, "tile_s", False),
    "dw_v3": (micro.temporal_dw_v3_plain, jkm.pallas_temporal_dw_v3, "max_tile", True),
}


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("design", ["dw_v3", "dw_v2"])
def test_dw_walk_in_chunk_order_matches_plain_and_jax(design, t):
    """The dw ring's walk, K7's clipped with a plan of one item a chunk (a
    card of two SMs: two chunks added by the reduce) and K9's padded with
    both items in one chunk (a card of one SM), against the plain version
    and the JAX kernel."""
    x, _, g = _inputs(t, seed=4)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    plain, jax_fn, tile_arg, clipped = DW_RING_DESIGNS[design]
    plan = micro.dw_ring_plan(tuple(x.shape), CO, K, sms=2 if clipped else 1)
    assert (plan.cols, plan.chunks, plan.cols_per_chunk, plan.blocks) == (
        (2, 2, 1, 2) if clipped else (2, 1, 2, 1))
    got = _dw_ring_walk(xt, gt, K, plan, clipped)
    _close(got, jax_fn(jnp.asarray(x), jnp.asarray(g), K, **{tile_arg: 8}), DW_TOL)
    # the plain version's chunks are the card's (132 SMs off the card): one
    # item each
    _close(plain(xt, gt, K, 8), got, DW_TOL)


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("design", ["dw_v2", "dw_v3"])
def test_dw_ring_walk_matches_plain_and_jax(design, t, k):
    """The dw ring (K9 padded, K7 clipped) at S = 100 (a partial 64-column
    item a clip), C = 136 over three 64-wide C tiles (the last 8 channels
    wide) and Co = 72 over two 64-wide Co tiles, k = 5 in two tap groups (3
    and 2 taps), the four items in chunks of 3 and 1: against the plain
    version (its own chunks) and the JAX Pallas kernel (interpret mode); at
    T = 1 every outer tap reads only halo frames (K9) or issues no step
    (K7)."""
    x, _, g = _inputs(t, seed=11, s=100, c=136, co=72, k=k)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    plan = _forced_dw_plan(x.shape, 72, k, bn=64, cols_per_chunk=3)
    assert (plan.c_tiles, plan.co_tiles, plan.tap_groups, plan.cols, plan.chunks) == (
        3, 2, k // 3 + 1 if k > 3 else 1, 4, 2)
    plain, jax_fn, tile_arg, clipped = DW_RING_DESIGNS[design]
    got = _dw_ring_walk(xt, gt, k, plan, clipped)
    _close(got, plain(xt, gt, k), DW_TOL)
    _close(got, jax_fn(jnp.asarray(x), jnp.asarray(g), k, **{tile_arg: 100}), DW_TOL)


@pytest.mark.parametrize("t", [1, 2, 4])
@pytest.mark.parametrize("design", ["dw_v2", "dw_v3"])
def test_dw_ring_walk_takes_tap_groups(design, t):
    """k = 15: five tap groups of three taps, a block each (one warpgroup a
    tap), every group walking only the frames its taps read (K9 halo
    included, K7 clipped to [0, T): at T = 1 only the centre tap has rows),
    at S = 70 (a 6-column second item): against the plain version and the
    JAX kernel. The JAX ``pallas_temporal_dw_v3`` raises where T < |dt -
    p| < 2T (T = 2 and 4 here): its x and g row slices of such a tap differ
    in length (benchmarks/kernel_micro.py:188-196). The port's K7 gives the
    tap no rows and computes the dw: held there to the JAX file's XLA
    reference instead."""
    k = 15
    x, w, g = _inputs(t, seed=12, s=70, k=k)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    plan = micro.dw_ring_plan(tuple(x.shape), CO, k)
    assert (plan.taps, plan.tap_groups, plan.tiles, plan.cols) == (3, 5, 5, 4)
    plain, jax_fn, tile_arg, clipped = DW_RING_DESIGNS[design]
    got = _dw_ring_walk(xt, gt, k, plan, clipped)
    _close(got, plain(xt, gt, k), DW_TOL)
    if clipped and t > 1:
        with pytest.raises(TypeError, match="contracting dimensions"):
            jax_fn(jnp.asarray(x), jnp.asarray(g), k, **{tile_arg: 70})
        ref = jkm.xla_temporal_dw(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g))
    else:
        ref = jax_fn(jnp.asarray(x), jnp.asarray(g), k, **{tile_arg: 70})
    _close(got, ref, DW_TOL)


@pytest.mark.parametrize("t", [1, 2, 4])
def test_dw_clipped_walk_loads_only_what_its_taps_read(t):
    """K7's clipped walk: at k = 15 a tap group whose taps reach no frame
    of [0, T) (at T = 1 all but the centre tap's group; at T = 4 the outer
    two) loads no x or g frame and writes zeros, and every group loads the
    x frames [max(0, d0 - p), min(T, T + d1 - 1 - p)), at least taps - 1
    fewer an item than K9's padded walk; at k = 3 and 5 the clipped walk
    gives K9's dw bitwise on the same plan (one chunk, and chunks of 3 and
    1 items): the padded walk's extra products are exact zeros."""
    x, _, g = _inputs(t, seed=13, s=70, k=15)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    plan = micro.dw_ring_plan(tuple(x.shape), CO, 15)
    clipped, padded = {}, {}
    got = _dw_ring_walk(xt, gt, 15, plan, True, clipped)
    _dw_ring_walk(xt, gt, 15, plan, False, padded)
    p = 7
    for tg in range(plan.tap_groups):
        d0, d1 = 3 * tg, 3 * tg + 3
        reads = [dt for dt in range(d0, d1) if abs(dt - p) < t]
        x_frames = max(0, min(t, t + d1 - 1 - p) - max(0, d0 - p))
        assert clipped[tg, "x"] == plan.cols * x_frames
        assert padded[tg, "x"] - clipped[tg, "x"] >= plan.cols * (d1 - d0 - 1)
        if not reads:
            assert clipped[tg, "x"] == clipped[tg, "g"] == 0
        else:
            assert clipped[tg, "g"] > 0
        for dt in range(d0, d1):
            if dt not in reads:
                assert not got[dt].any(), dt
    _close(got, micro.temporal_dw_v3_plain(xt, gt, 15), DW_TOL)
    for k in (3, 5):
        xk, _, gk = map(torch.from_numpy, _inputs(t, seed=14, s=100, c=136, co=72, k=k))
        for plan in (micro.dw_ring_plan(tuple(xk.shape), 72, k, sms=1),
                     _forced_dw_plan(xk.shape, 72, k, bn=64, cols_per_chunk=3)):
            assert torch.equal(_dw_ring_walk(xk, gk, k, plan, True), _dw_ring_walk(xk, gk, k, plan))


# ---------------------------------------------------------------------------
# Plans, tile rules, bindings, routing, the entry point
# ---------------------------------------------------------------------------


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


@pytest.mark.parametrize("k", [1, 3, 5, 15])
def test_dw_ring_plan_covers_every_row_once_and_fits(k):
    """dw_ring_plan at the micro-benchmark's shapes and at ragged ones:
    shared memory within a block's 232,448 bytes (the x ring of taps + 4
    slots of the C tile's boxes, the g ring of 5 one-box slots, their
    barriers), every (clip, 64-column item, frame, tap, C tile, Co tile)
    walked by exactly one block (K9: each item walks all T frames of its tap
    group; K7's clipped walk: each tap's steps exactly the output frames
    whose x frame lies in [0, T)), the C tiles covering C, the Co tiles Co,
    the tap groups k, one block an SM at most where the tiles fit the SMs,
    and the partial bytes it states: chunks x k x C x Co f32, none with one
    chunk."""
    shapes = [((32, 16, 3136, 128), 128), ((32, 16, 3136, 144), 64), ((32, 8, 784, 256), 128),
              ((2, 4, 100, 40), 72), ((3, 1, 13, 45), 19), ((1, 2, 64, 1152), 512),
              ((300, 2, 8, 16), 16), ((2, 4, 100, 136), 288)]
    for x_shape, co in shapes:
        b, t, s, c = x_shape
        plan = micro.dw_ring_plan(x_shape, co, k)
        boxes = -(-plan.bn // micro.RING_CH)
        assert plan.smem == micro._dw_ring_smem(boxes, plan.xslots, plan.gslots)
        assert plan.smem <= micro.RING_SMEM_MAX
        assert (plan.xslots, plan.gslots) == (plan.taps + micro.RING_AHEAD,
                                              1 + micro.RING_AHEAD)
        assert plan.bn in micro.RING_BNS
        assert plan.c_tiles * plan.bn >= c > (plan.c_tiles - 1) * plan.bn
        assert plan.co_tiles * micro.DW_RING_M >= co > (plan.co_tiles - 1) * micro.DW_RING_M
        assert plan.taps == min(k, micro.DW_RING_TAPS)
        assert plan.tap_groups * plan.taps >= k > (plan.tap_groups - 1) * plan.taps
        assert plan.cols == b * -(-s // micro.RING_COLS)
        assert plan.blocks == plan.tiles * plan.chunks
        assert plan.blocks <= micro.SMS or plan.chunks == 1
        assert plan.partial_bytes == (plan.chunks * k * c * co * 4 if plan.chunks > 1 else 0)
        cover = np.zeros((plan.cols, t, k, plan.c_tiles, plan.co_tiles), dtype=np.int32)
        clipped = np.zeros_like(cover)
        for blk in range(plan.blocks):
            tile, chunk = divmod(blk, plan.tiles)[::-1]
            nt = tile % plan.co_tiles
            ct = tile // plan.co_tiles % plan.c_tiles
            d0 = tile // (plan.co_tiles * plan.c_tiles) * plan.taps
            col0 = chunk * plan.cols_per_chunk
            assert col0 < plan.cols  # no empty chunk
            cols = slice(col0, col0 + plan.cols_per_chunk)
            cover[cols, :, d0 : d0 + plan.taps, ct, nt] += 1
            for dt, steps in _dw_walk_ranges(t, k, d0, min(k, d0 + plan.taps), True)[2].items():
                clipped[cols, steps.start : steps.stop, dt, ct, nt] += 1
        assert (cover == 1).all()
        f = np.arange(t)[:, None] + np.arange(k)[None, :] - k // 2  # (output frame, tap)
        assert (clipped == ((f >= 0) & (f < t))[None, :, :, None, None]).all()
    # the micro-benchmark's shapes at k = 3: tpu1 a 128-wide C tile and two
    # Co tiles (x read twice, g once), 66 chunks of 24 items on 132 blocks;
    # faithful1 one 144-wide tile, 131 chunks; tpu2 2 x 2 tiles, 32 chunks
    assert micro.dw_ring_plan((32, 16, 3136, 128), 128, 3)[:11] == (
        128, 1, 2, 3, 1, 7, 5, 1568, 66, 24, 132)
    assert micro.dw_ring_plan((32, 16, 3136, 144), 64, 3)[:11] == (
        144, 1, 1, 3, 1, 7, 5, 1568, 131, 12, 131)
    assert micro.dw_ring_plan((32, 8, 784, 256), 128, 3)[:11] == (
        128, 2, 2, 3, 1, 7, 5, 416, 32, 13, 128)
    # K7 takes the same plan; its clipped walk loads T x frames an item and
    # tap group at k = 3 where K9's loads T + 2 (tpu1 16 of 18, tpu2 8 of 10)
    for t in (16, 8):
        assert [len(_dw_walk_ranges(t, 3, 0, 3, clipped)[1]) for clipped in (True, False)] == [
            t, t + 2]
    # partials beside x + g: 13.0 of 822 MB at tpu1, 12.6 of 154 MB at tpu2
    assert micro.dw_ring_plan((32, 16, 3136, 128), 128, 3).partial_bytes == 66 * 3 * 128 * 128 * 4
    assert micro.dw_ring_plan((32, 8, 784, 256), 128, 3).partial_bytes == 32 * 3 * 256 * 128 * 4


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
    # K5, K6 and K8 on the ring (S = 24: one 64-column tile a clip), K9 and
    # K7 on the dw ring with the same plan (two items, a chunk each)
    ring = ("ring: 2 items of 64 columns x 1 Co tiles of 64 x 1 channel groups of 1 boxes "
            "on 2 blocks, 8 frame slots, y staged (8192 bytes a warpgroup), 107648 bytes of "
            "shared memory")
    assert cases["v2 fwd"][1] == cases["v3 fwd tile<=448"][1] == ring
    assert cases["v3p fwd tile<=448"][1] == cases["v3p fwd tile<=224"][1] == ring
    assert cases["dw v2"][1] == cases["dw v3"][1] == (
        "dw ring: 1 tiles (1 tap groups of 3 x 1 C tiles of 64 x 1 Co tiles of 64) x 2 chunks "
        "of 1 of 2 items = 2 blocks, 7 x / 5 g frame slots, 99520 bytes of shared memory; x "
        "read 1x, g 1x (re-reads from L2), partials 0.02 MB written and read")
