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
the CUDA source's index arithmetic (slabs, row tiles, v3's tap order and
clipped ranges, v3p's slices across taps, the dw chunks added in order),
are held to the plain versions and the JAX kernels. Then the tile rules,
the ctypes bindings, the routing of CPU tensors and the entry point on the
CPU.
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


def _fwd_walk(x, w, k, variant, tile_s):
    """micro_fwd_kernel's arithmetic in its order: per block (slab, 128-row
    tile, 64-wide Co tile) the slices of the contraction (v2: each tap's
    32-channel slices over the padded x; v3: the same in the centre-first
    order, taps whose clipped rows miss the tile skipped; v3p: 32-deep
    slices of kappa = tap * C + c, across taps), A gathered as a_offset
    does, an f32 accumulator per block."""
    b, t, s, c = x.shape
    co = w.shape[-1]
    p = k // 2
    bm, bn, bk = micro.BM, micro.BN, 32
    src = F.pad(x, (0, 0, 0, 0, p, p)) if variant == "v2" else x
    xf = F.pad(src.reshape(-1, c), (0, 0, 0, 1))  # one zero row: the loader's zeros
    zero_row = xf.shape[0] - 1
    wf = F.pad(w.reshape(k * c, co), (0, 0, 0, bk))
    y = torch.zeros((b, t, s, co))
    plan = micro.forward_plan((b, t, s, c), co, tile_s)
    tx = src.shape[1]
    kc = -(-c // bk)
    order = [p] + [d for d in range(k) if d != p]
    for slab in range(plan.slabs):
        bb, s0 = divmod(slab, s // tile_s)
        s0 *= tile_s
        for rt in range(plan.row_tiles):
            r0, r1 = rt * bm, min((rt + 1) * bm, t * tile_s)
            r = torch.arange(r0, r1)
            tt, ss = r // tile_s, s0 + r % tile_s
            if variant == "v3p":
                slices = [(i * bk, k * c) for i in range(-(-k * c // bk))]
            else:
                taps = order if variant == "v3" else range(k)
                slices = []
                for tap in taps:
                    off = tap - p
                    lo, hi = max(0, -off) * tile_s, (t - max(0, off)) * tile_s
                    if variant == "v3" and min(hi, r1) <= max(lo, r0):
                        continue  # the tap's rows miss the tile
                    slices += [(tap * c + j * bk, tap * c + c) for j in range(kc)]
            for n0 in range(0, co, bn):
                acc = torch.zeros((len(r), bn))
                for kbase, klimit in slices:
                    kappa = torch.arange(kbase, kbase + bk)
                    tap, ch = kappa // c, kappa % c
                    frame = tt[:, None] + tap[None] - (0 if variant == "v2" else p)
                    ok = (kappa < klimit)[None] & (frame >= 0) & (frame < tx)
                    rows = torch.where(ok, (bb * tx + frame) * s + ss[:, None], zero_row)
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


@pytest.mark.parametrize("t,k", [(1, 3), (2, 3), (4, 3), (3, 5)])
@pytest.mark.parametrize("variant", ["v2", "v3", "v3p"])
def test_forward_walk_matches_plain(variant, t, k):
    """The forward kernels' walk at ragged widths, 8-column tiles (a row
    tile holds several frames' rows), against the plain versions; K8's
    slices straddle taps (C = 40 is not a multiple of 32)."""
    x, w, _ = _inputs(t, seed=2, k=k)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    plain = {"v2": micro.temporal_v2_plain, "v3": micro.temporal_v3_plain,
             "v3p": micro.temporal_v3p_plain}[variant]
    _close(_fwd_walk(xt, wt, k, variant, 8), plain(xt, wt, k, 8), FWD_TOL)


def test_forward_walk_with_row_tiles_across_frames():
    """One 384-column tile: a slab's 3 * 384 rows take nine 128-row tiles,
    the outer taps' clipped ranges start and end inside tiles."""
    x, w, _ = _inputs(3, seed=3, s=384, c=16, co=72)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert micro.forward_plan(tuple(x.shape), 72, 384).row_tiles == 9
    for variant in ("v2", "v3", "v3p"):
        _close(_fwd_walk(xt, wt, K, variant, 384), micro.temporal_v3_plain(xt, wt, K), FWD_TOL)


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
    # S = 24: v2 halves 512 down to 8, v3 takes all 24 columns
    assert cases["v2 fwd"][1] == "6 slabs of 8 columns x 1 row tiles x 1 Co tiles = 6 blocks"
    assert cases["v3 fwd tile<=448"][1].startswith("2 slabs of 24 columns")
    assert cases["dw v2"][1] == "6 steps of 8 columns in 6 chunks of 1, 18 blocks"
