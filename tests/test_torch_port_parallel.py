"""The port's parallelism across processes against the JAX package on its
8-device CPU mesh (tests/conftest.py): the halo conv of a time-sharded clip
(``parallel/temporal.py``) and its gradients, ``score_long_clip``, the
data-parallel steps against ``make_train_step_shardmap`` and the
time-sharded step against ``make_time_sharded_train_step``.

The port runs as gloo jobs of 2 and 4 processes on the CPU, each rank a
subprocess under a timeout (tests/test_torch_port_multiproc.py's
``RankJob``; a failing rank fails the test and the others are killed). The JAX side runs here on a mesh of as many
devices. Tolerances: the halo conv and its dx / dw within 1e-5 (the JAX
tests' bound, tests/test_temporal_sharding.py), ``score_long_clip`` within
1e-4 (f32); the two steps in float64 on both sides, held as the port's
whole-step parity is (tests/test_torch_port_train.py: one flipped ReLU
gate moves an f32 gradient by percents), loss within 1e-4 relative,
params and BN statistics within 1e-3 of each tensor's largest |value|,
each tensor's movement within 1e-2 of its largest |movement|.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.evaluation.long_clip import score_long_clip as jscore_long_clip
from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.models import heads as jheads
from fastvideotagging_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from fastvideotagging_tpu.parallel import make_mesh as jmake_mesh
from fastvideotagging_tpu.parallel import replicated, shard_batch
from fastvideotagging_tpu.parallel.temporal import temporal_conv_time_sharded
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.shardmap_step import make_train_step_shardmap
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu.train.time_sharded import make_time_sharded_train_step
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.models.tiny3d import Tiny3D
from test_torch_port_multiproc import RankJob

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

def _worst(got, ref):
    """Largest |got - ref| over the tensors, each relative to the largest
    |value| of its reference, and its key."""
    return max((np.abs(got[k] - ref[k]).max() / max(np.abs(ref[k]).max(), 1e-30), k)
               for k in ref)


def _jax_numpy(jstate):
    return {k: v.numpy() for k, v in from_jax_variables(jax.tree.map(
        np.asarray, {"params": jstate.params, "batch_stats": jstate.batch_stats})).items()}


def _hold_step(got: dict, start: dict, jstate, jloss: float, loss: float):
    """One step of the port against one of the JAX package, held as the
    whole-step parity tests hold them."""
    assert loss == pytest.approx(jloss, rel=1e-4)
    ref = _jax_numpy(jstate)
    assert set(got) == set(ref)
    err, key = _worst(got, ref)
    assert err <= 1e-3, (key, err)
    moved = {k: ref[k] - start[k] for k in ref if np.abs(ref[k] - start[k]).max() > 0}
    assert moved
    err, key = _worst({k: got[k] - start[k] for k in moved}, moved)
    assert err <= 1e-2, (key, err)


# --------------------------------------------------------------------------
# the halo conv and the long clip: 4 ranks
# --------------------------------------------------------------------------

HALO_CASES = [(16, 3, 1, 32), (32, 5, 1, 32), (8, 1, 1, 32), (32, 3, 2, 16)]  # t, k, stride, C
LONG_CLIP = (1, 32, 32, 32, 3)

_HALO_BODY = r"""
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.evaluation.long_clip import make_time_mesh, score_long_clip
from fastvideotagging_tpu_torch.parallel import temporal as tp
import torch.distributed as dist
data = np.load(os.path.join(work, "inputs.npz"))
group = mesh.group
out["transport"] = (tp.halo_transport(group, torch.device("cpu")),
                    tp.halo_transport(group, torch.device("cuda")))
for i in range(int(data["cases"])):
    x, w, gy = (torch.from_numpy(data[f"{n}{i}"]) for n in ("x", "w", "gy"))
    stride = int(data[f"stride{i}"])
    out[f"y{i}"] = tp.temporal_conv_time_sharded(x, w, group, stride=stride).numpy()
    xl = tp.time_shard(x, group).clone().requires_grad_(True)
    wl = w.clone().requires_grad_(True)
    tp.halo_temporal_conv(xl, wl, group, stride=stride).backward(tp.time_shard(gy, group))
    parts = [torch.empty_like(xl.grad) for _ in range(world)]
    dist.all_gather(parts, xl.grad.contiguous(), group=group)
    dw = wl.grad.clone()
    dist.all_reduce(dw, group=group)
    out[f"dx{i}"], out[f"dw{i}"] = torch.cat(parts, 1).numpy(), dw.numpy()
ones = torch.ones(1, 16, 2, 2, 32)
out["ones"] = tp.temporal_conv_time_sharded(ones, torch.ones(3, 32, 1), group).numpy()
try:
    tp.temporal_conv_time_sharded(torch.ones(1, 4, 2, 2, 32), torch.ones(5, 32, 1), group)
    out["too_many"] = None
except ValueError as e:
    out["too_many"] = str(e)
model_sd = torch.load(os.path.join(work, "long_clip.pt"))
factory = lambda **kw: R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float32, dropout=0.0, **kw)
tmesh = make_time_mesh(world, device="cpu")
tp.reset_halo_counts()
out["scores"] = score_long_clip(factory, model_sd, torch.from_numpy(data["clip"]), tmesh).numpy()
out["halo_counts"] = dict(tp.halo_counts)
try:
    score_long_clip(factory, model_sd, torch.zeros(1, 20, 32, 32, 3), tmesh)
    out["bad_shape"] = None
except ValueError as e:
    out["bad_shape"] = str(e)
"""


@pytest.fixture(scope="module")
def halo_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("halo")
    rng = np.random.default_rng(0)
    arrays = {"cases": len(HALO_CASES)}
    for i, (t, k, stride, c) in enumerate(HALO_CASES):
        arrays[f"x{i}"] = rng.standard_normal((2, t, 4, 4, c), dtype=np.float32)
        arrays[f"w{i}"] = (rng.standard_normal((k, c, 16), dtype=np.float32)
                           / np.float32((k * c) ** 0.5))
        # the cotangent scaled so that dw, a sum over all 2 * T' * 16 rows,
        # comes out of unit scale like y and dx
        rows = 2 * (t // stride) * 16
        arrays[f"gy{i}"] = (rng.standard_normal((2, t // stride, 4, 4, 16), dtype=np.float32)
                            / np.float32(rows ** 0.5))
        arrays[f"stride{i}"] = stride
    arrays["clip"] = rng.standard_normal(LONG_CLIP, dtype=np.float32)
    np.savez(work / "inputs.npz", **arrays)
    model = R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float32, dropout=0.0,
                     generator=torch.Generator().manual_seed(3))
    sd = model.state_dict()
    torch.save(sd, work / "long_clip.pt")
    job = RankJob(4, _HALO_BODY, work)
    return job, arrays, model


def _jax_conv(x, w, stride):
    k = w.shape[0]
    return lax.conv_general_dilated(x, w[:, None, None], (stride, 1, 1),
                                    ((k // 2, k // 2), (0, 0), (0, 0)),
                                    dimension_numbers=("NDHWC", "DHWIO", "NDHWC"))


def _time_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("time",))


@pytest.mark.parametrize("case", range(len(HALO_CASES)),
                         ids=[f"t{t}_k{k}_s{s}" for t, k, s, _ in HALO_CASES])
def test_halo_conv_and_its_grads_match_jax(halo_job, case):
    """The halo conv over 4 ranks against the JAX package's
    ``temporal_conv_time_sharded`` on 4 devices (stride 1; the strided case,
    a stage entry, against the JAX halo conv inside shard_map, as
    tests/test_temporal_sharding.py runs it), and its dx and dw (the halos'
    gradients sent back) against the unsharded conv's VJP, within 1e-5."""
    job, arrays, _ = halo_job
    res = job.results()
    x, w, gy = (arrays[f"{n}{case}"] for n in ("x", "w", "gy"))
    stride = int(arrays[f"stride{case}"])
    if stride == 1:
        ref = np.asarray(temporal_conv_time_sharded(x, w, _time_mesh(4), "time"))
    else:
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        from fastvideotagging_tpu.parallel.temporal import halo_temporal_conv

        fn = shard_map(functools.partial(halo_temporal_conv, axis_name="time", stride=stride),
                       mesh=_time_mesh(4), in_specs=(P(None, "time"), P()),
                       out_specs=P(None, "time"))
        ref = np.asarray(jax.jit(fn)(x, w))
    np.testing.assert_allclose(ref, np.asarray(_jax_conv(x, w, stride)), rtol=1e-5, atol=1e-5)
    _, vjp = jax.vjp(lambda a, b: _jax_conv(a, b, stride), x, w)
    dx, dw = (np.asarray(g) for g in vjp(gy))
    for r in res:  # every rank gathered the whole output and gradients
        assert r[f"y{case}"].shape == ref.shape
        np.testing.assert_allclose(r[f"y{case}"], ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"dx{case}"], dx, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"dw{case}"], dw, rtol=1e-5, atol=1e-5)


def test_halo_conv_sees_zeros_at_the_clips_ends(halo_job):
    """The first and last ranks see zeros, not the ring's wrap-around: an
    all-ones clip gives 2/3 of the taps at the clip's ends and 3/3 inside,
    as the JAX halo conv does; too many shards for the halo raise; gloo's
    point-to-point takes the halos of CUDA tensors through the host."""
    job, _, _ = halo_job
    res = job.results()
    ones = jnp.ones((1, 16, 2, 2, 32))
    ref = np.asarray(temporal_conv_time_sharded(ones, jnp.ones((3, 32, 1)), _time_mesh(8),
                                                "time"))
    for r in res:
        np.testing.assert_allclose(r["ones"], ref, rtol=1e-6)
        assert r["ones"][0, 0, 0, 0, 0] == pytest.approx(2 * 32)
        assert r["ones"][0, 8, 0, 0, 0] == pytest.approx(3 * 32)
        assert r["ones"][0, 15, 0, 0, 0] == pytest.approx(2 * 32)
        assert "must be >= halo 2" in r["too_many"]
        assert r["transport"] == ("direct", "host")
    with pytest.raises(ValueError):  # the JAX package raises at the same cut
        temporal_conv_time_sharded(jnp.ones((1, 8, 2, 2, 32)), jnp.ones((5, 32, 1)),
                                   _time_mesh(8), "time")


def test_score_long_clip_matches_jax(halo_job):
    """``score_long_clip`` over 4 ranks (T = 32: 8 frames a rank, halo convs
    at every depth, the strided stage entries included) against the JAX
    package's on a 4-device time mesh with the same weights, within 1e-4;
    and against the port's own unsharded forward. A clip whose shards are
    not whole frames at every stage raises."""
    job, arrays, model = halo_job
    res = job.results()
    clip = arrays["clip"]
    variables = to_jax_variables(model.state_dict(), model)

    def factory(**kw):
        return JR2Plus1D(stage_blocks=(1, 1, 1, 1), num_classes=5, dtype=jnp.float32,
                         dropout=0.0, **kw)

    ref = np.asarray(jscore_long_clip(factory, variables, jnp.asarray(clip), _time_mesh(4)))
    jm = factory()
    unsharded = np.asarray(jheads.predict_scores(
        jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, clip), False))
    np.testing.assert_allclose(ref, unsharded, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        port = torch.softmax(model.eval()(torch.from_numpy(clip)).float(), -1).numpy()
    for r in res:
        np.testing.assert_allclose(r["scores"], ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["scores"], port, rtol=1e-4, atol=1e-4)
        assert "divisible" in r["bad_shape"]
        # 9 temporal convs of k = 3 a forward, each one exchange: the 6 of
        # stride 1 on K2's route, the 3 stage entries on F.conv3d
        assert r["halo_counts"]["exchanges_fwd"] == 9
        assert r["halo_counts"]["k2_slabs"] == 6


# --------------------------------------------------------------------------
# the data-parallel and time-sharded steps: 2 ranks, float64
# --------------------------------------------------------------------------

DP_BATCH, TS_T = 4, 16

_STEP_BODY = r"""
import functools
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.models.tiny3d import Tiny3D
from fastvideotagging_tpu_torch.parallel import shard_batch
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.shardmap_step import make_train_step_shardmap
from fastvideotagging_tpu_torch.train.state import create_train_state
from fastvideotagging_tpu_torch.train.time_sharded import make_time_sharded_train_step
cfgs = torch.load(os.path.join(work, "cfgs.pt"), weights_only=False)
data = np.load(os.path.join(work, "inputs.npz"))
batch = {k[3:]: data[k] for k in data.files if k.startswith("dp_")}
for form, factory in (("loop", make_train_step),
                      ("explicit", lambda m, c, mesh: make_train_step_shardmap(m, c, mesh))):
    model = Tiny3D(3, dtype=torch.float64)
    model.load_state_dict(torch.load(os.path.join(work, "tiny3d.pt")))
    state = create_train_state(cfgs["dp"], 2, device="cpu", model=model)
    step = factory(model, cfgs["dp"], mesh=mesh)
    state, met = step(state, shard_batch(mesh, batch))
    out[form] = ({k: v.numpy().copy() for k, v in model.state_dict().items()},
                 float(met["loss"]), float(met["top1"]))
tbatch = {k[3:]: data[k] for k in data.files if k.startswith("ts_")}
factory = functools.partial(R2Plus1D, (1, 1, 1, 1), 5, dtype=torch.float64, dropout=0.0)
step, model = make_time_sharded_train_step(factory, cfgs["ts"], mesh)
model.load_state_dict(torch.load(os.path.join(work, "r2plus1d.pt")))
state = create_train_state(cfgs["ts"], 10, device="cpu", model=model)
state, met = step(state, tbatch)
out["time"] = ({k: v.numpy().copy() for k, v in model.state_dict().items()},
               float(met["loss"]), float(met["top1"]))
"""


def _cfg(mod, model, kernels, t, hw, batch, dropout=0.0):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(name=model, num_classes=5 if model != "tiny3d" else 3,
                              compute_dtype="float64", kernels=kernels, dropout=dropout),
        # mean 0.5 and std 64/255 make the normalization exact in f32, and
        # the frames come at resize_hw: both sides feed identical clips
        data=mod.DataConfig(resize_hw=hw, crop_hw=(16, 16), mean=(0.5, 0.5, 0.5),
                            std=(64 / 255,) * 3, sampler=mod.ClipSamplerConfig(clip_len=t)),
        train=mod.TrainConfig(batch_size=batch, base_lr=0.05, weight_decay=1e-3))


def _batch(rng, b, t, hw, classes):
    return {"frames": rng.integers(0, 256, size=(b, t, *hw, 3), dtype=np.uint8),
            "labels": (np.arange(b) % classes).astype(np.int32),
            "crop_tops": rng.integers(0, hw[0] - 15, size=(b,)).astype(np.int32),
            "crop_lefts": rng.integers(0, hw[1] - 15, size=(b,)).astype(np.int32),
            "flips": rng.uniform(size=(b,)) < 0.5,
            "weights": np.ones((b,), np.float32)}


@pytest.fixture(scope="module")
def step_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("steps")
    rng = np.random.default_rng(1)
    dp = _batch(rng, DP_BATCH, 4, (20, 24), 3)
    ts = _batch(rng, 2, TS_T, (20, 20), 5)
    np.savez(work / "inputs.npz", **{f"dp_{k}": v for k, v in dp.items()},
             **{f"ts_{k}": v for k, v in ts.items()})
    cfgs = {"dp": _cfg(tconfig, "tiny3d", "cuda", 4, (20, 24), DP_BATCH),
            "ts": _cfg(tconfig, "r2plus1d_18", "cuda", TS_T, (20, 20), 2)}
    torch.save(cfgs, work / "cfgs.pt")
    tiny = Tiny3D(3, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    r21 = R2Plus1D((1, 1, 1, 1), 5, dtype=torch.float64, dropout=0.0,
                   generator=torch.Generator().manual_seed(5))
    torch.save(tiny.state_dict(), work / "tiny3d.pt")
    torch.save(r21.state_dict(), work / "r2plus1d.pt")
    return RankJob(2, _STEP_BODY, work), (dp, ts), (tiny, r21)


def _jax_state(model_def, sd, port_model, jcfg, steps_per_epoch):
    v = to_jax_variables(sd, port_model)
    return JTrainState.create(apply_fn=model_def.apply, params=v["params"],
                              batch_stats=v["batch_stats"],
                              tx=jlr.make_optimizer(jcfg.train, steps_per_epoch))


def test_data_parallel_steps_match_the_jax_shardmap_step(step_job):
    """Both of the port's data-parallel entry points on 2 ranks
    (train/loop.py's step with a mesh, train/shardmap_step.py's; one
    all-reduce a gradient, BatchNorm statistics averaged over the group) against the JAX package's
    ``make_train_step_shardmap`` on 2 devices, in float64; the two forms
    equal, and both ranks hold the same state."""
    job, (dp, _), (tiny, _) = step_job
    res = job.results()
    start = {k: v.numpy().astype(np.float32) for k, v in tiny.state_dict().items()}
    with jax.enable_x64(True):
        jcfg = _cfg(jconfig, "tiny3d", "xla", 4, (20, 24), DP_BATCH)
        jm = jget_model("tiny3d", num_classes=3, dtype=jnp.float64, bn_axis_name="data")
        mesh = jmake_mesh(2, 1)
        jstate = jax.device_put(_jax_state(jm, tiny.state_dict(), tiny, jcfg, 2),
                                replicated(mesh))
        jstate, jmet = make_train_step_shardmap(jm, jcfg, mesh)(
            jstate, shard_batch(mesh, dp), jax.random.PRNGKey(0))
        jloss, jtop1 = float(jmet["loss"]), float(jmet["top1"])
    for form in ("loop", "explicit"):
        got, loss, top1 = res[0][form]
        _hold_step({k: v.astype(np.float64) for k, v in got.items()}, start, jstate, jloss, loss)
        assert top1 == pytest.approx(jtop1, abs=1e-6)
        for r in res[1:]:  # the ranks' states are one state
            assert all(np.array_equal(got[k], r[form][0][k]) for k in got)
    a, b = res[0]["loop"][0], res[0]["explicit"][0]
    assert all(np.array_equal(a[k], b[k]) for k in a)


def test_time_sharded_step_matches_jax(step_job):
    """The time-sharded step over 2 ranks (T = 16: halo convs, BatchNorm over
    the time group, the partial pooled head's logits all-reduced, gradients
    averaged) against the JAX package's ``make_time_sharded_train_step`` on
    a 2-device time mesh, in float64, from the same weights and batch."""
    job, (_, ts), (_, r21) = step_job
    res = job.results()
    start = {k: v.numpy() for k, v in r21.state_dict().items()}
    with jax.enable_x64(True):
        jcfg = _cfg(jconfig, "r2plus1d_18", "xla", TS_T, (20, 20), 2)
        factory = functools.partial(JR2Plus1D, stage_blocks=(1, 1, 1, 1), num_classes=5,
                                    dtype=jnp.float64, dropout=0.0)
        jstep, jm = make_time_sharded_train_step(factory, jcfg, _time_mesh(2))
        jstate = _jax_state(jm, r21.state_dict(), r21, jcfg, 10)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in ts.items()},
                             jax.random.PRNGKey(0))
        jloss, jtop1 = float(jmet["loss"]), float(jmet["top1"])
    for r in res:
        got, loss, top1 = r["time"]
        _hold_step(got, start, jstate, jloss, loss)
        assert top1 == pytest.approx(jtop1, abs=1e-6)
    assert all(np.array_equal(res[0]["time"][0][k], res[1]["time"][0][k])
               for k in res[0]["time"][0])
