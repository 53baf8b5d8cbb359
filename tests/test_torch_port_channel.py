"""SlowFast's channel sharding (``model_parallel > 1``) across processes
against the JAX package's channel-sharded step and the port's unsharded
one (the counterparts of tests/test_slowfast.py's ``TestChannelParallel``
and tests/test_multihost.py's channel-sharded step and checkpoint).

One gloo job of 4 CPU ranks, data 2 x model 2 (``RankJob`` of
tests/test_torch_port_multiproc.py: each rank a subprocess under a
timeout; a failing rank fails the test). Its ranks run, in order:

* ``cli.train --preset slowfast_stretch`` (the preset's model at its
  published widths and ``model_parallel = 2``, on 4x32x32 clips, 2 steps and
  a per-epoch evaluation on the sharded model), held to the same CLI in one
  process with ``--model-parallel 1``;
* one train step of both SlowFast variants at the JAX tests' size
  (``base_width`` 16, ``stage_blocks`` (1, 1), ``alpha`` 2, 4x32x32 clips,
  B = 8): in float32 against the JAX package's step on ``make_mesh(4, 2)``
  (loss within ``rel=1e-4``, as the JAX tests hold their sharded step to
  the unsharded one), and in float64 against the port's unsharded step
  (loss, the gathered gradients and the BatchNorm statistics within 1e-5
  of each tensor's largest |value|);
* a checkpoint of the sharded state, restored at ``model_parallel = 2``
  (bit for bit) and at 1 (the gathered weights and momentum, bit for bit).

The single-process tests run the channel collectives on two gloo groups
in two threads (no job is joined).
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.parallel import make_mesh as jmake_mesh
from fastvideotagging_tpu.parallel import shard_batch as jshard_batch
from fastvideotagging_tpu.parallel.mesh import param_partition_specs as jpartition_specs
from fastvideotagging_tpu.parallel.mesh import shard_train_state as jshard_train_state
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.loop import make_train_step as jmake_train_step
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.models import zoo as tzoo
from fastvideotagging_tpu_torch.models.convert import to_jax_variables
from fastvideotagging_tpu_torch.parallel import channel, make_mesh
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.lr import clip_by_global_norm_
from fastvideotagging_tpu_torch.train.state import create_train_state
from test_torch_port_multiproc import RankJob

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-device CPU mesh")

VARIANTS = ("slowfast_r2plus1d", "slowfast_r2plus1d_tpu")
SMALL = dict(num_classes=3, alpha=2, beta=8, base_width=16, stage_blocks=(1, 1), dropout=0.0)
BATCH, HW = 8, (36, 40)  # frames at resize_hw: the device resize is the identity
SEED = 11
F64_TOL = 1e-5

_BODY = r"""
import hashlib
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.models import zoo
from fastvideotagging_tpu_torch.parallel import make_mesh, shard_batch, shard_train_state
from fastvideotagging_tpu_torch.parallel.channel import gather_along
from fastvideotagging_tpu_torch.parallel.mesh import full_state_dict, param_partition_specs
from fastvideotagging_tpu_torch.train.checkpoint import CheckpointManager
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state
import torch.distributed as dist
spec = torch.load(os.path.join(work, "spec.pt"), weights_only=False)

def digest(sd):
    h = hashlib.sha256()
    for k in sorted(sd):
        h.update(k.encode() + sd[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()

def momenta(state, gather):
    specs = param_partition_specs(state.model)
    out = {}
    for (n, p), s in zip(state.model.named_parameters(), state.optimizer.state.values()):
        buf = s["momentum_buffer"]
        out[n] = gather_along(buf, 4, gather) if gather and specs[n] is not None else buf.clone()
    return out

# 1. the train CLI joins the job; the preset's model_parallel = 2 makes it data 2 x model 2
state = cli_train.main(spec["argv"] + [
    "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
    "--process-id", str(rank), "--dist-backend", "gloo", "--dist-timeout", "60",
    "--checkpoint-dir", os.path.join(work, "ck_cli"),
    "--metrics-jsonl", os.path.join(work, f"cli{rank}.jsonl")])
whole = full_state_dict(state.model)
out["cli_digest"] = digest(whole)
out["cli_step"] = state.step
out["cli_local"] = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
if rank == 0:
    torch.save({k: v.clone() for k, v in whole.items()}, os.path.join(work, "cli_whole.pt"))
del state, whole

# 2. one step of each variant: float32 (against JAX) and float64 (against the unsharded port)
mesh = make_mesh(2, 2, device="cpu")
out["grid"] = dict(data=(mesh.data_index, mesh.data_parallel),
                   model=(mesh.model_index, mesh.model_parallel),
                   data_group=dist.get_process_group_ranks(mesh.group),
                   model_group=dist.get_process_group_ranks(mesh.model_group))
batch = spec["batch"]
kept = None
for name in spec["variants"]:
    for dt in ("float32", "float64"):
        cfg = spec["cfgs"][dt]
        model = zoo.get_model(name, device="cpu", dtype=getattr(torch, dt),
                              generator=torch.Generator().manual_seed(spec["seed"]),
                              shard_axis=mesh.model_group, **spec["small"])
        if dt == "float32":
            out[name + "/init"] = {k: v.clone() for k, v in model.state_dict().items()}
            out[name + "/specs"] = param_partition_specs(model)
        state = create_train_state(cfg, 10, device="cpu", model=model)
        shard_train_state(state, mesh)
        grads = {}
        apply = state.apply_gradients
        def capture():
            specs = param_partition_specs(model)
            for n, p in model.named_parameters():
                g = p.grad.detach()
                grads[n] = gather_along(g, 4, mesh.model_group) if specs[n] is not None else g.clone()
            apply()
        state.apply_gradients = capture
        state, met = make_train_step(model, cfg, mesh=mesh)(state, shard_batch(mesh, batch))
        state.apply_gradients = apply
        out[f"{name}/{dt}"] = dict(
            loss=float(met["loss"]), grads=grads,
            buffers={k: v.clone() for k, v in model.named_buffers()})
        if kept is None:
            kept = state

# 3. the checkpoint round trip, at model_parallel = 2 and at 1
cfg = spec["cfgs"]["float32"]
ck = CheckpointManager(os.path.join(work, "ck_tp"), mesh=mesh)
ck.save(1, kept, {"epoch": 0})
fresh = create_train_state(cfg, 10, device="cpu", model=zoo.get_model(
    spec["variants"][0], device="cpu", dtype=torch.float32,
    generator=torch.Generator().manual_seed(spec["seed"] + 1), shard_axis=mesh.model_group,
    **spec["small"]))
_, extra = ck.restore(fresh)
a, b = kept.model.state_dict(), fresh.model.state_dict()
ma, mb = momenta(kept, None), momenta(fresh, None)
out["ckpt_at_2"] = (extra, fresh.step, all(torch.equal(a[k], b[k]) for k in a),
                    all(torch.equal(ma[k], mb[k]) for k in ma))
single = create_train_state(cfg, 10, device="cpu", model=zoo.get_model(
    spec["variants"][0], device="cpu", dtype=torch.float32,
    generator=torch.Generator().manual_seed(spec["seed"] + 2), **spec["small"]))
CheckpointManager(os.path.join(work, "ck_tp")).restore(single)
whole, wm = full_state_dict(kept.model), momenta(kept, mesh.model_group)
c, mc = single.model.state_dict(), momenta(single, None)
out["ckpt_at_1"] = (all(torch.equal(c[k], whole[k]) for k in whole),
                    all(torch.equal(mc[k], wm[k]) for k in wm))
"""


def _cfg(dtype: str):
    return tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="slowfast_r2plus1d", num_classes=3,
                                  compute_dtype=dtype, dropout=0.0),
        # mean 0.5 and std 64/255 make the normalization exact in f32
        data=tconfig.DataConfig(resize_hw=HW, crop_hw=(32, 32), mean=(0.5, 0.5, 0.5),
                                std=(64 / 255,) * 3,
                                sampler=tconfig.ClipSamplerConfig(clip_len=4)),
        train=tconfig.TrainConfig(batch_size=BATCH, base_lr=0.05, weight_decay=1e-3))


def _batch():
    rng = np.random.default_rng(SEED)
    return {"frames": rng.integers(0, 256, size=(BATCH, 4, *HW, 3), dtype=np.uint8),
            "labels": (np.arange(BATCH) % 3).astype(np.int32),
            "crop_tops": rng.integers(0, HW[0] - 31, size=(BATCH,)).astype(np.int32),
            "crop_lefts": rng.integers(0, HW[1] - 31, size=(BATCH,)).astype(np.int32),
            "flips": rng.uniform(size=(BATCH,)) < 0.5,
            "weights": np.ones((BATCH,), np.float32)}


def _model(name: str, dtype=torch.float32, seed: int = SEED):
    return tzoo.get_model(name, device="cpu", dtype=dtype,
                          generator=torch.Generator().manual_seed(seed), **SMALL)


def _unsharded_step(name: str, batch: dict) -> dict:
    """The port's unsharded float64 step: loss, gradients, BN statistics."""
    model = _model(name, torch.float64)
    cfg = _cfg("float64")
    state = create_train_state(cfg, 10, device="cpu", model=model)
    grads = {}
    apply = state.apply_gradients

    def capture():
        grads.update({n: p.grad.detach().clone() for n, p in model.named_parameters()})
        apply()
    state.apply_gradients = capture
    _, met = make_train_step(model, cfg)(state, batch)
    return dict(loss=float(met["loss"]), grads=grads,
                buffers={k: v.clone() for k, v in model.named_buffers()})


def _cli_argv(train: str, val: str) -> list:
    return ["--preset", "slowfast_stretch", "--train-list", train, "--val-list", val,
            "--resize", *map(str, HW), "--crop", "32", "32", "--clip-len", "4",
            "--num-eval-clips", "2", "--batch-size", "4", "--epochs", "1", "--log-every", "1",
            "--num-workers", "1", "--compute-dtype", "float32", "--device", "cpu"]


@pytest.fixture(scope="module")
def tp_job(tmp_path_factory):
    work = tmp_path_factory.mktemp("channel")
    train, val = str(work / "train.fvtpack"), str(work / "val.fvtpack")
    tpacked.write_pack_from_arrays(
        [(f"v{i}.mp4", i % 3, (), make_frames(i % 3, 12, *HW, seed=i)) for i in range(8)],
        train, HW)
    tpacked.write_pack_from_arrays(
        [(f"w{i}.mp4", i % 3, (), make_frames(i % 3, 12, *HW, seed=40 + i)) for i in range(2)],
        val, HW)
    batch = _batch()
    spec = {"argv": _cli_argv(train, val), "variants": VARIANTS, "small": SMALL,
            "seed": SEED, "batch": batch,
            "cfgs": {dt: _cfg(dt) for dt in ("float32", "float64")}}
    torch.save(spec, work / "spec.pt")
    job = RankJob(4, _BODY, work, join=False, timeout=240)  # 4 ranks, 3 phases
    # while the ranks run: the unsharded float64 steps and the CLI in one process
    unsharded = {name: _unsharded_step(name, batch) for name in VARIANTS}
    one = cli_train.main(spec["argv"] + ["--model-parallel", "1",
                                         "--checkpoint-dir", str(work / "ck_one"),
                                         "--metrics-jsonl", str(work / "one.jsonl")])
    one_sd = {k: v.detach().clone() for k, v in one.model.state_dict().items()}
    return job, unsharded, one_sd, work


def _losses(path) -> list:
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return [row["loss"] for row in rows if "loss" in row]


def test_slowfast_stretch_cli_across_processes_matches_one_process(tp_job):
    """``cli.train --preset slowfast_stretch`` over 4 processes (data 2 x
    model 2, the preset's widths and 400 classes): each rank holds Cout / 2
    of every conv kernel, the ranks' gathered weights are one state, the
    per-epoch evaluation ran on the sharded model, the checkpoint holds
    whole tensors, and the losses and final weights agree with one process
    (float32: losses and weights within 1e-4, the weights relative to each
    tensor's largest |value|)."""
    job, _, one_sd, work = tp_job
    res = job.results()
    assert len({r["cli_digest"] for r in res}) == 1
    assert all(r["cli_step"] == 2 for r in res)
    for k, v in one_sd.items():
        local, shape = res[0]["cli_local"][k], tuple(v.shape)
        if k.endswith(".kernel"):  # every SlowFast conv is sharded
            assert local == shape[:4] + (shape[4] // 2,), k
        else:
            assert local == tuple(shape), k
    whole = torch.load(work / "cli_whole.pt")
    for k, v in one_sd.items():
        scale = max(v.abs().max().item(), 1e-30)
        assert (whole[k] - v).abs().max().item() <= 1e-4 * scale, k
    ck = torch.load(work / "ck_cli" / "step_2.pt")
    assert all(tuple(ck["model"][k].shape) == tuple(v.shape) for k, v in one_sd.items())
    np.testing.assert_allclose(_losses(work / "cli0.jsonl"), _losses(work / "one.jsonl"),
                               rtol=1e-4)
    with open(work / "cli0.jsonl") as f:
        assert any("eval_top1" in line for line in f)


def test_mesh_grid_is_row_major(tp_job):
    """Rank r = d * mp + m: the data group holds the ranks of one model
    index, the model group consecutive ranks (the reference's device
    grid)."""
    job, _, _, _ = tp_job
    for r, res in enumerate(job.results()):
        g = res["grid"]
        assert g["data"] == (r // 2, 2) and g["model"] == (r % 2, 2)
        assert g["data_group"] == [r % 2, r % 2 + 2]
        assert g["model_group"] == [r - r % 2, r - r % 2 + 1]


@pytest.mark.parametrize("name", VARIANTS)
def test_each_rank_holds_half_of_every_conv_kernel(tp_job, name):
    """Every conv the reference shards keeps Cout / 2 on each rank, equal
    bit for bit to the unsharded model's slice from the same seed;
    everything else is whole and equal."""
    job, _, _, _ = tp_job
    full = _model(name).state_dict()
    for r, res in enumerate(job.results()):
        init, specs = res[name + "/init"], res[name + "/specs"]
        sharded = {k for k, d in specs.items() if d is not None}
        assert sharded == {k for k in full if k.endswith(".kernel")}
        for k, v in full.items():
            if k in sharded:
                half = v.shape[4] // 2
                assert torch.equal(init[k], v[..., (r % 2) * half:(r % 2 + 1) * half]), k
            else:
                assert torch.equal(init[k], v), k


def _jax_sharded_loss(name: str, sd: dict, port_model, batch: dict) -> float:
    """The JAX package's channel-sharded step on make_mesh(4, 2) from the
    port's weights (the setup of tests/test_slowfast.py)."""
    jcfg = jconfig.ExperimentConfig(
        model=jconfig.ModelConfig(name=name, num_classes=3, compute_dtype="float32",
                                  dropout=0.0),
        data=jconfig.DataConfig(resize_hw=HW, crop_hw=(32, 32), mean=(0.5, 0.5, 0.5),
                                std=(64 / 255,) * 3,
                                sampler=jconfig.ClipSamplerConfig(clip_len=4)),
        train=jconfig.TrainConfig(batch_size=BATCH, base_lr=0.05, weight_decay=1e-3))
    mesh = jmake_mesh(4, 2)
    kw = {k: v for k, v in SMALL.items() if k != "num_classes"}
    model = jget_model(name, num_classes=3, dtype=jnp.float32, shard_axis="model", **kw)
    sample = jnp.zeros((1, 4, 32, 32, 3), jnp.float32)
    boxed = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), sample, train=False))
    specs = jpartition_specs(boxed)["params"]
    v = to_jax_variables(sd, port_model)
    state = JTrainState.create(apply_fn=model.apply, params=v["params"],
                               batch_stats=v["batch_stats"],
                               tx=jlr.make_optimizer(jcfg.train, 10))
    state = jshard_train_state(state, mesh, specs)
    assert "model" in str(state.params["slow_stem"]["kernel"].sharding.spec)
    step = jmake_train_step(model, jcfg, donate=False)
    _, metrics = step(state, jshard_batch(mesh, batch), jax.random.PRNGKey(1))
    return float(metrics["loss"])


@pytest.mark.parametrize("name", VARIANTS)
def test_sharded_step_matches_the_jax_sharded_step(tp_job, name):
    """Float32: every rank's loss within rel=1e-4 of the JAX package's
    channel-sharded step on make_mesh(4, 2) from the same weights and
    batch."""
    job, _, _, _ = tp_job
    res = job.results()
    model = _model(name)
    jloss = _jax_sharded_loss(name, model.state_dict(), model, _batch())
    for r in res:
        assert r[f"{name}/float32"]["loss"] == pytest.approx(jloss, rel=1e-4)


def _worst(got: dict, ref: dict) -> tuple:
    return max(((got[k].double() - ref[k].double()).abs().max().item()
                / max(ref[k].double().abs().max().item(), 1e-30), k) for k in ref)


@pytest.mark.parametrize("name", VARIANTS)
def test_sharded_step_matches_the_unsharded_step_in_float64(tp_job, name):
    """Float64 activations: the loss, the gradients gathered over the model
    group and the BatchNorm statistics of every rank within 1e-5 of the
    port's unsharded step; the ranks' gathered gradients are equal."""
    job, unsharded, _, _ = tp_job
    res = job.results()
    ref = unsharded[name]
    for r in res:
        got = r[f"{name}/float64"]
        assert got["loss"] == pytest.approx(ref["loss"], rel=F64_TOL)
        assert set(got["grads"]) == set(ref["grads"])
        err, key = _worst(got["grads"], ref["grads"])
        assert err <= F64_TOL, (key, err)
        err, key = _worst(got["buffers"], ref["buffers"])
        assert err <= F64_TOL, (key, err)
    g0 = res[0][f"{name}/float64"]["grads"]
    assert all(torch.equal(g0[k], r[f"{name}/float64"]["grads"][k]) for r in res for k in g0)


def test_sharded_checkpoint_round_trips(tp_job):
    """A save of the sharded state writes whole tensors; restored at
    model_parallel = 2 the weights and momentum are the saved ones bit for
    bit, and at model_parallel = 1 (one process's model) they are the
    gathered ones."""
    job, _, _, _ = tp_job
    for r in job.results():
        extra, step, weights, momentum = r["ckpt_at_2"]
        assert extra == {"epoch": 0} and step == 1 and weights and momentum
        assert r["ckpt_at_1"] == (True, True)


# --------------------------------------------------------------------------
# single process: the collectives on two gloo groups in two threads
# --------------------------------------------------------------------------


def _on_two_ranks(fn) -> list:
    """``fn(group)`` on two gloo groups of one store, each in a thread;
    returns the results in rank order (raises the first failure)."""
    store = dist.HashStore()
    out = [None, None]

    def run(r):
        try:
            out[r] = fn(dist.ProcessGroupGloo(store, r, 2))
        except BaseException as e:  # noqa: BLE001 - re-raised below
            out[r] = e
            raise

    threads = [threading.Thread(target=run, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for res in out:
        if isinstance(res, BaseException):
            raise res
    return out


def test_gather_backward_takes_the_rank_slice_not_a_reduce_scatter():
    """The channel gather's backward keeps this rank's channels of the
    (replicated) gradient: the same whole cotangent on both ranks gives each
    exactly its slice, not mp times it (a reduce-scatter's sum of equal
    copies); the input's backward sums the ranks' dx parts."""
    cot = torch.arange(2 * 3 * 8, dtype=torch.float64).reshape(2, 3, 8)

    def fn(group):
        r = group.rank()
        y = torch.full((2, 3, 4), float(r + 1), dtype=torch.float64, requires_grad=True)
        out = channel.gather_channels(y, group)
        (out * cot).sum().backward()
        x = torch.ones(2, 3, dtype=torch.float64, requires_grad=True)
        ((r + 1) * channel.model_input(x, group)).sum().backward()
        return out.detach(), y.grad, x.grad

    for r, (out, gy, gx) in enumerate(_on_two_ranks(fn)):
        assert torch.equal(out[..., :4], torch.ones(2, 3, 4, dtype=torch.float64))
        assert torch.equal(out[..., 4:], torch.full((2, 3, 4), 2.0, dtype=torch.float64))
        assert torch.equal(gy, cot[..., 4 * r:4 * r + 4])
        assert torch.equal(gx, torch.full((2, 3), 3.0, dtype=torch.float64))


def test_sharded_slowfast_on_two_threads_equals_the_unsharded_model():
    """A float64 forward and backward of the channel-sharded SlowFast on two
    gloo groups (threads) against the unsharded model: the outputs and the
    gathered gradients within 1e-12 of each tensor's largest |value|."""
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 32, 32, 3)))
    ref = _model(VARIANTS[0], torch.float64).train()
    ry = ref(x)
    ry.square().sum().backward()

    def fn(group):
        m = tzoo.get_model(VARIANTS[0], device="cpu", dtype=torch.float64,
                           generator=torch.Generator().manual_seed(SEED), shard_axis=group,
                           **SMALL).train()
        y = m(x)
        y.square().sum().backward()
        return y.detach(), {n: channel.gather_along(p.grad, 4, group) if n.endswith(".kernel")
                            else p.grad for n, p in m.named_parameters()}

    want = {n: p.grad for n, p in ref.named_parameters()}
    for y, grads in _on_two_ranks(fn):
        err, key = _worst({"y": y}, {"y": ry.detach()})
        assert err <= 1e-12, err
        err, key = _worst(grads, want)
        assert err <= 1e-12, (key, err)


def test_clip_norm_sums_the_sharded_parts():
    """Gradient clipping of a channel-sharded model clips with the norm of
    the whole gradient: the sharded parts' squares summed over the model
    group, the replicated gradients counted once."""
    rng = np.random.default_rng(3)
    whole = [torch.from_numpy(rng.normal(size=(3, 3, 4))), torch.from_numpy(rng.normal(size=5))]
    want = [g.clone() for g in whole]
    clip_by_global_norm_(want, 1.0)

    def fn(group):
        r = group.rank()
        grads = [whole[0][..., 2 * r:2 * r + 2].clone(), whole[1].clone()]
        clip_by_global_norm_(grads, 1.0, sharded=[True, False], group=group)
        return grads

    for r, (part, rep) in enumerate(_on_two_ranks(fn)):
        torch.testing.assert_close(part, want[0][..., 2 * r:2 * r + 2], rtol=1e-12, atol=0)
        torch.testing.assert_close(rep, want[1], rtol=1e-12, atol=0)


def test_mesh_checks_follow_the_reference():
    """One process: model_parallel = 2 raises the reference's ValueError;
    a string shard_axis (the JAX package's axis name) raises TypeError."""
    with pytest.raises(ValueError, match="model_parallel=2 must divide 1"):
        make_mesh(-1, 2, device="cpu")
    with pytest.raises(ValueError, match="model_parallel=0"):
        make_mesh(-1, 0, device="cpu")
    mesh = make_mesh(device="cpu")
    assert (mesh.data_parallel, mesh.data_index, mesh.model_index, mesh.model_group) == \
        (1, 0, 0, None)
    with pytest.raises(TypeError, match="process group"):
        tzoo.get_model(VARIANTS[0], shard_axis="model", device="cpu", **SMALL)
