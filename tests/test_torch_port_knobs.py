"""The train step's last knobs in the port against the JAX package: the
device-resident pack cache, gradient accumulation and remat.

- Device cache: on one pack (written once, read by both packages), the
  port's index batches equal the JAX ``train_index_batches`` (rows, labels,
  crops, flips) and the frames gathered from the port's cache equal the
  port's ``train_batches`` bitwise; a step fed by the cache equals a step
  fed by frames, bitwise on the CPU.
- Gradient accumulation (``optax.MultiSteps``): 22 micro steps of the
  optimizer at k = 2 on synthetic gradients, and 4 micro steps of the whole
  train step on tiny3d in float64 (the train-step parity tests' reason),
  each within 1e-6 of each tensor's largest |value| of the JAX run. The
  schedule quirk (built in micro steps, counting updates) has its own test.
- Remat: one train step of a reduced R(2+1)D in f32 under each policy;
  gradients and BN statistics within 1e-6 of each tensor's largest |value|
  of 'none''s; which convs each policy runs again in the backward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.data import device_cache as jcache
from fastvideotagging_tpu.data import packed as jpacked
from fastvideotagging_tpu.models import model_from_config as jmodel_from_config
from fastvideotagging_tpu.train import loop as jloop
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.data import device_cache as tcache
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data import pipeline as tpipeline
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.models import layers
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.train import loop as tloop
from fastvideotagging_tpu_torch.train import lr as tlr
from fastvideotagging_tpu_torch.train.state import TrainState, create_train_state

DATA = dict(resize_hw=(40, 56), crop_hw=(32, 32), num_workers=2,
            cache_on_device=True)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small models of many small ops: one thread each, since with several
    test workers on the machine more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data_cfg(mod):
    return mod.DataConfig(sampler=mod.ClipSamplerConfig(clip_len=4, stride=2), **DATA)


@pytest.fixture(scope="module")
def pack(tmp_path_factory):
    """7 videos of 10-16 frames at 40x56, 3 classes; a sampler span of 7
    frames, so short videos clamp to their last frame."""
    path = str(tmp_path_factory.mktemp("knobs") / "train.fvtpack")
    items = [(f"v{i}.mp4", i % 3, (), make_frames(i % 3, 10 + i, 40, 56, seed=i))
             for i in range(7)]
    tpacked.write_pack_from_arrays(items, path, (40, 56))
    return path


# --------------------------------------------------------------------------
# the device cache
# --------------------------------------------------------------------------


def test_index_batches_match_jax_and_gather_the_loaders_frames(pack):
    tds = tpacked.PackedDataset(pack, _data_cfg(tconfig), mode="train", seed=7)
    jds = jpacked.PackedDataset(pack, _data_cfg(jconfig), mode="train", seed=7)
    tc = tcache.build_cache(tds, device="cpu")
    jc = jcache.DeviceFrameCache(jds.pack)
    assert tc.frames.dtype == torch.uint8 and tuple(tc.frames.shape) == jc.frames.shape
    np.testing.assert_array_equal(tc.frames.numpy(), np.asarray(jc.frames))
    first = None
    for epoch in (0, 1):
        got = list(tcache.train_index_batches(tds, tc, 2, epoch))
        first = first or got[0]
        want = list(jcache.train_index_batches(jds, jc, 2, epoch))
        loader = list(tpipeline.train_batches(tds, 2, epoch, num_workers=2))
        assert len(got) == len(want) == len(loader) == 3
        for g, w, b in zip(got, want, loader):
            assert set(g) == set(w) == (set(b) - {"frames"}) | {"rows"}
            for k in w:
                np.testing.assert_array_equal(g[k], w[k])
                assert g[k].dtype == w[k].dtype, k
            frames = tc.frames[torch.from_numpy(g["rows"]).long()].numpy()
            np.testing.assert_array_equal(frames, b["frames"])
    # the multi-host row subset, as in the loader
    sub = next(tcache.train_index_batches(tds, tc, 2, 0, rows=[1]))
    np.testing.assert_array_equal(sub["rows"], first["rows"][1:])


def test_cache_guards(pack):
    tds = tpacked.PackedDataset(pack, _data_cfg(tconfig), mode="train")
    with pytest.raises(ValueError, match="cache budget"):
        tcache.build_cache(tds, budget_bytes=1000, device="cpu")
    # a replicated cache is ported: on a mesh it lives on the rank's device
    with pytest.raises(TypeError, match="parallel.Mesh"):
        tcache.build_cache(tds, mesh=object(), device="cpu")
    from fastvideotagging_tpu_torch.parallel import make_mesh

    assert tcache.build_cache(tds, mesh=make_mesh(device="cpu")).frames.device.type == "cpu"
    cache = tcache.build_cache(tds, device="cpu")
    with pytest.raises(TypeError, match="PackedDataset"):
        next(tcache.train_index_batches(object(), cache, 2, 0))
    host_crop = dataclasses.replace(_data_cfg(tconfig), host_crop=True)
    with pytest.raises(ValueError, match="host_crop"):
        next(tcache.train_index_batches(
            tpacked.PackedDataset(pack, host_crop, mode="train"), cache, 2, 0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcache.build_cache(tds)


def test_a_cache_step_equals_a_frames_step(pack):
    """One step of tiny3d fed by cache rows against one fed by the loader's
    frames, from the same weights: bitwise on the CPU."""
    cfg = tconfig.ExperimentConfig(
        model=tconfig.ModelConfig(name="tiny3d", num_classes=3, compute_dtype="float32"),
        data=_data_cfg(tconfig), train=tconfig.TrainConfig(batch_size=2))
    tds = tpacked.PackedDataset(pack, cfg.data, mode="train")
    cache = tcache.build_cache(tds, device="cpu")
    rows = next(tcache.train_index_batches(tds, cache, 2, 0))
    frames = next(tpipeline.train_batches(tds, 2, 0, num_workers=2))
    states, losses = [], []
    for device_cache, batch in ((True, rows), (False, frames)):
        state = create_train_state(cfg, 3, device="cpu",
                                   generator=torch.Generator().manual_seed(0))
        step = tloop.make_train_step(state.model, cfg, device_cache=device_cache)
        args = (cache.frames,) if device_cache else ()
        state, metrics = step(state, batch, None, *args)
        states.append(state.model.state_dict())
        losses.append(metrics["loss"])
    assert torch.equal(losses[0], losses[1])
    assert all(torch.equal(states[0][k], v) for k, v in states[1].items())


# --------------------------------------------------------------------------
# gradient accumulation
# --------------------------------------------------------------------------


def test_accumulated_updates_match_optax_multisteps():
    """22 micro steps at k = 2 of the optimizer (clip, decayed weights, SGD
    with momentum) on synthetic gradients, against optax.MultiSteps."""
    kw = dict(base_lr=0.1, lr_steps=(2,), warmup_epochs=0, weight_decay=1e-2,
              clip_grad_norm=1.0, grad_accum_steps=2)
    rng = np.random.default_rng(4)
    shapes = {"kernel": (3, 4, 5), "scale": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    tx = jlr.make_optimizer(jconfig.TrainConfig(**kw), steps_per_epoch=5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    sgd, schedule = tlr.make_optimizer(tp.values(), tconfig.TrainConfig(**kw), 5)
    state = TrainState(model=torch.nn.ParameterDict(tp), optimizer=sgd, schedule=schedule,
                       clip_grad_norm=1.0, grad_accum_steps=2)
    for i in range(22):
        g = {k: (rng.normal(size=s) * 2).astype(np.float32) for k, s in shapes.items()}
        before = {k: p.detach().clone() for k, p in tp.items()}
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients()
        assert state.step == i + 1 and all(p.grad is None for p in tp.values())
        # the parameters move on every second micro step only
        assert all(torch.equal(before[k], p) for k, p in tp.items()) == (i % 2 == 0)
        assert (state.acc_grads is None) == (i % 2 == 1)
        for k in shapes:
            ref = np.asarray(jp[k])
            np.testing.assert_allclose(tp[k].detach().numpy(), ref, rtol=0,
                                       atol=1e-6 * np.abs(ref).max())


def test_accumulation_schedule_counts_updates_in_micro_step_epochs():
    """The JAX package's quirk, kept: the schedule is built with
    steps_per_epoch in micro steps but counts updates, so with k = 2 and 5
    micro steps an epoch the lr_steps=(2,) decay fires at update 10, micro
    step 21, in epoch 4 and not 2 (and warmup lasts 2 epochs, not 1)."""
    kw = dict(base_lr=0.1, lr_steps=(2,), warmup_epochs=1, weight_decay=0.0,
              grad_accum_steps=2)
    p = torch.nn.Parameter(torch.zeros(3))
    sgd, schedule = tlr.make_optimizer([p], tconfig.TrainConfig(**kw), 5)
    state = TrainState(model=torch.nn.ParameterDict({"p": p}), optimizer=sgd,
                       schedule=schedule, grad_accum_steps=2)
    lrs = {}
    for micro in range(24):
        p.grad = torch.ones(3)
        state.apply_gradients()
        if micro % 2 == 1:
            lrs[micro] = sgd.param_groups[0]["lr"]
    # warmup over 5 updates (= 10 micro steps = 2 epochs), then base_lr until
    # update 10 (micro step 21, epoch 4), then decayed
    assert [lrs[m] for m in range(1, 10, 2)] == pytest.approx([0.0, 0.02, 0.04, 0.06, 0.08])
    assert [lrs[m] for m in range(11, 21, 2)] == pytest.approx([0.1] * 5)
    assert lrs[21] == pytest.approx(0.01) and lrs[23] == pytest.approx(0.01)
    # the same lr as optax's MultiSteps inner schedule at each update
    jsched = jlr.multifactor_schedule(jconfig.TrainConfig(**kw), 5)
    assert [lrs[m] for m in sorted(lrs)] == pytest.approx(
        [float(jsched(u)) for u in range(12)], rel=1e-6)


def test_four_accumulated_tiny3d_steps_match_jax():
    """tiny3d, float64 compute, k = 2, B = 3: four micro steps of both train
    steps from the same weights."""
    def cfg(mod, kernels):
        return mod.ExperimentConfig(
            model=mod.ModelConfig(name="tiny3d", num_classes=3, compute_dtype="float64",
                                  kernels=kernels),
            data=mod.DataConfig(resize_hw=(36, 44), crop_hw=(32, 32),
                                mean=(0.5, 0.5, 0.5), std=(64 / 255,) * 3),
            train=mod.TrainConfig(batch_size=3, base_lr=0.1, lr_steps=(1,),
                                  weight_decay=1e-3, clip_grad_norm=1.0,
                                  grad_accum_steps=2))
    rng = np.random.default_rng(5)
    batches = [{
        "frames": rng.integers(0, 256, size=(3, 4, 36, 44, 3), dtype=np.uint8),
        "labels": rng.integers(0, 3, size=(3,)).astype(np.int32),
        "crop_tops": rng.integers(0, 5, size=(3,)).astype(np.int32),
        "crop_lefts": rng.integers(0, 13, size=(3,)).astype(np.int32),
        "flips": rng.uniform(size=(3,)) < 0.5,
        "weights": np.ones(3, np.float32)} for _ in range(4)]
    with jax.enable_x64(True):
        jcfg = cfg(jconfig, "xla")
        jm = jmodel_from_config(jcfg.model)
        variables = jax.jit(jm.init, static_argnames="train")(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 32, 32, 3)), train=False)
        jstate = JTrainState.create(apply_fn=jm.apply, params=variables["params"],
                                    batch_stats=variables["batch_stats"],
                                    tx=jlr.make_optimizer(jcfg.train, 2))
        jstep = jloop.make_train_step(jm, jcfg, donate=False)
        tcfg = cfg(tconfig, "cuda")
        tstate = create_train_state(tcfg, 2, device="cpu")
        tstate.model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
        tstep = tloop.make_train_step(tstate.model, tcfg)
        for i, batch in enumerate(batches):
            jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(i))
            tstate, tmet = tstep(tstate, batch)
            assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-6)
            assert tstate.step == int(jstate.step) == i + 1
            ref = from_jax_variables(jax.tree.map(np.asarray, {
                "params": jstate.params, "batch_stats": jstate.batch_stats}))
            for k, v in tstate.model.state_dict().items():
                want = ref[k].numpy()
                np.testing.assert_allclose(v.numpy(), want, rtol=0,
                                           atol=1e-6 * np.abs(want).max(), err_msg=k)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------


def _remat_step(policy, recomputed):
    """One train-mode forward and backward of a reduced R(2+1)D (two stages,
    one block each: a downsample and a stride-1 block; T = 4 then 2, so the
    temporal convs take K2's route) under ``policy``; ``recomputed``
    collects the convs that run again in the backward."""
    model = R2Plus1D((1, 1), num_classes=5, dtype=torch.float32, remat=policy,
                     generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 16, 16, 3))
                         .astype(np.float32))
    labels = torch.tensor([1, 3])
    phase = {"backward": False}
    # pre-hooks: the recompute stops inside the last conv of a segment, once
    # that conv has saved its tensors, before the conv's module returns
    for name, mod in model.named_modules():
        if isinstance(mod, (layers.SpatialConv, layers.TemporalConv, layers.Conv3D)):
            mod.register_forward_pre_hook(
                lambda m, i, name=name: recomputed.append(name) if phase["backward"] else None)
    loss = torch.nn.functional.cross_entropy(model(x), labels)
    phase["backward"] = True
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    stats = {k: v.clone() for k, v in model.state_dict().items() if k.endswith((".mean", ".var"))}
    return loss.detach(), grads, stats


# what each policy runs again in the backward, by block (stage1_block0 has no
# downsample: 64 -> 64 channels; stage2_block0 has one, and strided convs)
_CONV1 = ["conv1.spatial", "conv1.temporal"]
_CONV2 = ["conv2.spatial", "conv2.temporal"]
RECOMPUTED = {
    "full": {"stage1_block0": _CONV1 + _CONV2,
             "stage2_block0": _CONV1 + _CONV2 + ["downsample"]},
    "dots": {b: ["conv1.temporal", "conv2.spatial", "conv2.temporal"]
             for b in ("stage1_block0", "stage2_block0")},
    "mid": {b: ["conv1.temporal", "conv2.temporal"] for b in ("stage1_block0", "stage2_block0")},
    "conv": {"stage1_block0": _CONV1 + _CONV2,
             "stage2_block0": _CONV1 + _CONV2 + ["downsample"]},
}


@pytest.fixture(scope="module")
def remat_none():
    recomputed = []
    out = _remat_step("none", recomputed)
    assert recomputed == []
    return out


@pytest.mark.parametrize("policy", ["full", "dots", "mid", "conv"])
def test_remat_policy_equals_none(policy, remat_none):
    ref_loss, ref_grads, ref_stats = remat_none
    recomputed = []
    loss, grads, stats = _remat_step(policy, recomputed)
    assert torch.allclose(loss, ref_loss, rtol=1e-6, atol=0)
    for ref, got in ((ref_grads, grads), (ref_stats, stats)):
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert (got[k] - v).abs().max() <= 1e-6 * v.abs().max(), k
    # BN statistics moved once, in the first forward (not again in the recompute)
    assert (stats["stage1_block0.bn1.mean"] != 0).any()
    by_block = {}
    for name in recomputed:
        block, conv = name.split(".", 1)
        by_block.setdefault(block, []).append(conv)
    assert {b: sorted(c) for b, c in by_block.items()} == {
        b: sorted(c) for b, c in RECOMPUTED[policy].items()}


def test_remat_is_off_in_eval_and_refuses_unknown_policies():
    model = R2Plus1D((1,), num_classes=2, dtype=torch.float32, remat="full").eval()
    with torch.no_grad():
        y = model(torch.zeros(1, 4, 16, 16, 3))
    assert y.shape == (1, 2)
    with pytest.raises(ValueError, match="unknown remat policy"):
        R2Plus1D((1,), num_classes=2, remat="dotz")
