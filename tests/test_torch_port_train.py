"""The port's training pieces against the JAX package's: losses, LR
schedule, optimizer updates, and whole train steps.

Inputs, weights and gradients come from numpy seeds and are handed to both
sides. Tolerances: losses 1e-6 (f32, same formula); the schedule 1e-6
relative at every step (optax computes it in f32); five optimizer updates
within 1e-6 of the largest |value| per tensor; three steps of
``make_train_step`` on a reduced-depth R(2+1)D ((1,1,1,1) blocks, B = 4,
16x32x32 crops, dropout 0, JAX convs with ``kernels='xla'``, the port's
through the kernels' plain versions and autograd Functions): losses within
1e-4 relative, params and batch statistics within 1e-3 of the largest
|value| per tensor (the test says why it computes in float64 and what it
holds beside that).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.models import heads as jheads
from fastvideotagging_tpu.models.r2plus1d import R2Plus1D as JR2Plus1D
from fastvideotagging_tpu.train import loop as jloop
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train import metrics as jmetrics
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.models import heads as theads
from fastvideotagging_tpu_torch.models.convert import from_jax_variables, to_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D as TR2Plus1D
from fastvideotagging_tpu_torch.train import loop as tloop
from fastvideotagging_tpu_torch.train import lr as tlr
from fastvideotagging_tpu_torch.train import metrics as tmetrics
from fastvideotagging_tpu_torch.train.state import TrainState, create_train_state


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------


@pytest.mark.parametrize("weights", ["none", "ones", "mask", "zeros"])
def test_softmax_cross_entropy_matches_jax(weights):
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(6, 9)) * 3).astype(np.float32)
    labels = rng.integers(0, 9, size=(6,)).astype(np.int32)
    w = {"none": None, "ones": np.ones(6, np.float32),
         "mask": np.array([1, 1, 0, 1, 0, 0], np.float32),
         "zeros": np.zeros(6, np.float32)}[weights]
    ref = float(jheads.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                             None if w is None else jnp.asarray(w)))
    got = float(theads.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                             None if w is None else torch.from_numpy(w)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    if weights == "zeros":
        assert got == 0.0  # divided by max(sum(weights), 1), not by 0


@pytest.mark.parametrize("weights", ["none", "mask", "zeros"])
def test_sigmoid_bce_matches_jax(weights):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(5, 7)) * 4).astype(np.float32)
    multihot = (rng.uniform(size=(5, 7)) < 0.3).astype(np.float32)
    w = {"none": None, "mask": np.array([1, 0, 1, 1, 0], np.float32),
         "zeros": np.zeros(5, np.float32)}[weights]
    ref = float(jheads.sigmoid_bce(jnp.asarray(logits), jnp.asarray(multihot),
                                   None if w is None else jnp.asarray(w)))
    got = float(theads.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(multihot),
                                   None if w is None else torch.from_numpy(w)))
    assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)


def test_losses_compute_in_f32_from_bf16_logits():
    logits = torch.tensor([[4.0, -2.0, 0.5]], dtype=torch.bfloat16)
    loss = theads.softmax_cross_entropy(logits, torch.tensor([1]))
    assert loss.dtype == torch.float32


# --------------------------------------------------------------------------
# config, schedule, optimizer
# --------------------------------------------------------------------------


def test_train_config_and_presets_mirror_jax():
    for name in ("TrainConfig", "ParallelConfig"):
        assert dataclasses.asdict(getattr(tconfig, name)()) == \
            dataclasses.asdict(getattr(jconfig, name)())
    assert set(tconfig.PRESETS) == set(jconfig.PRESETS)
    for name, preset in tconfig.PRESETS.items():
        got, ref = dataclasses.asdict(preset), dataclasses.asdict(jconfig.PRESETS[name])
        assert got["model"].pop("kernels") == "cuda" and ref["model"].pop("kernels") == "xla"
        assert got == ref, name
    p = tconfig.PRESETS["r2plus1d18_ucf101"]
    assert (p.model.name, p.model.num_classes, p.train.batch_size) == ("r2plus1d_18", 101, 32)


@pytest.mark.parametrize("kw,steps_per_epoch", [
    (dict(base_lr=0.1, lr_steps=(2, 4), warmup_epochs=1), 5),
    (dict(base_lr=0.01, lr_steps=(10, 20), warmup_epochs=0), 3),
    (dict(base_lr=0.05, lr_steps=(3,), lr_decay=0.5, warmup_epochs=2), 4),
    (dict(base_lr=0.02, lr_steps=(), warmup_epochs=1), 7),
])
def test_schedule_matches_optax_at_every_step(kw, steps_per_epoch):
    ref = jlr.multifactor_schedule(jconfig.TrainConfig(**kw), steps_per_epoch)
    got = tlr.multifactor_schedule(tconfig.TrainConfig(**kw), steps_per_epoch)
    last = (max(kw["lr_steps"], default=2) + 2) * steps_per_epoch
    for step in range(last):
        assert got(step) == pytest.approx(float(ref(step)), rel=1e-6, abs=1e-12), step


def test_schedule_rejects_warmup_past_first_decay():
    with pytest.raises(ValueError, match="must end before"):
        tlr.multifactor_schedule(tconfig.TrainConfig(lr_steps=(2, 4), warmup_epochs=2), 5)
    # gradient accumulation keeps the schedule built in micro steps (the JAX
    # package's MultiSteps wraps the same chain); k < 1 is refused
    _, sched = tlr.make_optimizer([torch.nn.Parameter(torch.zeros(2))],
                                  tconfig.TrainConfig(grad_accum_steps=2, lr_steps=(2,)), 5)
    assert [sched(s) for s in (9, 10)] == [0.01, pytest.approx(0.001)]
    with pytest.raises(ValueError, match="grad_accum_steps"):
        tlr.make_optimizer([torch.nn.Parameter(torch.zeros(2))],
                           tconfig.TrainConfig(grad_accum_steps=0), 5)


@pytest.mark.parametrize("clip", [0.0, 0.5, 1e6])
def test_five_optimizer_updates_match_optax(clip):
    kw = dict(base_lr=0.1, lr_steps=(1,), warmup_epochs=0, weight_decay=1e-2,
              clip_grad_norm=clip)
    rng = np.random.default_rng(2)
    shapes = {"kernel": (3, 4, 5), "scale": (5,), "bias": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 2).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    tx = jlr.make_optimizer(jconfig.TrainConfig(**kw), steps_per_epoch=3)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    sgd, schedule = tlr.make_optimizer(tp.values(), tconfig.TrainConfig(**kw), 3)
    state = TrainState(model=torch.nn.ParameterDict(tp), optimizer=sgd, schedule=schedule,
                       clip_grad_norm=clip)
    for g in grads:
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        state.apply_gradients()
    assert state.step == 5 and all(p.grad is None for p in tp.values())
    for k in shapes:
        ref = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].detach().numpy(), ref, rtol=0,
                                   atol=1e-6 * np.abs(ref).max())


def test_metrics_copy_matches_jax():
    rng = np.random.default_rng(3)
    scores = rng.uniform(size=(12, 5))
    labels = rng.integers(0, 5, size=12)
    multihot = (rng.uniform(size=(12, 5)) < 0.4).astype(np.float32)
    for k in (1, 3):
        assert tmetrics.topk_accuracy(scores, labels, k) == jmetrics.topk_accuracy(scores, labels, k)
    assert tmetrics.mean_average_precision(scores, multihot) == \
        jmetrics.mean_average_precision(scores, multihot)
    a, b = (m.per_tag_precision_recall(scores, multihot) for m in (tmetrics, jmetrics))
    assert all(np.array_equal(a[k], b[k]) for k in b)
    rm = tmetrics.RunningMean()
    rm.update(2.0, 3.0)
    rm.update(4.0)
    assert rm.value == pytest.approx(2.5)


# --------------------------------------------------------------------------
# whole train steps
# --------------------------------------------------------------------------

NUM_CLASSES = 5
BLOCKS = (1, 1, 1, 1)


def _cfgs(multilabel=False, dropout=0.0, compute_dtype="float32", **train_kw):
    out = []
    for mod, kernels in ((jconfig, "xla"), (tconfig, "cuda")):
        out.append(mod.ExperimentConfig(
            model=mod.ModelConfig(num_classes=NUM_CLASSES, multilabel=multilabel,
                                  dropout=dropout, kernels=kernels,
                                  compute_dtype=compute_dtype),
            # mean 0.5 and std 64/255 make the normalization (x - 127.5) / 64,
            # exact in f32: both sides feed their models identical clips
            data=mod.DataConfig(resize_hw=(36, 44), crop_hw=(32, 32),
                                mean=(0.5, 0.5, 0.5), std=(64 / 255,) * 3),
            train=mod.TrainConfig(batch_size=4, base_lr=0.05, lr_steps=(1,),
                                  weight_decay=1e-3, **train_kw)))
    return out


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    b = cfg.train.batch_size
    labels = (np.arange(b) % NUM_CLASSES).astype(np.int32)
    batch = {
        "frames": rng.integers(0, 256, size=(b, 16, 36, 44, 3), dtype=np.uint8),
        "labels": labels,
        "crop_tops": rng.integers(0, 5, size=(b,)).astype(np.int32),
        "crop_lefts": rng.integers(0, 13, size=(b,)).astype(np.int32),
        "flips": rng.uniform(size=(b,)) < 0.5,
        "weights": np.array([1, 1, 1, 0], np.float32),
    }
    if cfg.model.multilabel:
        batch["multihot"] = np.eye(NUM_CLASSES, dtype=np.float32)[labels]
    return batch


def _jax_state(jcfg, steps_per_epoch):
    jm = JR2Plus1D(stage_blocks=BLOCKS, num_classes=NUM_CLASSES,
                   dtype=jnp.dtype(jcfg.model.compute_dtype),
                   dropout=jcfg.model.dropout, backend="xla")
    variables = jax.jit(jm.init, static_argnames="train")(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 32, 32, 3)), train=False)
    state = JTrainState.create(apply_fn=jm.apply, params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               tx=jlr.make_optimizer(jcfg.train, steps_per_epoch))
    return jm, state


def _jax_numpy(jstate):
    return jax.tree.map(np.asarray, {"params": jstate.params,
                                     "batch_stats": jstate.batch_stats})


def _port_state(tcfg, jstate, steps_per_epoch):
    tm = TR2Plus1D(stage_blocks=BLOCKS, num_classes=NUM_CLASSES,
                   dtype=getattr(torch, tcfg.model.compute_dtype),
                   dropout=tcfg.model.dropout, backend="cuda")
    tm.load_state_dict(from_jax_variables(_jax_numpy(jstate)))
    return create_train_state(tcfg, steps_per_epoch, device="cpu", model=tm)


def _worst(got, ref):
    """Largest |got - ref| over the tensors, each relative to the largest
    |value| of its reference, and its key."""
    return max((np.abs(got[k] - ref[k]).max() / np.abs(ref[k]).max(), k) for k in ref)


@pytest.mark.parametrize("multilabel,clip", [(False, 0.0), (True, 1.0)],
                         ids=["softmax", "multilabel_clipped"])
def test_three_train_steps_match_jax(multilabel, clip):
    """Three steps of both ``make_train_step``s on a reduced-depth R(2+1)D,
    each state running free from the same weights.

    Both sides compute in float64 (params, optimizer, head and loss stay
    f32): at B = 4 and 32 samples per channel in stage 4 the f32 step is
    ill-conditioned (against an f64 run of the port, the f32 gradients of
    the JAX package are off by up to 4e-2 of a tensor's largest |gradient|
    and the port's by 1e-2, so they cannot agree within 1e-3: a rounding
    error that flips one ReLU gate moves a gradient summed over a few
    hundred elements by percents), and the point here is the algorithm, not
    the rounding. For the same reason the frames need no resize and the
    normalization constants are exact, so the clips are bitwise equal.

    After every step: loss within 1e-4 relative; params and batch statistics
    within 1e-3 of the largest |value| per tensor; and what each tensor moved
    by since the start within 1e-2 of its largest |movement| (kernels move by
    far less than 1e-3 of their values, so the second bound alone would not
    see a wrong update)."""
    with jax.enable_x64(True):
        jcfg, tcfg = _cfgs(multilabel=multilabel, clip_grad_norm=clip,
                           compute_dtype="float64")
        jm, jstate = _jax_state(jcfg, steps_per_epoch=2)
        tstate = _port_state(tcfg, jstate, steps_per_epoch=2)
        start = {k: v.numpy().copy() for k, v in tstate.model.state_dict().items()}
        jstep = jloop.make_train_step(jm, jcfg, donate=False)
        tstep = tloop.make_train_step(tstate.model, tcfg)
        for i in range(3):  # the LR decays at step 2 (lr_steps=(1,), 2 steps per epoch)
            batch = _batch(jcfg, seed=i)
            jstate, jmet = jstep(jstate, batch, jax.random.PRNGKey(i))
            tstate, tmet = tstep(tstate, batch)
            assert isinstance(tmet["loss"], torch.Tensor) and tmet["loss"].ndim == 0
            assert float(tmet["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-4)
            if multilabel:
                assert "top1" not in tmet
            else:
                assert float(tmet["top1"]) == pytest.approx(float(jmet["top1"]), abs=1e-6)
            assert tstate.step == int(jstate.step) == i + 1
            ref = {k: v.numpy() for k, v in from_jax_variables(_jax_numpy(jstate)).items()}
            got = {k: v.numpy() for k, v in tstate.model.state_dict().items()}
            assert set(got) == set(ref)
            err, key = _worst(got, ref)
            assert err <= 1e-3, (i, key, err)
            moved = {k: ref[k] - start[k] for k in ref}
            assert all(np.abs(v).max() > 0 for v in moved.values())
            err, key = _worst({k: got[k] - start[k] for k in ref}, moved)
            assert err <= 1e-2, (i, key, err)
    # a BN running mean really moved away from its zero init
    assert np.abs(got["stage1_block0.bn1.mean"]).max() > 1e-3


def test_dropout_is_seeded_in_train_and_identity_in_eval():
    tm = TR2Plus1D(stage_blocks=BLOCKS, num_classes=NUM_CLASSES, dtype=torch.float32,
                   dropout=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 4, 16, 16, 3))
                         .astype(np.float32))
    tm.train()
    with torch.no_grad():
        a = tm(x, generator=torch.Generator().manual_seed(1))
        b = tm(x, generator=torch.Generator().manual_seed(1))
        c = tm(x, generator=torch.Generator().manual_seed(2))
        tm.eval()
        e1, e2 = tm(x), tm(x, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError, match="dropout"):
        TR2Plus1D(stage_blocks=BLOCKS, dropout=1.0)


def test_trained_port_model_goes_back_to_jax():
    jcfg, tcfg = _cfgs()
    jm, jstate = _jax_state(jcfg, steps_per_epoch=2)
    tstate = _port_state(tcfg, jstate, steps_per_epoch=2)
    tstate, _ = tloop.make_train_step(tstate.model, tcfg)(tstate, _batch(tcfg))
    variables = to_jax_variables(tstate.model.state_dict())
    assert jax.tree.structure(variables) == jax.tree.structure(_jax_numpy(jstate))
    back = from_jax_variables(variables)
    assert all(torch.equal(back[k], v) for k, v in tstate.model.state_dict().items())
    x = np.random.default_rng(5).normal(size=(1, 16, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tstate.model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_state_and_step_entry_points():
    _, tcfg = _cfgs()
    sample = tloop.make_sample_batch(tcfg)
    assert sample["frames"].shape == (4, 16, 36, 44, 3) and sample["frames"].dtype == torch.uint8
    assert "multihot" not in sample
    hc = dataclasses.replace(tcfg, data=dataclasses.replace(tcfg.data, host_crop=True))
    assert tloop.make_sample_batch(hc, batch_size=2)["frames"].shape == (2, 16, 32, 32, 3)
    # the device cache: index-only sample batches; its step takes the cache's frames
    rows = tloop.make_sample_batch(tcfg, device_cache=True)
    assert rows["rows"].shape == (4, 16) and "frames" not in rows
    # remat: the r2plus1d family takes the policies (tests/test_torch_port_knobs.py
    # holds each to 'none'); an unknown one and a model without the knob
    # (tiny3d) raise
    remat = dataclasses.replace(tcfg, model=dataclasses.replace(tcfg.model, remat="conv"))
    st = create_train_state(remat, 2, device="cpu")
    assert all(getattr(st.model, n).remat == "conv" for n in st.model.block_names)
    cache_step = tloop.make_train_step(st.model, remat, device_cache=True)
    with pytest.raises(ValueError, match="cache's frames"):
        cache_step(st, rows)
    with pytest.raises(ValueError, match="unknown remat policy"):
        create_train_state(dataclasses.replace(
            tcfg, model=dataclasses.replace(tcfg.model, remat="some")), 2, device="cpu")
    with pytest.raises(TypeError, match="remat"):
        create_train_state(dataclasses.replace(
            tcfg, model=dataclasses.replace(tcfg.model, name="tiny3d", remat="full")), 2,
            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            create_train_state(tcfg, 2)
    # from the config alone: seeded init, train mode, f32 params, on the CPU
    a = create_train_state(tcfg, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    b = create_train_state(tcfg, 2, device="cpu", generator=torch.Generator().manual_seed(3))
    assert a.model.training and a.step == 0
    assert all(p.dtype == torch.float32 for p in a.model.parameters())
    assert all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    step = tloop.make_train_step(a.model, tcfg)
    with pytest.raises(ValueError, match="another model"):
        step(b, sample)
