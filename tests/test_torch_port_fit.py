"""The port's training path around the step: ``fit`` against the JAX
package's ``fit``, against a hand loop, resumed and interrupted runs,
checkpoints, the train CLI, ``tag(checkpoint=...)``, the debug helpers, the
graceful stopper and the tiny3d backbone.

Data: the conftest's synthetic set (6 videos of 24 frames at 48x64, 3
classes), at the config of tests/test_fit_integration.py (batch 3, so 2
steps an epoch; 4-frame clips at stride 2; 40x56 resize, 32x32 crops).

Tolerances. ``fit`` against the JAX ``fit`` (tiny3d, the same initial
variables, 2 epochs of 2 steps) runs in float64 on both sides, as the
train-step parity tests do (the params, optimizer, head and loss stay f32):
losses within 1e-4 relative, top1 within 1e-6, final params and BN
statistics within 1e-3 of each tensor's largest |value|. Within the port,
on the CPU, everything is bitwise: ``fit`` on a reduced-depth R(2+1)D with
dropout 0.5 equals a hand loop of ``train_batches`` -> ``make_train_step``
with the per-step dropout generator, and resumed runs equal unbroken ones
(model and optimizer state).
"""

import dataclasses
import json
import os
import shutil
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu import config as jconfig
from fastvideotagging_tpu.data import ucf101 as jucf101
from fastvideotagging_tpu.models import model_from_config as jmodel_from_config
from fastvideotagging_tpu.train import fit as jfit
from fastvideotagging_tpu.train import loop as jloop
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.state import TrainState as JTrainState
from fastvideotagging_tpu.utils import debug as jdebug
from fastvideotagging_tpu.utils.interrupt import GracefulStopper as JStopper
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch import tag
from fastvideotagging_tpu_torch.cli import train as cli_train
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data import pipeline as tpipeline
from fastvideotagging_tpu_torch.data import synthetic
from fastvideotagging_tpu_torch.data import ucf101 as tucf101
from fastvideotagging_tpu_torch.models import zoo
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.r2plus1d import R2Plus1D
from fastvideotagging_tpu_torch.train import checkpoint as tckpt
from fastvideotagging_tpu_torch.train import fit as tfit
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import create_train_state
from fastvideotagging_tpu_torch.utils import debug as tdebug
from fastvideotagging_tpu_torch.utils.interrupt import GracefulStopper as TStopper

SMALL_R2PLUS1D = "r2plus1d_1111"  # registered by the fixture below


def _cfg(mod, model="tiny3d", checkpoint_dir="", epochs=2, compute_dtype="float32",
         dropout=0.5, **train_kw):
    return mod.ExperimentConfig(
        model=mod.ModelConfig(name=model, num_classes=3, compute_dtype=compute_dtype,
                              dropout=dropout,
                              kernels="xla" if mod is jconfig else "cuda"),
        data=mod.DataConfig(source_hw=(48, 64), resize_hw=(40, 56), crop_hw=(32, 32),
                            sampler=mod.ClipSamplerConfig(clip_len=4, stride=2),
                            num_workers=2, random_flip=False),
        train=mod.TrainConfig(batch_size=3, num_epochs=epochs, base_lr=0.05,
                              weight_decay=0.0, log_every=1,
                              checkpoint_dir=checkpoint_dir, **train_kw),
        parallel=mod.ParallelConfig(data_parallel=1, model_parallel=1),
    )


@pytest.fixture()
def records(synthetic_dataset):
    root, list_path = synthetic_dataset
    return (jucf101.load_video_list(list_path, root=root),
            tucf101.load_video_list(list_path, root=root))


@pytest.fixture(scope="module")
def small_r2plus1d():
    """A reduced-depth R(2+1)D ((1,1,1,1) blocks) under a zoo name, so fit
    builds it from the config as it builds any model."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(zoo._REGISTRY, SMALL_R2PLUS1D,
                   lambda num_classes, **kw: R2Plus1D((1, 1, 1, 1), num_classes, **kw))
        yield


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These models are many small ops: on one thread each, since with
    several test workers on the machine more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_init(cfg, seed=1):
    model = jmodel_from_config(cfg.model)
    variables = jax.jit(model.init, static_argnames="train")(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4, 32, 32, 3), jnp.float32), train=False)
    return jax.tree.map(np.asarray, variables)


def _metrics(path):
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    return [(r["step"], r["epoch"], r["loss"], r["top1"]) for r in lines if "loss" in r]


def _host_state(state):
    """Model state_dict and optimizer momentum buffers, copied."""
    sd = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    opt = {i: s["momentum_buffer"].clone()
           for i, s in state.optimizer.state_dict()["state"].items()}
    return sd, opt, state.step


def _assert_bitwise(a, b):
    (sda, opta, stepa), (sdb, optb, stepb) = a, b
    assert stepa == stepb
    assert set(sda) == set(sdb) and set(opta) == set(optb)
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k
    for i in opta:
        assert torch.equal(opta[i], optb[i]), i


# --------------------------------------------------------------------------
# fit against the JAX package and against a hand loop
# --------------------------------------------------------------------------


def test_fit_matches_the_jax_fit(records, tmp_path):
    jrecs, trecs = records
    with jax.enable_x64(True):
        jcfg = _cfg(jconfig, compute_dtype="float64")
        variables = _jax_init(jcfg)
        jstate = jfit.fit(jcfg, jrecs, metrics_path=str(tmp_path / "jax.jsonl"),
                          init_variables=variables)
        ref_vars = jax.tree.map(np.asarray, {"params": jstate.params,
                                             "batch_stats": jstate.batch_stats})
    tstate = tfit.fit(_cfg(tconfig, compute_dtype="float64"), trecs,
                      metrics_path=str(tmp_path / "port.jsonl"),
                      init_variables=variables, device="cpu")
    want, got = _metrics(tmp_path / "jax.jsonl"), _metrics(tmp_path / "port.jsonl")
    assert [r[:2] for r in got] == [r[:2] for r in want] == [(1, 0), (2, 0), (3, 1), (4, 1)]
    for g, w in zip(got, want):
        assert g[2] == pytest.approx(w[2], rel=1e-4)
        assert g[3] == pytest.approx(w[3], abs=1e-6)
    assert tstate.step == int(jstate.step) == 4
    ref = {k: v.numpy() for k, v in from_jax_variables(ref_vars).items()}
    start = from_jax_variables(variables)
    sd = tstate.model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        assert np.abs(sd[k].numpy() - v).max() <= 1e-3 * np.abs(v).max(), k
        assert not torch.equal(sd[k], start[k]), k  # every tensor trained


@pytest.fixture(scope="module")
def unbroken(synthetic_dataset, small_r2plus1d, tmp_path_factory):
    """fit on the reduced-depth R(2+1)D with dropout 0.5, 2 epochs unbroken:
    its final state, metrics lines and checkpoint directory (steps 2 and
    4, one at each epoch's end)."""
    root, list_path = synthetic_dataset
    tmp = tmp_path_factory.mktemp("unbroken")
    ck = str(tmp / "ckpt")
    state = tfit.fit(_cfg(tconfig, model=SMALL_R2PLUS1D, checkpoint_dir=ck),
                     tucf101.load_video_list(list_path, root=root),
                     metrics_path=str(tmp / "m.jsonl"), device="cpu")
    return _host_state(state), _metrics(tmp / "m.jsonl"), ck


def _hand_loop(cfg, trecs, epochs):
    ds = tpacked.open_dataset(trecs, cfg.data, mode="train", seed=cfg.train.seed)
    steps_per_epoch = len(ds) // cfg.train.batch_size
    state = create_train_state(cfg, steps_per_epoch, device="cpu",
                               generator=torch.Generator().manual_seed(cfg.train.seed))
    step = make_train_step(state.model, cfg)
    losses = []
    for epoch in range(epochs):
        for batch in tpipeline.train_batches(ds, cfg.train.batch_size, epoch, num_workers=2):
            gen = tfit.dropout_generator(cfg.train.seed, state.step, torch.device("cpu"))
            state, metrics = step(state, batch, gen)
            losses.append(float(metrics["loss"]))
    return state, losses


def test_fit_equals_a_hand_loop(records, unbroken):
    """Reduced-depth R(2+1)D, dropout 0.5: bitwise on the CPU, with the
    kernels' plain versions and autograd Functions inside fit."""
    _, trecs = records
    hand, losses = _hand_loop(_cfg(tconfig, model=SMALL_R2PLUS1D), trecs, epochs=2)
    state, metrics, _ = unbroken
    assert [r[2] for r in metrics] == losses
    _assert_bitwise(state, _host_state(hand))
    # dropout drew a different mask at every step: the same batch and
    # weights give another loss under another step's generator
    g0, g1 = (tfit.dropout_generator(0, s, torch.device("cpu")) for s in (0, 1))
    assert not torch.equal(torch.rand(8, generator=g0), torch.rand(8, generator=g1))


# --------------------------------------------------------------------------
# resume
# --------------------------------------------------------------------------


def test_resume_after_one_epoch_is_exact(records, unbroken, tmp_path):
    """A 1-epoch run resumed to 2 epochs. The 1-epoch run is the unbroken
    run's first epoch: the LR schedule does not depend on num_epochs, so
    its epoch-end checkpoint (step 2, epoch 0) is the one a 1-epoch run
    writes. Copied alone into a fresh directory, it is resumed with
    dropout 0.5, so the resumed steps draw their masks from the restored
    step."""
    _, trecs = records
    ck = tmp_path / "ckpt"
    ck.mkdir()
    shutil.copy(os.path.join(unbroken[2], "step_2.pt"), ck / "step_2.pt")
    mgr = tckpt.CheckpointManager(str(ck))
    assert mgr.latest_step() == 2
    resumed = tfit.fit(_cfg(tconfig, model=SMALL_R2PLUS1D, checkpoint_dir=str(ck),
                            resume=True), trecs, device="cpu")
    _assert_bitwise(_host_state(resumed), unbroken[0])
    assert mgr.all_steps() == [2, 4]


def test_stopped_then_resumed_run_is_exact(records, tmp_path):
    """SIGTERM during the run (sent from the epoch-0 eval hook): the stopper
    turns it into a checkpoint at the next step boundary (step 2, the first
    batch of epoch 1, recorded as epoch 0) and a clean return; the resumed
    run equals the unbroken one. (A stop inside an epoch records epoch - 1,
    as the JAX package does, so its resume replays that epoch whole: see
    the bookkeeping test.)"""
    _, trecs = records
    whole = tfit.fit(_cfg(tconfig), trecs, device="cpu")
    ck = str(tmp_path / "ckpt")
    handler = signal.getsignal(signal.SIGTERM)

    def eval_fn(state, epoch):
        os.kill(os.getpid(), signal.SIGTERM)
        return {}

    stopped = tfit.fit(_cfg(tconfig, checkpoint_dir=ck), trecs, eval_fn=eval_fn,
                       device="cpu")
    assert stopped.step == 2
    mgr = tckpt.CheckpointManager(ck)
    assert mgr.all_steps() == [2]
    assert signal.getsignal(signal.SIGTERM) == handler  # the stopper restored it
    resumed = tfit.fit(_cfg(tconfig, checkpoint_dir=ck, resume=True), trecs, device="cpu")
    _assert_bitwise(_host_state(resumed), _host_state(whole))


# --------------------------------------------------------------------------
# bookkeeping against the JAX package
# --------------------------------------------------------------------------


def _recorder(log):
    class Recorder:
        def __init__(self, directory, max_to_keep=3):
            pass

        def save(self, step, state, extra=None):
            log.append(("save", int(step), int(extra["epoch"])))

        def restore(self, target_state, step=None):
            return None, None

        def latest_step(self):
            return None

        def wait(self):
            pass

        def close(self):
            pass

    return Recorder


def _stop_after_first_step(make):
    def wrapped(*args, **kw):
        step = make(*args, **kw)
        calls = []

        def run(*a, **k):
            out = step(*a, **k)
            calls.append(1)
            if len(calls) == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return out

        return run

    return wrapped


@pytest.mark.parametrize("every,stop", [(1, False), (2, False), (0, True)],
                         ids=["every1", "every2", "stop_mid_epoch"])
def test_checkpoint_and_eval_bookkeeping_matches_jax(records, monkeypatch, tmp_path,
                                                     every, stop):
    jrecs, trecs = records
    events = {}
    for side, mod, module, recs in (("jax", jconfig, jfit, jrecs),
                                    ("port", tconfig, tfit, trecs)):
        log = events[side] = []
        monkeypatch.setattr(module, "CheckpointManager", _recorder(log))
        if stop:
            monkeypatch.setattr(module, "make_train_step",
                                _stop_after_first_step(module.make_train_step))

        def eval_fn(state, epoch, log=log):
            log.append(("eval", epoch))
            return {"x": 1.0}

        cfg = _cfg(mod, checkpoint_dir=str(tmp_path / side), checkpoint_every_steps=every)
        kw = {} if side == "jax" else {"device": "cpu"}
        state = module.fit(cfg, recs, eval_fn=eval_fn, **kw)
        log.append(("step", int(state.step)))
    assert events["port"] == events["jax"]
    if stop:
        assert events["port"] == [("save", 1, -1), ("step", 1)]
    else:
        assert ("eval", 1) in events["port"] and ("save", 4, 1) in events["port"]


# --------------------------------------------------------------------------
# fit's checks
# --------------------------------------------------------------------------


def test_fit_checks_its_inputs(records, tmp_path):
    jrecs, trecs = records
    cfg = _cfg(tconfig)
    big = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=7))
    with pytest.raises(ValueError, match="batch_size"):
        tfit.fit(big, trecs, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue A item 7"):
        tfit.fit(dataclasses.replace(cfg, parallel=tconfig.ParallelConfig(data_parallel=2)),
                 trecs, device="cpu")
    # the device cache takes a pack, not streaming records (the JAX fit's ValueError)
    with pytest.raises(ValueError, match="needs a .fvtpack"):
        tfit.fit(dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, cache_on_device=True)),
                 trecs, device="cpu")
    with pytest.raises(NotImplementedError, match="item 7"):
        tfit.fit(cfg, trecs, mesh=object(), device="cpu")
    # pretrained variables: num_epochs=0 returns them untouched
    variables = _jax_init(_cfg(jconfig), seed=123)
    cfg0 = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, num_epochs=0))
    state = tfit.fit(cfg0, trecs, init_variables=variables, device="cpu")
    want = from_jax_variables(variables)
    assert all(torch.equal(v, want[k]) for k, v in state.model.state_dict().items())
    params_only = {"params": variables["params"]}
    state = tfit.fit(cfg0, trecs, init_variables=params_only, device="cpu")
    assert torch.equal(state.model.bn1.var, torch.ones(16))  # statistics kept
    with pytest.raises(ValueError, match="tree mismatch"):
        tfit.fit(cfg0, trecs, init_variables={"params": {"nope": variables["params"]},
                                              "batch_stats": {}}, device="cpu")
    wrong = jax.tree.map(lambda a: a, variables)
    wrong["params"]["fc"]["bias"] = np.zeros(4, np.float32)
    with pytest.raises(ValueError, match="shape mismatch at fc.bias"):
        tfit.fit(cfg0, trecs, init_variables=wrong, device="cpu")


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------


def _trained_state(clip=0.0, seed=0):
    cfg = _cfg(tconfig, clip_grad_norm=clip)
    state = create_train_state(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    batch = {"frames": rng.integers(0, 256, (3, 4, 48, 64, 3), dtype=np.uint8),
             "labels": np.arange(3, dtype=np.int32), "crop_tops": np.zeros(3, np.int32),
             "crop_lefts": np.zeros(3, np.int32), "flips": np.zeros(3, bool),
             "weights": np.ones(3, np.float32)}
    state, _ = make_train_step(state.model, cfg)(state, batch)
    return cfg, state


def test_checkpoint_round_trip_and_resave(tmp_path):
    cfg, state = _trained_state()
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.latest_step() is None and mgr.restore(state) == (None, None)
    mgr.save(state.step, state, {"epoch": 3})
    assert mgr.latest_step() == 1
    fresh = create_train_state(cfg, 2, device="cpu", generator=torch.Generator().manual_seed(9))
    restored, extra = mgr.restore(fresh)
    assert restored is fresh and extra == {"epoch": 3}
    _assert_bitwise(_host_state(fresh), _host_state(state))
    # a second save at the same step wins (the epoch-end save after a
    # mid-epoch save at that step)
    mgr.save(state.step, state, {"epoch": 4})
    assert mgr.restore(fresh)[1] == {"epoch": 4} and mgr.all_steps() == [1]
    mgr.wait()
    mgr.close()


def test_checkpoint_keeps_the_newest_three(tmp_path):
    _, state = _trained_state()
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    for step in (5, 1, 7, 3, 9):
        mgr.save(step, state, {"epoch": step})
    assert mgr.all_steps() == [5, 7, 9]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_5.pt", "step_7.pt", "step_9.pt"]
    assert mgr.restore(state, step=7)[1] == {"epoch": 7}


def test_restore_weights_needs_no_optimizer(tmp_path):
    _, state = _trained_state(clip=1.0)
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(state.step, state, {"epoch": 1})
    weights, step = mgr.restore_weights()
    assert step == state.step == 1
    model = zoo.get_model("tiny3d", num_classes=3, device="cpu", dtype=torch.float32)
    model.load_state_dict(weights)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in weights.items())
    assert tckpt.NullCheckpointManager().restore_weights() == (None, None)


def test_weights_export_and_interrupted_saves(tmp_path, monkeypatch):
    _, state = _trained_state()
    path = str(tmp_path / "weights.pt")
    tckpt.export_weights(path, state.model.state_dict())
    loaded = tckpt.load_weights(path)
    assert all(torch.equal(v, state.model.state_dict()[k]) for k, v in loaded.items())
    mgr = tckpt.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(1, state, {"epoch": 0})

    def broken_save(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError, match="disk full"):
        mgr.save(2, state, {"epoch": 1})
    with pytest.raises(OSError, match="disk full"):
        tckpt.export_weights(path, state.model.state_dict())
    monkeypatch.undo()
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["step_1.pt"]
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "weights.pt"]
    assert mgr.restore(state)[1] == {"epoch": 0}
    assert tckpt.load_weights(path).keys() == loaded.keys()


# --------------------------------------------------------------------------
# the CLI and tag(checkpoint=...)
# --------------------------------------------------------------------------


def test_cli_train_on_a_pack_then_tag_from_its_export(tmp_path):
    items = [(f"v{i}.mp4", i % 3, (), synthetic.make_frames(i % 3, 12, 40, 56, seed=i))
             for i in range(6)]
    train, val = str(tmp_path / "train.fvtpack"), str(tmp_path / "val.fvtpack")
    tpacked.write_pack_from_arrays(items, train, (40, 56))
    tpacked.write_pack_from_arrays(items[:2], val, (40, 56))
    ck, metrics = str(tmp_path / "ckpt"), str(tmp_path / "m.jsonl")
    argv = ["--model", "tiny3d", "--num-classes", "3", "--train-list", train,
            "--val-list", val, "--resize", "40", "56", "--crop", "32", "32",
            "--clip-len", "4", "--batch-size", "3", "--epochs", "2", "--log-every", "1",
            "--num-workers", "2", "--checkpoint-dir", ck, "--metrics-jsonl", metrics,
            "--compute-dtype", "float32"]
    state = cli_train.main(argv + ["--device", "cpu"])
    assert state.step == 4
    with open(metrics) as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if "loss" in r] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and 0 <= r["data_wait_frac"] <= 1
               for r in lines if "loss" in r)
    assert [r["step"] for r in lines if "eval_top1" in r] == [2, 4]
    weights, step = tckpt.CheckpointManager(ck).restore_weights()
    assert step == 4
    export = str(tmp_path / "export.pt")
    tckpt.export_weights(export, weights)
    video = str(tmp_path / "clip.mp4")
    synthetic.write_video(video, synthetic.make_frames(1, 20, 40, 56, seed=7))
    cfg = _cfg(tconfig)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, source_hw=None),
                              model=dataclasses.replace(cfg.model, multilabel=True))
    a = tag(video, export, cfg=cfg, threshold=0.0, device="cpu")
    b = tag(video, state_dict=state.model.state_dict(), cfg=cfg, threshold=0.0, device="cpu")
    assert len(a) == 3 and [(r.index, r.score) for r in a] == [(r.index, r.score) for r in b]
    with pytest.raises(ValueError, match="exactly one"):
        tag(video, export, state_dict=weights, device="cpu")
    # the train step's knobs, ported: the device cache and gradient accumulation
    knobs = cli_train.main(argv + ["--device", "cpu", "--cache-on-device", "--grad-accum", "2",
                                   "--epochs", "1", "--checkpoint-dir", "",
                                   "--metrics-jsonl", str(tmp_path / "knobs.jsonl")])
    assert knobs.step == 2 and knobs.acc_grads is None
    for extra, item in ((["--coordinator", "h:1"], "item 7"),):
        with pytest.raises(NotImplementedError, match=item):
            cli_train.main(argv + ["--device", "cpu"] + extra)
    # --pretrained is ported (tests/test_torch_port_pretrained.py): a missing file raises
    with pytest.raises(FileNotFoundError):
        cli_train.main(argv + ["--device", "cpu", "--pretrained", str(tmp_path / "w.pt")])
    with pytest.raises(NotImplementedError, match="item 7"):
        cli_train.main(argv + ["--device", "cpu", "--data-parallel", "2"])


# --------------------------------------------------------------------------
# debug, stopper, tiny3d
# --------------------------------------------------------------------------


def test_nonfinite_report_and_guard_match_jax():
    tree = {"b": {"k": np.array([1.0, np.nan, np.inf], np.float32)},
            "a": [np.zeros(2, np.float32), np.array([np.nan], np.float64)],
            "i": np.arange(3)}
    assert tdebug.nonfinite_report(tree) == jdebug.nonfinite_report(tree) == [
        "['a'][1]: 1 non-finite", "['b']['k']: 2 non-finite"]
    as_torch = {"b": {"k": torch.from_numpy(tree["b"]["k"])},
                "a": [torch.from_numpy(x) for x in tree["a"]], "i": torch.arange(3)}
    assert tdebug.nonfinite_report(as_torch) == jdebug.nonfinite_report(tree)
    assert tdebug.nonfinite_report(as_torch, max_entries=1) == \
        jdebug.nonfinite_report(tree, max_entries=1)
    with pytest.raises(FloatingPointError, match="params"):
        tdebug.assert_all_finite(as_torch, "params")
    tdebug.assert_all_finite({"x": torch.ones(2)})
    for t in ({"a": np.ones(3)}, {"a": np.array([np.nan])}, {"a": np.arange(3)}, {}):
        got = tdebug.finite_guard({k: torch.from_numpy(v) for k, v in t.items()})
        assert got.ndim == 0 and bool(got) == bool(jdebug.finite_guard(t))


def test_debug_train_step_matches_jax():
    """The 'finite' metric on the same tiny3d weights and batch: True, then
    False once a parameter is NaN, on both sides."""
    jcfg, tcfg = _cfg(jconfig), _cfg(tconfig)
    variables = _jax_init(jcfg)
    rng = np.random.default_rng(4)
    batch = {"frames": rng.integers(0, 256, (3, 4, 48, 64, 3), dtype=np.uint8),
             "labels": np.arange(3, dtype=np.int32), "crop_tops": np.zeros(3, np.int32),
             "crop_lefts": np.zeros(3, np.int32), "flips": np.zeros(3, bool),
             "weights": np.ones(3, np.float32)}
    jm = jmodel_from_config(jcfg.model)
    jstep = jdebug.debug_train_step(jloop.make_train_step(jm, jcfg, donate=False))
    for poison in (False, True):
        params = jax.tree.map(np.array, variables["params"])
        if poison:
            params["conv1"]["kernel"][0, 0, 0, 0, 0] = np.nan
        jstate = JTrainState.create(apply_fn=jm.apply, params=params,
                                    batch_stats=variables["batch_stats"],
                                    tx=jlr.make_optimizer(jcfg.train, 2))
        _, jmet = jstep(jstate, batch, jax.random.PRNGKey(0))
        tstate = create_train_state(tcfg, 2, device="cpu")
        tstate.model.load_state_dict(from_jax_variables({"params": params,
                                                         "batch_stats": variables["batch_stats"]}))
        _, tmet = tdebug.debug_train_step(make_train_step(tstate.model, tcfg))(tstate, batch)
        assert tmet["finite"].ndim == 0
        assert bool(tmet["finite"]) == bool(jmet["finite"]) == (not poison)


def test_graceful_stopper_matches_jax():
    """Each stopper alone: the first SIGTERM sets the flag, the handler is
    restored on exit. Nested (port inside JAX): the first signal reaches
    the port's stopper only; the second falls through to the JAX one."""
    for stopper_cls in (TStopper, JStopper):
        before = signal.getsignal(signal.SIGTERM)
        with stopper_cls() as stopper:
            assert not stopper.stop_requested
            os.kill(os.getpid(), signal.SIGTERM)
            assert stopper.stop_requested
        assert signal.getsignal(signal.SIGTERM) == before
    with JStopper() as outer, TStopper() as inner:
        os.kill(os.getpid(), signal.SIGTERM)
        assert inner.stop_requested and not outer.stop_requested
        os.kill(os.getpid(), signal.SIGTERM)
        assert outer.stop_requested
    with TStopper() as alone:
        os.kill(os.getpid(), signal.SIGINT)
        assert alone.stop_requested
        with pytest.raises(KeyboardInterrupt):
            os.kill(os.getpid(), signal.SIGINT)


def test_tiny3d_forward_matches_jax():
    jcfg = _cfg(jconfig)
    variables = _jax_init(jcfg, seed=5)
    x = np.random.default_rng(2).normal(size=(2, 4, 32, 32, 3)).astype(np.float32)
    ref = np.asarray(jmodel_from_config(jcfg.model).apply(variables, jnp.asarray(x),
                                                          train=False))
    model = zoo.model_from_config(_cfg(tconfig).model, device="cpu")
    model.load_state_dict(from_jax_variables(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert "tiny3d" in zoo.list_models()
