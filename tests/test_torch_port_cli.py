"""The port's entry points against the JAX package's: ``cli.prepare``,
``cli.evaluate``, ``cli.tag``, ``cli.bench_loader`` and the hard accuracy
benchmark's module.

- prepare: on the same tree, the split files byte for byte the JAX CLI's,
  and the packs byte for byte (frames resized by the numpy spec, which the
  JAX side takes with its native resize switched off).
- evaluate and tag: tiny3d, multi-label, the same weights (JAX variables
  converted), a pack read by both CLIs: metrics within 1e-4, and per video
  the same tags with scores within 1e-4 of the largest score.
- bench_loader returns its scalars at a tiny size on the CPU.
- accuracy_hard: its configs equal the JAX file's field for field (but
  ``kernels``, the port's default); a tiny run on the CPU (tiny3d, 2
  classes, 5 epochs of one step: the recipe's 2 warmup epochs must end
  before its first decay at 0.6 of them) returns the JAX file's result
  keys and the port's three more.
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.cli import evaluate as jcli_evaluate
from fastvideotagging_tpu.cli import prepare as jcli_prepare
from fastvideotagging_tpu.cli import tag as jcli_tag
from fastvideotagging_tpu.config import TrainConfig as JTrainConfig
from fastvideotagging_tpu.models import get_model as jget_model
from fastvideotagging_tpu.train import checkpoint as jckpt
from fastvideotagging_tpu.train import lr as jlr
from fastvideotagging_tpu.train.state import create_train_state as jcreate_train_state
from fastvideotagging_tpu_torch import config as tconfig
from fastvideotagging_tpu_torch.benchmarks import accuracy_hard
from fastvideotagging_tpu_torch.cli import bench_loader
from fastvideotagging_tpu_torch.cli import evaluate as cli_evaluate
from fastvideotagging_tpu_torch.cli import prepare as cli_prepare
from fastvideotagging_tpu_torch.cli import tag as cli_tag
from fastvideotagging_tpu_torch.data import packed as tpacked
from fastvideotagging_tpu_torch.data.synthetic import make_frames
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.train import checkpoint as tckpt
from fastvideotagging_tpu_torch.train.state import create_train_state

TOL = 1e-4
COMMON = ["--model", "tiny3d", "--num-classes", "3", "--multilabel", "--resize", "40", "56",
          "--crop", "32", "32", "--clip-len", "4", "--stride", "2", "--eval-mode", "dense",
          "--compute-dtype", "float32", "--clip-batch", "2"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small models: one thread each, since with several test workers on the
    machine more threads only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["tree", "lists"])
def test_prepare_matches_the_jax_cli(synthetic_dataset, tmp_path, mode):
    root, _ = synthetic_dataset
    # both sides resize with their C tier (the JAX package's default)
    outs = {side: str(tmp_path / side) for side in ("jax", "port")}
    for side, main in (("jax", jcli_prepare.main), ("port", cli_prepare.main)):
        if mode == "tree":
            main([root, "--out", outs[side], "--val-fraction", "0.5", "--seed", "3",
                  "--pack", "--pack-resize", "40", "56"])
        else:  # the lists the tree mode writes, packed again
            jcli_prepare.write_splits(jcli_prepare.scan_tree(root), outs[side], 0.5, 3)
            main([root, "--pack-lists", os.path.join(outs[side], "testlist01.txt"),
                  "--class-index", os.path.join(outs[side], "classInd.txt"),
                  "--pack-resize", "40", "56"])
    names = sorted(os.listdir(outs["jax"]))
    assert names == sorted(os.listdir(outs["port"]))
    assert "testlist01.fvtpack" in names and "classInd.txt" in names
    for name in names:
        with open(os.path.join(outs["jax"], name), "rb") as a, \
                open(os.path.join(outs["port"], name), "rb") as b:
            assert a.read() == b.read(), name
    assert cli_prepare.scan_tree(root) == jcli_prepare.scan_tree(root)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A multi-label pack of 3 videos at 40x56 (3 tags) and tiny3d's JAX
    variables: a JAX checkpoint directory and weights export, and the port's
    from the converted variables."""
    tmp = tmp_path_factory.mktemp("served")
    pack = str(tmp / "val.fvtpack")
    items = [(f"v{i}.mp4", None, (i % 3, (i + 1) % 3), make_frames(i, 14, 40, 56, seed=i))
             for i in range(3)]
    tpacked.write_pack_from_arrays(items, pack, (40, 56), num_tags=3)
    model = jget_model("tiny3d", num_classes=3)
    jstate = jcreate_train_state(model, jlr.make_optimizer(JTrainConfig(), 1),
                                 jax.random.PRNGKey(4), jnp.zeros((1, 4, 32, 32, 3)))
    variables = jax.device_get({"params": jstate.params, "batch_stats": jstate.batch_stats})
    mgr = jckpt.CheckpointManager(str(tmp / "jax_ckpt"))
    mgr.save(2, jstate, {"epoch": 0})
    mgr.close()
    jckpt.export_weights(str(tmp / "jax_weights"), variables["params"],
                         variables["batch_stats"])
    tcfg = tconfig.ExperimentConfig(model=tconfig.ModelConfig(
        name="tiny3d", num_classes=3, multilabel=True, compute_dtype="float32"))
    tstate = create_train_state(tcfg, 1, device="cpu")
    tstate.model.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)))
    tstate.step = 2
    tckpt.CheckpointManager(str(tmp / "port_ckpt")).save(2, tstate, {"epoch": 0})
    tckpt.export_weights(str(tmp / "port_weights.pt"), tstate.model.state_dict())
    return tmp, pack


def _out_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]


def test_evaluate_cli_matches_the_jax_cli(served, capsys):
    tmp, pack = served
    capsys.readouterr()
    jcli_evaluate.main(COMMON + ["--val-list", pack, "--checkpoint-dir", str(tmp / "jax_ckpt")])
    want = _out_lines(capsys)[-1]
    got = cli_evaluate.main(COMMON + ["--val-list", pack, "--device", "cpu",
                                      "--checkpoint-dir", str(tmp / "port_ckpt")])
    assert _out_lines(capsys)[-1] == got
    assert set(got) == set(want) == {"num_videos", "mAP", "macro_f1"}
    assert got["num_videos"] == want["num_videos"] == 3
    for k in ("mAP", "macro_f1"):
        assert got[k] == pytest.approx(want[k], abs=TOL), k
    with pytest.raises(SystemExit, match="no checkpoint"):
        cli_evaluate.main(COMMON + ["--val-list", pack, "--device", "cpu",
                                    "--checkpoint-dir", str(tmp / "empty")])


def test_tag_cli_matches_the_jax_cli(served, capsys):
    tmp, pack = served
    flags = ["--threshold", "0.0"]
    capsys.readouterr()
    jcli_tag.main(COMMON + [pack, "--weights", str(tmp / "jax_weights")] + flags)
    want = _out_lines(capsys)
    cli_tag.main(COMMON + [pack, "--weights", str(tmp / "port_weights.pt"), "--device", "cpu"]
                 + flags)
    got = _out_lines(capsys)
    assert [r["video"] for r in got] == [r["video"] for r in want] == ["v0.mp4", "v1.mp4",
                                                                         "v2.mp4"]
    for g, w in zip(got, want):
        gs, ws = ({t["tag"]: t["score"] for t in r["tags"]} for r in (g, w))
        assert set(gs) == set(ws) == {"tag_0", "tag_1", "tag_2"}
        top = max(ws.values())
        for tag, score in ws.items():
            assert abs(gs[tag] - score) <= TOL * top, (g["video"], tag)
    cli_tag.main(COMMON + [pack, "--weights", str(tmp / "port_weights.pt"), "--device", "cpu",
                           "--top-k", "1", "--threshold", "0.5"])
    assert all(len(r["tags"]) <= 1 for r in _out_lines(capsys))


def test_cli_flags_not_ported_raise(served):
    tmp, pack = served
    ev = COMMON + ["--val-list", pack, "--checkpoint-dir", str(tmp / "port_ckpt"),
                   "--device", "cpu"]
    tg = COMMON + [pack, "--weights", str(tmp / "port_weights.pt"), "--device", "cpu"]
    # the multi-process flags and channel sharding are ported
    # (tests/test_torch_port_multiproc.py, tests/test_torch_port_channel.py): a
    # preset's model_parallel = 2 in one process evaluates unsharded with a
    # warning, as the JAX CLI does, and a coordinator needs the job's size and rank
    warnings = []
    handler = logging.Handler()
    handler.emit = lambda record: warnings.append(record.getMessage())
    logging.getLogger("fvt.eval").addHandler(handler)
    try:
        sharded = cli_evaluate.main(ev + ["--preset", "slowfast_stretch"])
    finally:
        logging.getLogger("fvt.eval").removeHandler(handler)
    assert sharded == cli_evaluate.main(ev)
    assert any("evaluating unsharded" in w and "model_parallel=2" in w for w in warnings)
    with pytest.raises(SystemExit, match="needs --num-processes"):
        cli_evaluate.main(ev + ["--coordinator", "h:1", "--process-id", "0"])
    # --engine native is ported (tests/test_torch_port_native.py): the JAX
    # CLI's checks, before any daemon starts
    native = [(tg + ["--engine", "native"], "needs --artifacts"),
              (COMMON + [pack, "--device", "cpu", "--engine", "native", "--artifacts", "art",
                         "--int8"], "baked at export time"),
              (tg + ["--engine", "native", "--artifacts", "art", "--pipeline", "2"],
               "--weights: fixed at export time")]
    for argv, msg in native:
        with pytest.raises(SystemExit, match=msg):
            cli_tag.main(argv)
    # --int8 is ported (tests/test_torch_port_serve.py); tiny3d is outside
    # the int8 engine's coverage
    with pytest.raises(KeyError, match="covers"):
        cli_evaluate.main(ev + ["--int8"])
    with pytest.raises(ValueError, match="int8 tagging covers"):
        cli_tag.main(tg + ["--int8"])
    with pytest.raises(SystemExit, match="needs --weights"):
        cli_tag.main(COMMON + [pack, "--device", "cpu"])
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_tag.main(COMMON + [pack, "--weights", str(tmp / "port_weights.pt")])


def test_bench_loader_returns_its_scalars():
    out = bench_loader.main(["--videos", "2", "--frames", "12", "--size", "48", "64",
                             "--clip-len", "4", "--batch", "2", "--workers", "2",
                             "--epochs", "1", "--device", "cpu"])
    for k in ("decode_clips_per_sec", "packed_clips_per_sec", "with_device_put_clips_per_sec",
              "decode_frames_per_sec", "packed_frames_per_sec"):
        assert np.isfinite(out[k]) and out[k] > 0, k
    assert out["device"] == "cpu" and out["source"] == "48x64 mp4"


def _jax_configs(monkeypatch, tmp_path, **kw):
    """The ExperimentConfigs the JAX file's run / run_multilabel build,
    caught at its fit (data generation and training stubbed out)."""
    import sys

    from fastvideotagging_tpu.data import synthetic_motion as jmotion
    from fastvideotagging_tpu.train import fit as jfit

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from benchmarks import accuracy_hard as jacc

    caught = []

    class Caught(Exception):
        pass

    def fake_fit(cfg, *a, **k):
        caught.append(cfg)
        raise Caught

    def lists(root, **k):
        paths = [str(tmp_path / n) for n in ("train.txt", "eval.txt")]
        for p in paths:
            with open(p, "w") as f:
                f.write("a/v.mp4 0\n")
        return paths

    def tag_lists(root, **k):
        paths = [str(tmp_path / n) for n in ("ttrain.txt", "teval.txt")]
        for p in paths:
            with open(p, "w") as f:
                f.write("a/v.mp4 motion_00,motion_01\n")
        return paths

    monkeypatch.setattr(jfit, "fit", fake_fit)
    monkeypatch.setattr(jmotion, "make_motion_dataset", lists)
    monkeypatch.setattr(jmotion, "make_tagging_dataset", tag_lists)
    for fn, args in ((jacc.run, kw), (jacc.run_multilabel, {})):
        with pytest.raises(Caught):
            fn(root=str(tmp_path), **args)
    return caught


def test_accuracy_configs_equal_the_jax_files(monkeypatch, tmp_path):
    kw = dict(num_classes=7, epochs=11, batch_size=5, base_lr=0.3, seed=2,
              model_name="r2plus1d_18_tpu", clip_grad_norm=1.5, norm="frozen",
              clip_len=16, stride=1, dropout=0.25)
    jrun, jml = _jax_configs(monkeypatch, tmp_path, **kw)
    for want, got in ((jrun, accuracy_hard.hard_config(**kw)),
                      (jml, accuracy_hard.tagging_config())):
        want, got = dataclasses.asdict(want), dataclasses.asdict(got)
        assert want["model"].pop("kernels") == "xla" and got["model"].pop("kernels") == "cuda"
        assert got == want
    assert accuracy_hard.hard_config() == accuracy_hard.hard_config(
        50, 40, 64, 0.05, 0, "r2plus1d_18", 0.0, "batch", 8, 2, 0.0)


JAX_KEYS = {"benchmark", "model", "num_classes", "train_videos", "eval_videos",
            "clip_geometry", "epochs", "steps", "seed", "top1", "top5", "mAP",
            "chance_top1", "clip_grad_norm", "norm", "gen_seconds", "train_seconds",
            "eval_seconds"}


def test_accuracy_run_on_the_cpu(tmp_path):
    out = str(tmp_path / "acc.json")
    r = accuracy_hard.main(["--classes", "2", "--epochs", "5", "--batch", "32", "--model",
                            "tiny3d", "--source", "pack", "--device", "cpu", "--out", out])
    assert set(r) == JAX_KEYS | {"source", "device", "card", "batch_size", "base_lr",
                                 "dropout", "launches", "launches_note"}
    assert (r["source"], r["device"], r["card"]) == ("pack", "cpu", None)
    assert (r["batch_size"], r["base_lr"], r["dropout"]) == (32, 0.05, 0.0)
    assert r["launches"] == {phase: dict.fromkeys(accuracy_hard.TRAIN_KERNELS, 0)
                             for phase in ("fit", "eval")}
    assert r["steps"] == 5 and r["train_videos"] == 32 and r["eval_videos"] == 8
    assert 0 <= r["top1"] <= 1 and np.isfinite(r["mAP"])
    with open(out) as f:
        assert json.load(f) == r
    with pytest.raises(ValueError, match="source"):
        accuracy_hard.run(source="avi", device="cpu")
