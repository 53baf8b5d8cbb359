"""The port's trained-accuracy records of every model family, and the
accuracy scripts that write them, against the JAX package.

- The records (``fastvideotagging_tpu_torch/benchmarks/*.json``, each from a
  run on the card): one case per record, held to the JAX package's
  thresholds (tests/test_synthetic_motion.py, tests/test_norm_variants.py)
  unchanged, its recipe equal to the JAX record's, the card named with its
  power limit, and the K1-K3 launches of its training: above 0 for the
  families built on SpatialConv / TemporalConv, 0 for the others.
- The int8 spec defaults (s3d static at site margins, i3d dynamic,
  r2plus1d_18 static) equal the JAX package's, beside the card's
  INT8_INCEPTION.json.
- Each new script's config, caught at its ``fit``, equals the JAX script's
  field for field (but ``kernels``, the port's own; C3D in int8_family takes
  its record's clip, as FAMILY_RECIPES says).
- The motion sources at the Kinetics geometry are bitwise the JAX package's.
- Each script's entry point on the CPU at a tiny size: finite scores and
  the JAX file's result keys.
"""

import dataclasses
import functools
import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import pytest
import torch

from fastvideotagging_tpu.data import synthetic_motion as jmotion
from fastvideotagging_tpu.ops.arch_spec import spec_for as jspec_for
from fastvideotagging_tpu.train import fit as jfit
from fastvideotagging_tpu_torch.benchmarks import (
    accuracy_hard,
    accuracy_kinetics_geom,
    int8_family,
    int8_inception,
    int8_s3d,
    int8_serving,
)
from fastvideotagging_tpu_torch.data import synthetic_motion
from fastvideotagging_tpu_torch.examples import train_synthetic
from fastvideotagging_tpu_torch.ops.arch_spec import spec_for

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BENCH = os.path.join(REPO, "fastvideotagging_tpu_torch", "benchmarks")
JAX_BENCH = os.path.join(REPO, "benchmarks")
_MKDTEMP = tempfile.mkdtemp

# ACCURACY_HARD_<suffix>.json: (model, top-1 floor, mAP floor or None, the
# recipe's lr and dropout); floors of the JAX package's tests, the family
# default (0.85 / 0.9) for TPU_VARIANT, which no JAX test reads
HARD = {
    "C3D": ("c3d", 0.85, 0.9, 0.03),
    "I3D": ("i3d", 0.85, 0.9, 0.05),
    "MC3": ("mc3_18", 0.85, 0.9, 0.05),
    "P3D": ("p3d_63", 0.85, 0.9, 0.05),
    "R3D": ("r3d_18", 0.85, 0.9, 0.05),
    "S3D": ("s3d", 0.85, 0.9, 0.05),
    "SCALEONLY": ("r2plus1d_18_tpu", 0.9, 0.9, 0.05),
    "SLOWFAST": ("slowfast_r2plus1d", 0.9, None, 0.05),
    "SLOWFAST_TPU": ("slowfast_r2plus1d_tpu", 0.9, None, 0.05),
    "TPU_VARIANT": ("r2plus1d_18_tpu", 0.85, 0.9, 0.05),
}
# the families whose convs are SpatialConv / TemporalConv (K1-K3 sites);
# SlowFast's (2+1)D blocks are layers.Conv3D in both packages
FACTORIZED = {"r2plus1d_18_tpu", "p3d_63", "s3d"}
RECIPE_KEYS = ("model", "num_classes", "train_videos", "eval_videos", "clip_geometry",
               "epochs", "steps", "seed", "chance_top1")


def _load(root, name):
    path = os.path.join(root, name)
    assert os.path.exists(path), f"{path} missing"
    with open(path) as f:
        return json.load(f)


def _on_the_card(r):
    assert r["device"].startswith("cuda"), r["device"]
    name, limit = (p.strip() for p in r["card"].split(","))
    assert name and limit.endswith("W"), r["card"]


def _check_hard(suffix):
    name = f"ACCURACY_HARD_{suffix}.json"
    r, ref = _load(PORT_BENCH, name), _load(JAX_BENCH, name)
    model, top1, m_ap, lr = HARD[suffix]
    assert r["model"] == model
    for k in RECIPE_KEYS:
        assert r[k] == ref[k], (k, r[k], ref[k])
    assert r["clip_grad_norm"] == ref.get("clip_grad_norm", 0.0)
    assert r["norm"] == ref.get("norm", "batch")
    assert (r["batch_size"], r["base_lr"], r["dropout"]) == (64, lr, 0.0)
    assert r["source"] in ("mp4", "pack", "mp4pack")
    assert r["top1"] >= top1, r
    if m_ap is not None:
        assert r["mAP"] >= m_ap, r
    fit_launches = r["launches"]["fit"]
    if model in FACTORIZED:
        assert all(fit_launches[k] > 0 for k in accuracy_hard.TRAIN_KERNELS), fit_launches
    else:
        assert not any(fit_launches.values()) and not any(r["launches"]["eval"].values())
        assert r["launches_note"] == accuracy_hard.NO_KERNEL_SITES
    return r


def _walk_agrees(by_mode):
    for mode, f in by_mode.items():
        assert f["launches"] == f["walk"], (mode, f)
        assert f["launches"]["conv3d_s8"] == f["int8_convs"] > 0, (mode, f)


def _check_int8_s3d():
    r, ref = _load(PORT_BENCH, "INT8_S3D.json"), _load(JAX_BENCH, "INT8_S3D.json")
    for k in ("model", "num_classes", "epochs", "seed", "clip_grad_norm"):
        assert r[k] == ref[k], k
    assert r["bf16_top1"] >= 0.85, r
    assert r["int8_dynamic_top1"] >= r["bf16_top1"] - 0.02, r
    assert r["int8_top1"] >= 0.80, r
    _walk_agrees(r["int8_launches"])
    return r


def _check_int8_family():
    r = _load(PORT_BENCH, "INT8_FAMILY.json")
    rows = {row["model"]: row for row in r["results"]}
    assert set(rows) == {"p3d_63", "c3d"}
    for model, row in rows.items():
        assert row["epochs"] == 40 and row["steps"] == 480
        assert row["int8_top1"] >= row["bf16_top1"] - 0.02, row
        assert row["default_float_blocks"] == list(spec_for(model).default_float_blocks)
        _walk_agrees(row["int8_launches"])
    assert rows["p3d_63"]["clip_geometry"] == "8x32x32 (stride 2)"
    assert rows["c3d"]["clip_geometry"] == "16x32x32 (stride 1)"
    return r


def _check_int8_inception():
    r = _load(PORT_BENCH, "INT8_INCEPTION.json")
    ref = {row["model"]: row for row in _load(JAX_BENCH, "INT8_INCEPTION.json")["results"]}
    rows = {row["model"]: row for row in r["results"]}
    assert set(rows) == set(ref)
    for model, row in rows.items():
        for k in ("num_classes", "epochs", "seed", "clip_grad_norm"):
            assert row[k] == ref[model][k], (model, k)
        assert set(ref[model]) <= set(row), set(ref[model]) - set(row)
        assert row["throughput"]["geometry"] == ref[model]["throughput"]["geometry"]
        _walk_agrees(row["int8_launches"])
    # the JAX test's asserts (tests/test_synthetic_motion.py:193-221), every
    # miss named at once
    s3d, i3d = rows["s3d"], rows["i3d"]
    s3d_rate, i3d_rate = s3d["throughput"], i3d["throughput"]
    sw = i3d["margin_sweep"]
    checks = {
        "s3d site-static top-1 within 0.02 of bf16": (
            s3d["int8_static_site_top1"] >= s3d["bf16_top1"] - 0.02,
            (s3d["int8_static_site_top1"], s3d["bf16_top1"])),
        "s3d static clips/s above dynamic": (
            s3d_rate["int8_static_clips_per_sec"] > s3d_rate["int8_dynamic_clips_per_sec"],
            (s3d_rate["int8_static_clips_per_sec"], s3d_rate["int8_dynamic_clips_per_sec"])),
        "i3d dynamic top-1 within 0.02 of bf16": (
            i3d["int8_dynamic_top1"] >= i3d["bf16_top1"] - 0.02,
            (i3d["int8_dynamic_top1"], i3d["bf16_top1"])),
        "i3d dynamic clips/s above 0.9x static": (
            i3d_rate["int8_dynamic_clips_per_sec"] > 0.9 * i3d_rate["int8_static_clips_per_sec"],
            (i3d_rate["int8_dynamic_clips_per_sec"], i3d_rate["int8_static_clips_per_sec"])),
        "i3d sweep rises with the margin": (
            sw["global_1.0"] < sw["global_1.5"] < sw["global_2.5"], sw),
        "i3d sweep below dynamic": (sw["global_2.5"] < i3d["int8_dynamic_top1"],
                                    (sw["global_2.5"], i3d["int8_dynamic_top1"])),
    }
    misses = {name: got for name, (ok, got) in checks.items() if not ok}
    assert not misses, misses
    return r


def _check_kinetics():
    name = "ACCURACY_KINETICS_GEOM.json"
    r, ref = _load(PORT_BENCH, name), _load(JAX_BENCH, name)
    for k in ("model", "geometry", "num_classes", "train_videos", "eval_videos", "epochs",
              "seed", "clip_grad_norm", "chance_top1"):
        assert r[k] == ref[k], k
    assert (r["batch_size"], r["base_lr"], r["steps"]) == (8, 0.02, 720)
    assert r["geometry"].startswith("32x224x224")
    assert r["top1_single_clip"] >= 4 * r["chance_top1"], r
    assert r["top1_multi_clip_4"] >= 4 * r["chance_top1"], r
    assert all(r["launches"]["fit"][k] > 0 for k in accuracy_hard.TRAIN_KERNELS)
    return r


RECORDS = {**{f"ACCURACY_HARD_{s}": functools.partial(_check_hard, s) for s in HARD},
           "INT8_S3D": _check_int8_s3d, "INT8_FAMILY": _check_int8_family,
           "INT8_INCEPTION": _check_int8_inception, "ACCURACY_KINETICS_GEOM": _check_kinetics}


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_recorded_run_meets_the_reference_threshold(name):
    _on_the_card(RECORDS[name]())


def test_int8_spec_defaults_are_the_jax_packages():
    """tests/test_synthetic_motion.py:207-221's pins on the port's specs,
    which stay the JAX package's (s3d static at site margins, i3d dynamic,
    r2plus1d_18 static), beside the card's INT8_INCEPTION.json: it holds the
    measurement of each, and its records case holds it to the JAX test's
    invariants."""
    for model in ("s3d", "s3d_g", "i3d", "r2plus1d_18"):
        got, want = spec_for(model), jspec_for(model)
        assert (got.default_dynamic, got.default_site_margins, tuple(got.default_float_blocks)) \
            == (want.default_dynamic, want.default_site_margins,
                tuple(want.default_float_blocks)), model
    assert spec_for("s3d").default_site_margins and not spec_for("s3d").default_dynamic
    assert spec_for("s3d_g").default_site_margins
    assert spec_for("i3d").default_dynamic and not spec_for("i3d").default_site_margins
    assert not spec_for("r2plus1d_18").default_dynamic
    r = _load(PORT_BENCH, "INT8_INCEPTION.json")
    _on_the_card(r)
    rows = {row["model"]: row for row in r["results"]}
    for model in ("s3d", "i3d"):  # the scheme each default takes, measured
        row = rows[model]
        assert {"bf16_top1", "int8_static_site_top1", "int8_dynamic_top1"} <= set(row)
        assert {"int8_static_clips_per_sec", "int8_dynamic_clips_per_sec"} <= set(
            row["throughput"])


# --- configs against the JAX scripts ---------------------------------------


class Caught(Exception):
    pass


def _catching(store):
    def fake_fit(cfg, *a, **k):
        store.append(cfg)
        raise Caught
    return fake_fit


def _jax_script(name, monkeypatch, tmp_path):
    """The JAX package's benchmarks/<name>.py with fit and the dataset writer
    stubbed: -> (module, the configs fit was called with)."""
    caught = []

    def lists(root, **k):
        paths = [str(tmp_path / n) for n in ("train.txt", "eval.txt")]
        for p in paths:
            with open(p, "w") as f:
                f.write("a/v.mp4 0\n")
        return paths

    monkeypatch.setattr(jfit, "fit", _catching(caught))
    monkeypatch.setattr(jmotion, "make_motion_dataset", lists)
    # each script's root a fresh directory under tmp_path
    monkeypatch.setattr("tempfile.mkdtemp", lambda *a, **k: _MKDTEMP(dir=str(tmp_path)))
    monkeypatch.syspath_prepend(REPO)
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  os.path.join(JAX_BENCH, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod, caught


def _port_configs(monkeypatch, module, calls):
    """The configs the port's ``calls`` pass to fit (data stubbed)."""
    caught = []
    monkeypatch.setattr(module, "fit", _catching(caught))
    monkeypatch.setattr(module, "motion_sources", lambda *a, **k: ([], []))
    for call in calls:
        with pytest.raises(Caught):
            call()
    return caught


def _same(want, got):
    want, got = dataclasses.asdict(want), dataclasses.asdict(got)
    assert want["model"].pop("kernels") == "xla" and got["model"].pop("kernels") == "cuda"
    assert got == want


def test_int8_script_configs_equal_the_jax_files(monkeypatch, tmp_path):
    """int8_s3d's, int8_family's (p3d_63 as is; c3d with FAMILY_RECIPES'
    clip, clip and lr: the JAX file's 8 frames leave C3D's pool5 empty) and
    int8_inception's configs, caught at fit."""
    kw = dict(num_classes=7, epochs=11, batch_size=5, base_lr=0.3, seed=2)
    jaxs = []
    for name, call in (("int8_s3d", lambda m: m.run(**kw)),
                       ("int8_family", lambda m: m.run_model("p3d_63", **kw)),
                       ("int8_family", lambda m: m.run_model("c3d", **kw)),
                       ("int8_inception", lambda m: m.accuracy("i3d", **kw))):
        mod, caught = _jax_script(name, monkeypatch, tmp_path)
        with pytest.raises(Caught):
            call(mod)
        jaxs += caught
    ports = _port_configs(monkeypatch, int8_serving, [
        lambda: int8_s3d.run(**kw, device="cpu"),
        lambda: int8_family.run_model("p3d_63", **kw, device="cpu"),
        lambda: int8_family.run_model("c3d", **kw, device="cpu"),
        lambda: int8_inception.accuracy("i3d", **kw, device="cpu")])
    want_c3d = jaxs[2]
    rec = int8_family.FAMILY_RECIPES["c3d"]
    jaxs[2] = dataclasses.replace(
        want_c3d, data=dataclasses.replace(want_c3d.data, sampler=dataclasses.replace(
            want_c3d.data.sampler, clip_len=rec["clip_len"], stride=rec["stride"])),
        train=dataclasses.replace(want_c3d.train, clip_grad_norm=rec["clip_grad_norm"],
                                  base_lr=rec["base_lr"]))
    # FAMILY_RECIPES' C3D is the JAX C3D record's recipe (its test's command)
    c3d_ref = _load(JAX_BENCH, "ACCURACY_HARD_C3D.json")
    assert c3d_ref["clip_geometry"].startswith(f"{rec['clip_len']}x32x32 (stride {rec['stride']})")
    assert c3d_ref["clip_grad_norm"] == rec["clip_grad_norm"] and rec["base_lr"] == 0.03
    assert len(jaxs) == len(ports) == 4
    for want, got in zip(jaxs, ports):
        _same(want, got)


def test_kinetics_and_example_configs_equal_the_jax_files(monkeypatch, tmp_path):
    mod, jaxs = _jax_script("accuracy_kinetics_geom", monkeypatch, tmp_path)
    with pytest.raises(Caught):
        mod.run(num_classes=5, epochs=13, batch_size=3, base_lr=0.1, seed=4)
    ports = _port_configs(monkeypatch, accuracy_kinetics_geom, [
        lambda: accuracy_kinetics_geom.run(num_classes=5, epochs=13, batch_size=3,
                                           base_lr=0.1, seed=4, device="cpu")])
    _same(jaxs[0], ports[0])
    assert accuracy_kinetics_geom.GEOMETRY == dict(  # the JAX file's make_motion_dataset call
        train_per_class=12, eval_per_class=4, num_frames=64, height=256, width=256)

    # examples/train_synthetic.py: its config at main(), both with the flags
    from fastvideotagging_tpu.data import synthetic as jsynthetic

    spec = importlib.util.spec_from_file_location(
        "_jax_train_synthetic", os.path.join(REPO, "examples", "train_synthetic.py"))
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    caught = []
    monkeypatch.setattr(jex, "fit", _catching(caught))
    monkeypatch.setattr(jsynthetic, "make_dataset", lambda root, **k: (
        open(os.path.join(root, "list.txt"), "w").write("a/v.mp4 0\n"),
        os.path.join(root, "list.txt"))[1])
    flags = ["--model", "tiny3d", "--classes", "3", "--epochs", "2", "--batch", "2"]
    monkeypatch.setattr(sys, "argv", ["train_synthetic.py", *flags])
    with pytest.raises(Caught):
        jex.main()
    monkeypatch.setattr(train_synthetic, "fit", _catching(caught))
    monkeypatch.setattr(train_synthetic, "make_source", lambda *a: [])
    with pytest.raises(Caught):
        train_synthetic.main([*flags, "--device", "cpu"])
    want, got = caught
    assert os.path.basename(want.train.checkpoint_dir) == "ckpt"
    assert os.path.basename(got.train.checkpoint_dir) == "ckpt"
    _same(dataclasses.replace(want, train=dataclasses.replace(want.train, checkpoint_dir="")),
          dataclasses.replace(got, train=dataclasses.replace(got.train, checkpoint_dir="")))


def test_kinetics_geometry_sources_equal_the_jax_packages():
    """One 256x256x64 motion video, bitwise, as accuracy_kinetics_geom makes them."""
    g = accuracy_kinetics_geom.GEOMETRY
    args = dict(num_frames=g["num_frames"], height=g["height"], width=g["width"], seed=0)
    got = synthetic_motion.make_motion_frames(5, 13, **args)
    want = jmotion.make_motion_frames(5, 13, **args)
    assert got.shape == (64, 256, 256, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# --- the scripts on the CPU at a tiny size ---------------------------------

TINY = ["--classes", "2", "--epochs", "5", "--batch", "8", "--source", "pack",
        "--device", "cpu"]
# 4 train and 2 eval videos a class: one step an epoch at B = 8
TINY_SET = dict(train_per_class=4, eval_per_class=2)


@pytest.fixture
def few_threads():
    """Two torch threads: in a loaded suite more threads wait at every op."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def tiny(monkeypatch, few_threads):
    """The motion set cut to TINY_SET's videos a class, on few threads."""
    monkeypatch.setattr(int8_serving, "motion_sources",
                        functools.partial(accuracy_hard.motion_sources, **TINY_SET))


def _finite_top1s(row):
    vals = [v for k, v in row.items() if "top1" in k and isinstance(v, float)]
    vals += list(row.get("sweep_top1", {}).values()) + list(row.get("margin_sweep", {}).values())
    assert vals and all(0.0 <= v <= 1.0 for v in vals), row


def _cpu_launches(by_mode):
    """On the CPU no kernel launches; the walk's Q1 calls are the spec's."""
    for f in by_mode.values():
        assert not any(f["launches"].values())
        assert f["walk"]["conv3d_s8"] == f["int8_convs"] > 0


JAX_INT8_S3D_KEYS = {"benchmark", "model", "num_classes", "epochs", "seed", "clip_grad_norm",
                     "bf16_top1", "int8_top1", "int8_dynamic_top1", "train_seconds"}
JAX_FAMILY_KEYS = {"model", "bf16_top1", "int8_top1", "sweep_top1", "default_float_blocks",
                   "epochs", "steps"}
JAX_INCEPTION_KEYS = {"model", "num_classes", "epochs", "seed", "clip_grad_norm", "bf16_top1",
                      "int8_static_global_top1", "int8_static_site_top1", "int8_dynamic_top1",
                      "site_margins", "train_seconds", "margin_sweep"}
JAX_KINETICS_KEYS = {"benchmark", "model", "geometry", "num_classes", "train_videos",
                     "eval_videos", "epochs", "seed", "clip_grad_norm", "chance_top1",
                     "top1_single_clip", "top1_multi_clip_4", "gen_seconds", "train_seconds",
                     "eval_seconds"}


def test_int8_s3d_runs_on_the_cpu(tiny, tmp_path):
    out = str(tmp_path / "r.json")
    r = int8_s3d.main([*TINY, "--out", out])
    assert JAX_INT8_S3D_KEYS <= set(r) and r["steps"] == 5
    assert (r["device"], r["card"], r["eval_videos"]) == ("cpu", None, 4)
    _finite_top1s(r)
    _cpu_launches(r["int8_launches"])
    with open(out) as f:
        assert json.load(f) == r


def test_int8_family_runs_on_the_cpu(tiny):
    r = int8_family.main(["--models", "p3d_63", *TINY])
    (row,) = r["results"]
    assert JAX_FAMILY_KEYS <= set(row) and row["steps"] == 5
    assert set(row["sweep_top1"]) == {"full_int8", "default_tail"}
    _finite_top1s(row)
    _cpu_launches(row["int8_launches"])
    assert (row["int8_launches"]["default_tail"]["int8_convs"]
            < row["int8_launches"]["full_int8"]["int8_convs"])


def test_int8_inception_runs_on_the_cpu(tiny):
    r = int8_inception.main(["--models", "s3d", "--margin-sweep", "--skip-throughput", *TINY])
    (row,) = r["results"]
    assert JAX_INCEPTION_KEYS <= set(row)
    assert set(row["margin_sweep"]) == {f"global_{m}" for m in int8_inception.SWEEP_MARGINS} \
        | {"site_x0.75"}
    assert row["site_margins"]["num_sites"] > 0 and row["site_margins"]["min"] >= 2.0
    _finite_top1s(row)
    _cpu_launches(row["int8_launches"])


def test_kinetics_geometry_runs_on_the_cpu(monkeypatch, few_threads):
    """The script's run with its config's clip and crop cut to 8x32x32 (the
    sources a tenth of the set's: 2 classes, 2 + 1 videos of 16 frames)."""
    small = accuracy_kinetics_geom.kinetics_config

    def cut(*a, **k):
        c = small(*a, **k)
        return dataclasses.replace(c, data=dataclasses.replace(
            c.data, source_hw=(48, 48), resize_hw=(40, 40), crop_hw=(32, 32), num_workers=2,
            sampler=dataclasses.replace(c.data.sampler, clip_len=8)))

    monkeypatch.setattr(accuracy_kinetics_geom, "kinetics_config", cut)
    r = accuracy_kinetics_geom.run(num_classes=2, epochs=5, batch_size=2, source="pack",
                                   device="cpu", geometry=dict(train_per_class=2,
                                                               eval_per_class=1,
                                                               num_frames=16, height=48,
                                                               width=48))
    assert JAX_KINETICS_KEYS <= set(r)
    assert (r["train_videos"], r["eval_videos"], r["steps"]) == (4, 2, 10)
    assert set(r["launches"]) == {"fit", "eval_1_clips", "eval_4_clips"}
    _finite_top1s(r)


def test_train_synthetic_runs_on_the_cpu(capsys, few_threads):
    r = train_synthetic.main(["--device", "cpu", "--epochs", "1", "--source", "pack"])
    assert r["eval"]["num_videos"] == 8 and np.isfinite(r["eval"]["top1"])
    assert len(r["tags"]) == 3 and r["steps"] == 2
    out = capsys.readouterr().out
    assert "eval:" in out and "tag(video):" in out
