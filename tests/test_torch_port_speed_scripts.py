"""The reference's six speed scripts as modules of the port, the graphed
serving boundary on the CPU, and INT8_INCEPTION's two runs that train
nothing into the record, against the JAX package.

- Each script's configuration (models, batch, geometry, arms, epochs)
  equals its JAX file's, read from the JAX file's source (no JAX script is
  imported: several pin JAX's platform when they are).
- Each script's entry point at a tiny size on the CPU returns its JAX
  record's keys (the heavy parts that only the card can time are stubbed
  where they would take seconds: the native tier's AOTInductor packages
  and runner processes, the traced attribution of int8_kinetics, the
  remat arms' child processes, scaleonly's and remat's train steps, which
  slowfast_step and e2e_train time for real); ``main`` raises without a
  card.
- Each committed record has its JAX record's keys and a ``card`` naming an
  H100 and its power limit. The JAX record's ``plugin`` (native_serving:
  the PJRT plugin) has no counterpart: the port writes ``op_library``.
- ``int8_inception --throughput-only`` rewrites the throughput rows only:
  every trained row of INT8_INCEPTION.json stays byte for byte (a stub
  timing function).
- The site report's per-site clipped share and error equal the same
  quantities computed from the JAX package's ``spec_walk`` and
  ``int8_infer(debug_sites=True)`` on one set of converted weights and one
  qpack (s3d, 8x32x32, 2 clips) within 1e-4, the report taking the JAX
  walk's values as its reference (the int8 engines agree bit for bit).
  On the port's own walk, which rounds in other places than the JAX one,
  they move by no more than the two walks differ by at the site. Its
  calibration amax and margins equal ``calibrate(return_margins=True)``'s
  within the calibrations' rtol 1e-2.
- ``Graphed`` on the CPU calls its forward directly, and its trees (a
  qpack's dicts and lists) flatten and rebuild as they were.
"""

import ast
import functools
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastvideotagging_tpu.ops import arch_spec as jspec
from fastvideotagging_tpu.ops import int8_infer as ji
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.benchmarks import (
    e2e_train,
    int8_inception,
    int8_kinetics,
    native_serving,
    remat_step,
    scaleonly_step,
    slowfast_step,
)
from fastvideotagging_tpu_torch.evaluation import graphed
from fastvideotagging_tpu_torch.models import layers
from fastvideotagging_tpu_torch.models.convert import to_jax_variables
from fastvideotagging_tpu_torch.ops import arch_spec as tspec
from fastvideotagging_tpu_torch.utils import step_profiler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_BENCH = os.path.join(REPO, "fastvideotagging_tpu_torch", "benchmarks")
JAX_BENCH = os.path.join(REPO, "benchmarks")
SCRIPTS = {"int8_kinetics": int8_kinetics, "native_serving": native_serving,
           "e2e_train": e2e_train, "slowfast_step": slowfast_step,
           "scaleonly_step": scaleonly_step, "remat_step": remat_step}
# script -> its record (the JAX record's file name)
RECORDS = {"int8_kinetics": "INT8_KINETICS_PROFILE.json",
           "native_serving": "NATIVE_SERVING.json", "e2e_train": "E2E_TRAIN.json",
           "slowfast_step": "SLOWFAST_STEP.json", "scaleonly_step": "SCALEONLY_STEP.json",
           "remat_step": "REMAT_STEP.json"}
# JAX record keys with no counterpart in the port's record, and why
RENAMED = {"native_serving": {"plugin": "op_library"}}  # the PJRT plugin: the op library
CARD = re.compile(r"H100.*, \d+(\.\d+)? W$")


@pytest.fixture
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _tree(path):
    with open(path) as f:
        return ast.parse(f.read())


def _argparse_defaults(tree) -> dict:
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args and isinstance(node.args[0], ast.Constant)):
            for kw in node.keywords:
                if kw.arg == "default":
                    try:
                        out[node.args[0].value] = ast.literal_eval(kw.value)
                    except ValueError:  # a computed default
                        out[node.args[0].value] = ast.unparse(kw.value)
    return out


def _constants(tree) -> dict:
    out = {}
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = node.targets[0]
            names = ([t.id for t in targets.elts] if isinstance(targets, ast.Tuple)
                     else [targets.id] if isinstance(targets, ast.Name) else [])
            try:
                value = ast.literal_eval(node.value)
            except ValueError:
                continue
            out.update(zip(names, value) if len(names) > 1 else {names[0]: value}.items())
    return out


def _func_defaults(tree, name: str) -> dict:
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)
    args = fn.args.args[len(fn.args.args) - len(fn.args.defaults):]
    return {a.arg: ast.literal_eval(d) for a, d in zip(args, fn.args.defaults)}


def _loop_tuples(tree) -> list:
    return [ast.literal_eval(n.iter) for n in ast.walk(tree)
            if isinstance(n, ast.For) and isinstance(n.iter, ast.Tuple)]


def _jax(name):
    return _tree(os.path.join(JAX_BENCH, f"{name}.py"))


def _port(name):
    return _tree(os.path.join(PORT_BENCH, f"{name}.py"))


def _signature_defaults(fn) -> dict:
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


def test_speed_script_configs_equal_the_jax_files():
    bench = _tree(os.path.join(REPO, "bench.py"))
    # the train step and the forward the step scripts time
    want = _func_defaults(bench, "bench_train_step")
    got = _signature_defaults(step_profiler.bench_train_step)
    for k in ("batch_size", "clip_len", "crop", "model_name", "norm", "remat"):
        assert got[k] == want[k], k
    assert tuple(got["source_hw"]) == tuple(want["source_hw"])
    want = _func_defaults(bench, "bench_inference")
    got = _signature_defaults(step_profiler.bench_inference)
    assert {k: got[k] for k in want} == want
    # int8_kinetics: the model, batch, clip and crop
    want = _constants(_jax("int8_kinetics"))
    assert (int8_kinetics.MODEL, int8_kinetics.B, int8_kinetics.T, int8_kinetics.CROP) == (
        want["MODEL"], want["B"], want["T"], want["CROP"])
    # slowfast_step / scaleonly_step: the models or arms, the batch
    assert tuple(slowfast_step.MODELS) in _loop_tuples(_jax("slowfast_step"))
    assert tuple(scaleonly_step.ARMS) in _loop_tuples(_jax("scaleonly_step"))
    for name in ("slowfast_step", "scaleonly_step", "remat_step"):
        want, got = _argparse_defaults(_jax(name)), _argparse_defaults(_port(name))
        assert got["--batch"] == want["--batch"] == 32
        if name == "remat_step":
            assert got["--repeats"] == want["--repeats"]
    want = _constants(_jax("remat_step"))
    assert (remat_step.MODELS, remat_step.POLICIES) == (want["MODELS"], want["POLICIES"])
    # e2e_train: the pack, the epochs, the logging window, the preset
    want, got = _argparse_defaults(_jax("e2e_train")), _argparse_defaults(_port("e2e_train"))
    for flag in ("--videos", "--frames", "--epochs", "--log-every"):
        assert got[flag] == want[flag], flag
    cfg = e2e_train.train_config(False, 4, 8)
    assert (cfg.model.name, cfg.train.batch_size, cfg.data.resize_hw) == (
        "r2plus1d_18", 32, (128, 171))
    # native_serving: the rows, their batches and instances, the geometry
    jax_ns = _jax("native_serving")
    rows = next(n for n in jax_ns.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "ROWS")
    assert set(native_serving.ROWS) == {k.value for k in rows.value.keys}
    assert _func_defaults(jax_ns, "throughput_row") == {"batch": 8, "n": 21}
    assert _func_defaults(jax_ns, "int8_row") == {"batch": 8, "n": 21}
    assert _func_defaults(jax_ns, "daemon_row") == {"batch": 8, "n": 12}
    assert _func_defaults(jax_ns, "daemon_pipelined_row") == {"batch": 8, "n": 12}
    assert {k: v for k, v in _signature_defaults(native_serving._bench_row).items()
            if k in ("batch", "n")} == {"batch": 8, "n": 21}
    assert {k: v for k, v in _signature_defaults(native_serving._daemon_row).items()
            if k in ("batch", "n")} == {"batch": 8, "n": 12}
    assert native_serving.CLIP == (16, 128, 171) and native_serving.CROP == (112, 112)
    src = inspect.getsource(native_serving)
    assert "pipeline=2 if" in src and "_clips(np.random.default_rng(0), 2)" in src


def _keys_cover(want, got, where="", renamed=None):
    """Every key of the JAX record ``want`` is in ``got`` (recursively for
    dicts, and the first row of lists of dicts)."""
    renamed = renamed or {}
    for k, v in want.items():
        key = renamed.get(k, k)
        assert key in got, f"{where}{k}"
        if isinstance(v, dict) and isinstance(got[key], dict) and k not in ("rows",):
            _keys_cover(v, got[key], f"{where}{k}.")
        elif isinstance(v, list) and v and isinstance(v[0], dict):
            _keys_cover({kk: vv for kk, vv in v[0].items() if kk != "error"}, got[key][0],
                        f"{where}{k}[0].")
    if "rows" in want:
        for row, cols in want["rows"].items():
            _keys_cover(cols, got["rows"][row], f"{where}rows.{row}.")


def _jax_record(script):
    with open(os.path.join(JAX_BENCH, RECORDS[script])) as f:
        return json.load(f)


def _small(monkeypatch, module, **consts):
    """The script's clip geometry and timing cut to a host run's size."""
    for name, value in consts.items():
        assert hasattr(module, name), name
        monkeypatch.setattr(module, name, value)


STEP_SIZE = dict(CLIP_LEN=8, CROP=32, SOURCE_HW=(36, 40), ITERS=1, WINDOWS=1)


def _tiny_slowfast(monkeypatch):
    _small(monkeypatch, slowfast_step, **STEP_SIZE)
    return slowfast_step.main(["--device", "cpu", "--batch", "1"])


def _fake_step(model_name, batch_size, clip_len, crop, source_hw, norm="batch", remat="none",
               device="cuda", iters=5, windows=3):
    """``bench_train_step``'s result, made up (slowfast_step and e2e_train
    run the real one)."""
    assert device == "cpu"
    return dict(clips_per_sec=10.0, step_s=0.1, achieved_tflops=1.0, conv_flops=1e11,
                conv_roofline_step_s=0.01, roofline_fraction=0.1, window_ms=[100.0] * windows,
                peak_step_mib=None)


def _tiny_scaleonly(monkeypatch):
    _small(monkeypatch, scaleonly_step, **STEP_SIZE)
    monkeypatch.setattr(scaleonly_step, "bench_train_step", _fake_step)
    return scaleonly_step.main(["--device", "cpu", "--batch", "1"])


def _tiny_remat(monkeypatch):
    """Two arms (their step made up); each child process runs in this one
    (the command it would start is checked)."""
    _small(monkeypatch, remat_step, **STEP_SIZE)
    monkeypatch.setattr(remat_step, "bench_train_step", _fake_step)

    def run(cmd, **kw):
        assert cmd[:3] == [sys.executable, "-m", "fastvideotagging_tpu_torch.benchmarks.remat_step"]
        row = remat_step.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, 0, json.dumps(row) + "\n", "")
    monkeypatch.setattr(remat_step.subprocess, "run", run)
    return remat_step.main(["--device", "cpu", "--batch", "1", "--models", "r2plus1d_18",
                            "--policies", "none,full", "--repeats", "1"])


def _tiny_e2e():
    return e2e_train.main(["--smoke", "--device", "cpu", "--videos", "8", "--frames", "6",
                           "--epochs", "2", "--log-every", "1", "--all"])


def _tiny_int8_kinetics(monkeypatch):
    """The attribution's trace stubbed by rows of each kind (a Q1 conv, a
    bf16 conv, a quantize pass, another kernel); the graphed clips/s run."""
    Row = step_profiler.Row

    def fake(model, batch, clip_len, crop, n_steps, trace_dir, int8, device):
        rows = [Row(50.0, 0.0, None, "conv1", "fwd", "spatial_conv_hopper_kernel", "c", 1),
                Row(5.0, 0.0, None, "", "", "elementwise", "fwd_elementwise/other", 1)]
        if int8:
            rows += [Row(40.0, 0.0, None, "conv2", "fwd", "conv3d_s8_hopper_kernel", "c", 1),
                     Row(2.0, 0.0, None, "input", "quant", "quantize_s8_kernel",
                         "fwd_quantize", 1)]
        return rows, {}, {"device_us_per_step": sum(r.us for r in rows), "steps_captured": 1}
    monkeypatch.setattr(int8_kinetics, "profile_eval_step", fake)
    _small(monkeypatch, int8_kinetics, MODEL="r2plus1d_18", B=1, T=4, CROP=16, ITERS=1,
           WINDOWS=1, STEPS=1)
    return int8_kinetics.main(["--device", "cpu"])


def _tiny_native(monkeypatch):
    """The packages and the runner stubbed by the in-process serving
    function of the package's config (no AOTInductor, no g++); the rows'
    logic, keys and checks run, at a 4x36x40 input cropped to 32x32."""
    native_serving._state.cache_clear()
    monkeypatch.setattr(native_serving, "CLIP", (4, 36, 40))
    monkeypatch.setattr(native_serving, "CROP", (32, 32))
    monkeypatch.setattr(native_serving, "ITERS", 1)
    monkeypatch.setattr(native_serving, "WINDOWS", 1)
    monkeypatch.setattr(native_serving, "_bench_row",
                        functools.partial(native_serving._bench_row, batch=2, n=6))
    monkeypatch.setattr(native_serving, "_daemon_row",
                        functools.partial(native_serving._daemon_row, batch=2, n=2))
    pkgs = {}

    def export(cfg, sd, clip_batch, path, qpack=None, device="cuda"):
        pkgs[path] = native_serving.serving.ServingFn(cfg, sd, qpack=qpack, device=device)
        return path

    def scores(pkg, clips):
        with torch.inference_mode():
            return pkgs[pkg](torch.from_numpy(clips)).float().numpy()

    def run_summary(pkg, inputs, workdir, device="cuda", bench=1, timeout=600):
        clips = inputs[0]
        out = {"outputs": [scores(pkg, clips[-1] if bench > 1 else clips)], "launches": None}
        if bench > 1:
            out["bench"] = dict(n_short=5, n_long=15, t_short_s=0.5, t_long_s=1.5,
                                sec_per_exec=0.1, device_ms_per_exec=-1.0)
        return out

    class Server:
        def __init__(self, pkg, specs, workdir, device="cuda", pipeline=0):
            self.pkg = pkg

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def request(self, inputs):
            return [scores(self.pkg, inputs[0])]

        def request_many(self, batches):
            for b in batches:
                yield self.request(b)

    monkeypatch.setattr(native_serving.serving, "export_serving_native", export)
    monkeypatch.setattr(native_serving.runner, "run_summary", run_summary)
    monkeypatch.setattr(native_serving.runner, "NativeServer", Server)
    try:
        return native_serving.main(["--device", "cpu"])
    finally:
        native_serving._state.cache_clear()


TINY = {"slowfast_step": _tiny_slowfast,
        "scaleonly_step": _tiny_scaleonly,
        "remat_step": _tiny_remat, "e2e_train": lambda mp: _tiny_e2e(),
        "int8_kinetics": _tiny_int8_kinetics, "native_serving": _tiny_native}


@pytest.mark.parametrize("script", sorted(TINY))
def test_each_script_returns_its_jax_record_keys_on_the_cpu(script, monkeypatch, few_threads):
    # a uniform init in place of the truncated normal's (the models' values do
    # not matter here, and the deep models' inits took seconds)
    monkeypatch.setattr(layers, "_variance_scaling",
                        lambda shape, scale, fan_in, generator: torch.empty(shape).uniform_(
                            -(3 * scale / fan_in) ** 0.5, (3 * scale / fan_in) ** 0.5,
                            generator=generator))
    got = TINY[script](monkeypatch)
    want = _jax_record(script)
    if script == "scaleonly_step":  # the JAX record's arm names
        assert set(got["rows"]) == set(want["rows"])
    if script == "slowfast_step":
        assert set(got["rows"]) == set(want["rows"])
    _keys_cover(want, got, renamed=RENAMED.get(script))
    assert got["card"] is None and got["device"] == "cpu"
    finite = [v for v in json.dumps(got).split() if v.rstrip(",").lower() in ("nan", "inf")]
    assert not finite, finite
    if script == "remat_step":
        assert [r["remat"] for r in got["best_per_arm"]] == ["none", "full"]
        assert "vs_none_pct" in got["best_per_arm"][1]
    if script == "int8_kinetics":
        assert got["int8"]["ms"] == {"conv_s8": 0.04, "conv_float": 0.05,
                                     "quantize_pass_s8out": 0.002, "other": 0.005}
        assert got["epilogue_fused_upper_bound_ms"] == 0.095
        assert got["int8"]["top_quantize_passes_us"] == [[2, "input"]]


@pytest.mark.parametrize("script", sorted(SCRIPTS) + ["int8_inception_throughput_only"])
def test_speed_scripts_raise_without_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    if script == "int8_inception_throughput_only":
        call = functools.partial(int8_inception.main,
                                 ["--throughput-only", "--out", "/nonexistent"])
    else:
        call = functools.partial(SCRIPTS[script].main, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def _port_record(name):
    path = os.path.join(PORT_BENCH, name)
    assert os.path.exists(path), f"{path} missing"
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("script", sorted(RECORDS))
def test_committed_speed_records_have_the_jax_keys_and_the_card(script):
    got = _port_record(RECORDS[script])
    _keys_cover(_jax_record(script), got, renamed=RENAMED.get(script))
    assert CARD.search(got["card"]), got["card"]
    assert got["device"] == "cuda"


def test_committed_int8_inception_throughput_rows_name_their_run_and_card():
    r = _port_record("INT8_INCEPTION.json")
    for row in r["results"]:
        tp = row["throughput"]
        assert CARD.search(tp["card"]) and "--throughput-only" in tp["run"]
        assert "captured CUDA graph" in tp["timing"]
    sites = _port_record("INT8_INCEPTION_S3D_SITES.json")
    assert CARD.search(sites["card"]) and sites["model"] == "s3d"
    assert len(sites["sites"]) == sites["site_margins"]["num_sites"] == 59
    errors = [s["rel_error"] for s in sites["sites"]]
    assert errors == sorted(errors, reverse=True)
    ref = {row["model"]: row for row in r["results"]}["s3d"]
    for k in ("num_classes", "epochs", "seed", "clip_grad_norm"):
        assert sites[k] == ref[k], k


def test_throughput_only_keeps_every_trained_row_byte_for_byte(monkeypatch, tmp_path):
    src = os.path.join(PORT_BENCH, "INT8_INCEPTION.json")
    record, out = str(tmp_path / "in.json"), str(tmp_path / "out.json")
    shutil.copy(src, record)
    with open(src) as f:
        before_text = f.read()
    before = json.loads(before_text)
    assert json.dumps(before, indent=2) + "\n" == before_text  # json round-trips the record
    calls = []

    def stub(model):
        calls.append(model)
        return {"bf16_clips_per_sec": 1.0, "int8_static_clips_per_sec": 3.0,
                "int8_dynamic_clips_per_sec": 2.0, "geometry": "B=32 16x112x112",
                "timing": "stub"}
    monkeypatch.setattr(int8_inception, "serving_throughput", stub)
    monkeypatch.setattr(int8_inception, "card", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(int8_inception, "resolve_device", lambda d: torch.device("cpu"))
    int8_inception.remeasure_throughput(record, out, ["s3d", "i3d"])
    assert calls == ["s3d", "i3d"]
    with open(out) as f:
        after = json.loads(f.read())
    for old, new in zip(before["results"], after["results"]):
        assert new["throughput"]["dynamic_over_static"] == round(2.0 / 3.0, 4)
        assert new["throughput"]["card"].startswith("NVIDIA H100")
        new["throughput"] = old["throughput"]
    # with the old throughput rows put back, the file is the old one, byte for byte
    assert json.dumps(after, indent=2) + "\n" == before_text
    with open(record) as f:
        assert f.read() == before_text  # --out elsewhere leaves --record alone


def _jax_qpack(qp):
    def tree(v):
        if torch.is_tensor(v):
            return jnp.asarray(v.numpy())
        if isinstance(v, dict):
            return {k: tree(x) for k, x in v.items() if k != "wk"}
        return [tree(x) for x in v]
    return tree(qp)


def test_site_report_equals_the_jax_packages_quantities(few_threads, monkeypatch):
    """s3d at 8x32x32, 2 calibration clips (one batch each) and 2 eval clips
    of three times their amplitude (so that every site clips some values),
    seeded weights converted to the JAX package's variables: each site's
    clipped share and
    error, with the JAX walk's values as the reference, against the same
    quantities from that walk and ``int8_infer(..., debug_sites=True)``'s
    reconstruction on the same qpack within 1e-4; on the port's own walk
    within 1e-4 plus what the walks differ by; the per-batch amax and
    margin against ``calibrate(return_margins=True)``'s."""
    model = get_model("s3d", num_classes=5, device="cpu",
                      generator=torch.Generator().manual_seed(0)).eval()
    sd = model.state_dict()
    x = np.random.default_rng(5).standard_normal((2, 8, 32, 32, 3)).astype(np.float32)
    calib = [torch.from_numpy(x[:1]), torch.from_numpy(x[1:])]
    xe = 3 * np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    spec = tspec.spec_for("s3d")
    rows = int8_inception.site_report(sd, calib, [torch.from_numpy(xe)], spec)

    jv = to_jax_variables(sd, model)
    js = jspec.spec_for("s3d")
    _, margins = ji.calibrate(jv, [x[:1], x[1:]], spec=js, return_margins=True)
    amax = [jax.device_get(ji._calibrate_sites(jv, jnp.asarray(b), js)) for b in (x[:1], x[1:])]
    scales, tmargins = int8_inception.calibrate(sd, calib, spec=spec, return_margins=True)
    qp = int8_inception.quantize_variables(sd, scales, spec=spec, static_margin=tmargins)

    def run_ref(v, xx):
        out = {}

        def record(site, t):
            out[site] = t.astype(jnp.float32)
            return t
        ji.spec_walk(js, v, xx, record)
        return out
    ref = jax.device_get(jax.jit(run_ref)(jv, jnp.asarray(xe)))
    _, got = jax.device_get(ji.int8_infer(_jax_qpack(qp), jnp.asarray(xe), js, debug_sites=True))
    own = {}

    def keep(site, t):
        own[site] = t.float().numpy()
        return t
    with torch.inference_mode():
        int8_inception.spec_walk(spec, sd, torch.from_numpy(xe), keep)

    def jax_walk(spec, variables, xx, record):
        for site, r in ref.items():
            record(site, torch.from_numpy(np.array(r)))
    monkeypatch.setattr(int8_inception, "spec_walk", jax_walk)
    on_ref = {r["site"]: r for r in int8_inception.site_report(sd, calib, [torch.from_numpy(xe)],
                                                               spec)}
    assert len(rows) == len(got) == len(on_ref) == 59
    for row in rows:
        site = row["site"]
        r, q = np.asarray(ref[site], np.float64), np.asarray(got[site], np.float64)
        err = np.abs(q - r).mean() / (np.abs(r).mean() + 1e-9)
        factor = qp["inv_f"][site].numpy() / qp["s_static"][site].numpy()
        t = np.asarray(ref[site], np.float32) * factor
        clipped = float((np.abs(np.round(t)) > 127).mean())
        assert abs(on_ref[site]["rel_error"] - err) <= 1e-4, (site, on_ref[site]["rel_error"],
                                                               err)
        assert abs(on_ref[site]["clipped_share"] - clipped) <= 1e-4, site
        # the port's own walk: d, the walks' mean |difference| over the mean
        # |value| (up to 0.9 % at mixed5b), moves the error by at most
        # d (1 + err) / (1 - d); a value can cross the clip (|t| >= 127.5)
        # only where its distance to it is within the walks' difference there
        d = np.abs(own[site] - r).mean() / np.abs(r).mean()
        tol = 1e-4 + d * (1 + err) / (1 - d)
        assert abs(row["rel_error"] - err) <= tol, (site, row["rel_error"], err, tol)
        near = float((np.abs(np.abs(t) - 127.5)
                      <= np.abs(own[site] * factor - t) + 1e-6).mean())
        assert abs(row["clipped_share"] - clipped) <= 1e-4 + near, (site, near)
        # the calibration walks of the two packages round in other places
        # (tests/test_torch_port_int8.py holds the static scales to rtol 1e-2)
        want = [float(np.asarray(a[site]).max()) for a in amax]
        np.testing.assert_allclose(row["calib_amax_per_batch"], want, rtol=1e-2)
        np.testing.assert_allclose(row["margin"], margins[site], rtol=1e-2)
    assert [r["rel_error"] for r in rows] == sorted((r["rel_error"] for r in rows), reverse=True)
    assert min(r["clipped_share"] for r in on_ref.values()) > 0


def test_graphed_calls_its_forward_directly_on_the_cpu():
    calls = []

    def fn(qpack, x):
        calls.append(qpack)
        return {"scores": x * qpack["s"], "n": [x.sum()]}
    g = graphed.Graphed(fn, "a forward", reused=(0,))
    qpack, x = {"s": torch.tensor(2.0)}, torch.ones(3)
    out = g(qpack, x)
    assert calls == [qpack] and torch.equal(out["scores"], 2 * x) and g.captures == 0
    assert g.fn is fn


def test_graphed_trees_flatten_and_rebuild():
    leaves = []
    tree = ({"a": torch.ones(1), "b": [torch.zeros(2), (torch.ones(3),)]}, torch.ones(()))
    spec = graphed._flatten(tree, leaves)
    assert len(leaves) == 4
    again = graphed._unflatten(spec, iter(leaves))
    assert isinstance(again, tuple) and isinstance(again[0]["b"], list)
    assert isinstance(again[0]["b"][1], tuple)
    assert all(a is b for a, b in zip(leaves, [again[0]["a"], again[0]["b"][0],
                                               again[0]["b"][1][0], again[1]]))
    with pytest.raises(TypeError, match="tensors and dicts, lists and tuples"):
        graphed._flatten({"k": 1}, [])
