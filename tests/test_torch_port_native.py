"""The port's native serving tier on the CPU, against the JAX package's.

- The nine ``fvt::*`` schemas have one source, csrc/fvt_schemas.inc: what
  ops/library.py registers equals each line.
- csrc/plans.h (the plans the C++ op library launches with), built here
  with g++ behind ``extern "C"`` shims, equals the Python plans at every
  K1 / K2 / Q1 / Q2 call of an r2plus1d_18 forward (bf16, static and
  dynamic int8; read off ``torch.export`` graphs at 16x112x112) at B = 8
  and 32, for an H100's 132 SMs.
- ``NativeServer`` (native/runner.py) against a fake daemon speaking the
  runner's line protocol: the reference's cases (tests/test_native_pjrt.py):
  ordering, cleanup, desync, soft errors, an abandoned ``request_many``,
  validation before an id is spent, use after close.
- ``NativeTagger`` and ``cli.tag --engine native`` bit for bit against the
  JAX package's over the same fake scoring daemon, the same synthetic
  videos and pack (the JAX side patched as its own hermetic tests patch it,
  its C resize tier off, as test_torch_port_cli.py does).
- ``export_serving_native`` on the CPU of the default ('cuda'-route)
  program, bf16 and int8 static and dynamic, loaded with
  ``torch._inductor.aoti_load_package``: the ``fvt::*`` ops stay extern
  calls of the package (their plain versions counted: 13 / 14, 28 / 1,
  28 / 26 + 1 a forward) and its scores equal the eager ``ServingFn``'s.

The real runner is in test_torch_port_native_runner.py.
"""

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastvideotagging_tpu.cli import tag as jcli_tag
from fastvideotagging_tpu.data.packed import write_pack as jwrite_pack
from fastvideotagging_tpu.data.ucf101 import load_video_list as jload_video_list
from fastvideotagging_tpu.evaluation.native_tagger import NativeTagger as JNativeTagger
from fastvideotagging_tpu.native import pjrt as jpjrt
from fastvideotagging_tpu_torch import config as tcfg
from fastvideotagging_tpu_torch import get_model
from fastvideotagging_tpu_torch.cli import serve as cli_serve
from fastvideotagging_tpu_torch.cli import tag as cli_tag
from fastvideotagging_tpu_torch.data.packed import Pack
from fastvideotagging_tpu_torch.evaluation import serving
from fastvideotagging_tpu_torch.evaluation.native_tagger import NativeTagger
from fastvideotagging_tpu_torch.evaluation.tagger import (
    iter_pack_tags,
    rank_tags,
    scores_from_frames,
    stream_video_scores,
)
from fastvideotagging_tpu_torch.native import runner
from fastvideotagging_tpu_torch.ops import _build, library
from fastvideotagging_tpu_torch.ops import conv2plus1d as k12
from fastvideotagging_tpu_torch.ops import int8_conv as q8


@pytest.fixture(autouse=True, scope="module")
def two_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# One source for the schemas; plans.h against the Python plans
# ---------------------------------------------------------------------------


def test_schemas_have_one_source():
    with open(library.SCHEMA_FILE) as f:
        lines = [ln for ln in f.read().splitlines() if ln.startswith("FVT_SCHEMA(")]
    assert len(lines) == len(library.OPS) == 9
    for line, op in zip(lines, library.OPS):
        assert line == f'FVT_SCHEMA("{str(op._schema)[len("fvt::"):]}")'
    assert library.read_schemas() == library.SCHEMAS
    with open(os.path.join(_build.CSRC, "fvt_ops.cpp")) as f:
        cpp = f.read()
    assert '#include "fvt_schemas.inc"' in cpp
    for name in library.SCHEMAS:  # a CUDA implementation of each
        assert f'm.impl("{name}", &{name});' in cpp


_SHIMS = r"""
#include "plans.h"
extern "C" {
void taps(int temporal, long long a, long long b, long long c, int ch, int co, int k, int sms,
          long long* out) {
  const fvt::TapsPlan p = temporal ? fvt::temporal_plan(a, b, c, ch, co, k, sms)
                                   : fvt::spatial_plan(a, b, c, ch, co, k, sms);
  const long long v[] = {p.bn, p.stages, p.smem_bytes, p.row_tiles, p.col_tiles, p.splits, p.cp};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
}
int conv_s8(long long rows, int co, int taps, int cp, int es, long long row_bytes, int sms,
            long long* out) {
  fvt::ConvS8Plan p;
  if (!fvt::conv_s8_plan(rows, co, taps, cp, es, row_bytes, sms, &p)) return 0;
  const long long v[] = {p.bn, p.stages, p.staged, p.smem_bytes, p.row_tiles, p.col_tiles,
                         p.slices, p.grid};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 1;
}
void quantize(long long numel, int c, long long* out) {
  const fvt::QuantizeSizes z = fvt::quantize_sizes(numel, c);
  out[0] = z.rows;
  out[1] = z.cp;
}
}
"""


@pytest.fixture(scope="module")
def plans_lib(tmp_path_factory):
    d = tmp_path_factory.mktemp("plans")
    src = d / "shims.cpp"
    src.write_text(_SHIMS)
    so = str(d / "libplans.so")
    subprocess.run(["g++", "-std=c++17", "-O1", "-Wall", "-Werror", "-shared", "-fPIC",
                    f"-I{_build.CSRC}", str(src), "-o", so], check=True, timeout=120)
    lib = ctypes.CDLL(so)
    L, I, P = ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.taps.argtypes = [I, L, L, L, I, I, I, I, P]
    lib.conv_s8.argtypes = [L, I, I, I, I, L, I, P]
    lib.conv_s8.restype = I
    lib.quantize.argtypes = [L, I, P]
    return lib


def _call(fn, *args, n):
    out = (ctypes.c_longlong * n)()
    rc = fn(*args, out)
    return rc, tuple(out)


FULL = tcfg.DataConfig()  # 16x128x171 in, 112x112 crop: the preset's clip
SMS = 132


def _graph_calls(program):
    """(op name, args with each tensor as its shape) of every fvt op node."""
    calls = []
    for node in program.graph.nodes:
        if node.op == "call_function" and str(node.target).startswith("fvt."):
            args = [tuple(a.meta["val"].shape) if hasattr(a, "meta") else a for a in node.args]
            calls.append((str(node.target).split(".")[1], args))
    return calls


@pytest.fixture(scope="module")
def r2plus1d_sites():
    """The fvt op calls of an r2plus1d_18 serving forward at 8 clips of
    16x128x171 (bf16, int8 static, int8 dynamic), from ``torch.export``
    (shapes only: nothing runs at full size). The qpack is calibrated on a
    4x32x32 clip: its tensors do not depend on the clip size."""
    small = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(name="r2plus1d_18", num_classes=5, dropout=0.0),
        data=tcfg.DataConfig(source_hw=(40, 48), resize_hw=(36, 40), crop_hw=(32, 32),
                             sampler=tcfg.ClipSamplerConfig(clip_len=4)))
    full = tcfg.ExperimentConfig(model=small.model, data=FULL)
    sd = get_model("r2plus1d_18", num_classes=5, device="cpu",
                   generator=torch.Generator().manual_seed(0)).state_dict()
    calib = np.random.default_rng(0).integers(0, 256, (1, 4, 40, 48, 3), dtype=np.uint8)
    qpack = serving.quantize_for_serving(small, sd, [calib], device="cpu")
    x = torch.zeros((8, 16, 128, 171, 3), dtype=torch.uint8)
    out = {}
    for name, qp, dyn in (("bf16", None, None), ("int8", qpack, False),
                          ("int8_dynamic", qpack, True)):
        fn = serving.ServingFn(full, sd, qpack=qp, device="cpu", dynamic=dyn)
        with torch.no_grad():
            out[name] = _graph_calls(torch.export.export(fn, (x,)))
    return out


def _at_batch(shape, b):
    return (b, *shape[1:])


def test_plans_h_equals_the_python_plans(plans_lib, r2plus1d_sites):
    counts = {}
    checked = 0
    for engine, calls in r2plus1d_sites.items():
        names = [n for n, _ in calls]
        counts[engine] = {n: names.count(n) for n in sorted(set(names))}
        for b in (8, 32):
            for name, args in calls:
                if name in ("spatial_conv", "temporal_conv"):
                    x, w = _at_batch(args[0], b), args[1]
                    k, co = w[0], w[-1]
                    if name == "spatial_conv":  # K1 plans on x with its channels padded to 8
                        xp = (*x[:3], k12._ceil8(x[3]))
                        want = k12.spatial_plan(xp, co, k, SMS)
                    else:
                        want = k12.temporal_plan(x, co, k, SMS)
                    _, got = _call(plans_lib.taps, int(name == "temporal_conv"), *x[:3], x[3],
                                   co, k, SMS, n=7)
                    assert got == tuple(int(v) for v in want), (engine, name, x, co)
                elif name.startswith("conv3d_s8"):
                    q, wk = _at_batch(args[0], b), args[1]
                    kernel, strides, pads = args[2], args[6], args[7]
                    co, taps, cp = wk[0], wk[1], q[-1]
                    out = q8.out_size
                    dims = [out(d, kk, s, (lo, hi)) for d, kk, s, lo, hi in
                            zip(q[1:4], kernel, strides, pads[0::2], pads[1::2])]
                    rows = q[0] * dims[0] * dims[1] * dims[2]
                    if name.startswith("conv3d_s8_requant"):
                        es, ld = 1, q8.padded_channels(co)
                    else:
                        es = 4 if name == "conv3d_s8" and args[9] else 2
                        ld = co
                    want = q8.conv_s8_plan(rows, co, taps, cp, es, ld * es, SMS)
                    rc, got = _call(plans_lib.conv_s8, rows, co, taps, cp, es, ld * es, SMS, n=8)
                    assert rc == 1 and got == tuple(int(v) for v in want), (engine, name, q)
                else:  # Q2
                    y = _at_batch(args[0], b)
                    c = y[-1]
                    _, got = _call(plans_lib.quantize, int(np.prod(y)), c, n=2)
                    assert got == (int(np.prod(y)) // c, q8.padded_channels(c)), (engine, y)
                checked += 1
    assert counts == {
        "bf16": {"spatial_conv": 13, "temporal_conv": 14},
        "int8": {"conv3d_s8": 3, "conv3d_s8_requant": 25, "quantize_s8": 1,
                 "spatial_conv": 3, "temporal_conv": 3},
        "int8_dynamic": {"conv3d_s8": 3, "conv3d_s8_amax": 25, "quantize_s8_dynamic": 1,
                         "quantize_s8_given": 25, "spatial_conv": 3, "temporal_conv": 3}}
    assert checked == 2 * (27 + 35 + 60)


def test_plans_h_edge_cases(plans_lib):
    """The column rule's three branches, a split contraction, Q1's narrower
    tile where the row tiles are fewer than the SMs, and no plan where no
    ring of 4 stages fits."""
    for co in (45, 64, 100, 128, 144, 200, 230, 256, 288, 460, 576, 1000):
        for rows in (1000, 6272, 8 * 16 * 56 * 56):
            for cp, taps in ((64, 9), (48, 27), (512, 3)):
                want = k12._taps_plan(rows, cp, co, taps, SMS)
                _, got = _call(plans_lib.taps, 1, 1, 1, rows, cp, co, taps, SMS, n=7)
                assert got == tuple(int(v) for v in want), (rows, cp, co, taps)
                for es, row_bytes in ((1, q8.padded_channels(co)), (2, 2 * co), (4, 4 * co)):
                    want = q8.conv_s8_plan(rows, co, taps, cp, es, row_bytes, SMS)
                    rc, got = _call(plans_lib.conv_s8, rows, co, taps, cp, es, row_bytes, SMS,
                                    n=8)
                    assert rc == 1 and got == tuple(int(v) for v in want)
    with pytest.raises(ValueError, match="no plan"):
        q8.conv_s8_plan(1 << 20, 144, 1, 16, 64)
    rc, _ = _call(plans_lib.conv_s8, 1 << 20, 144, 1, 16, 64, 64 * 144, SMS, n=8)
    assert rc == 0


# ---------------------------------------------------------------------------
# NativeServer against a fake daemon speaking the line protocol
# ---------------------------------------------------------------------------

_FAKE_DAEMON = r'''
import json, os, sys
args = sys.argv[1:]
out_prefix = args[args.index("--output") + 1] if "--output" in args else "out"
sys.stderr.write("ready\n"); sys.stderr.flush()
rid = 0
import numpy as np
for line in sys.stdin:
    paths = line.split()
    if not paths:
        continue
    i = rid; rid += 1
    try:
        arr = np.fromfile(paths[0], np.uint8)
    except OSError:
        print(json.dumps({"request": i, "error": "cannot read input 0"}), flush=True)
        continue
    if arr.size and arr[0] == 255:  # poison value -> soft error reply
        print(json.dumps({"request": i, "error": "poisoned request"}), flush=True)
        continue
    out = arr.astype(np.float32) * 2.0
    f = f"{out_prefix}.req{i}.0"
    out.tofile(f)
    print(json.dumps({"request": i, "outputs": [
        {"file": f, "dtype": "f32", "shape": [int(arr.size)], "bytes": int(out.nbytes)}],
        "launches": None}), flush=True)
'''


def _fake_runner(tmp_path, script) -> str:
    fake = tmp_path / "fake_daemon.py"
    fake.write_text(script)
    wrapper = tmp_path / "fake_runner"
    wrapper.write_text(f"#!/bin/sh\nexec {sys.executable} {fake} \"$@\"\n")
    wrapper.chmod(0o755)
    return str(wrapper)


def _install_fake_runner(tmp_path, monkeypatch, script) -> None:
    """Point the port's build_runner at a shell wrapper around a fake daemon."""
    wrapper = _fake_runner(tmp_path, script)
    monkeypatch.setattr(runner, "build_runner", lambda device="cuda": wrapper)


@pytest.fixture
def fake_server(tmp_path, monkeypatch):
    _install_fake_runner(tmp_path, monkeypatch, _FAKE_DAEMON)
    server = runner.NativeServer("unused.pt2", [((4,), np.uint8)], str(tmp_path / "wd"),
                                 device="cpu", pipeline=2)
    yield server
    server.close()


def _leftovers(server, prefixes=("req", "out")):
    return [f for f in os.listdir(server.workdir) if f.startswith(prefixes)]


def test_request_many_ordered_and_cleans_up(fake_server):
    batches = [[np.arange(4, dtype=np.uint8) + i] for i in range(7)]
    outs = list(fake_server.request_many(iter(batches), depth=3))
    assert len(outs) == 7
    for i, (out,) in enumerate(outs):
        np.testing.assert_array_equal(out, (np.arange(4) + i).astype(np.float32) * 2.0)
    assert _leftovers(fake_server) == []  # all input and output files consumed


def test_request_many_matches_sequential(fake_server):
    batches = [[np.full((4,), i, np.uint8)] for i in range(5)]
    seq = [fake_server.request(b)[0] for b in batches]
    piped = [o[0] for o in fake_server.request_many(iter(batches))]
    for a, b in zip(seq, piped):
        np.testing.assert_array_equal(a, b)


def test_abandoned_request_many_drains_and_stays_usable(fake_server):
    batches = [[np.full((4,), i, np.uint8)] for i in range(6)]
    gen = fake_server.request_many(iter(batches), depth=3)
    next(gen)  # one reply consumed, two or more still in flight
    gen.close()  # abandoned: the in-flight replies are drained
    out, = fake_server.request([np.full((4,), 9, np.uint8)])
    np.testing.assert_array_equal(out, np.full((4,), 18.0, np.float32))
    assert _leftovers(fake_server) == []


def test_client_validation_error_leaves_protocol_intact(fake_server):
    # a shape mismatch raises before a request id is spent or a stdin line
    # is written, so the server keeps working afterwards
    with pytest.raises(ValueError, match="shape"):
        fake_server.request([np.zeros((3,), np.uint8)])
    with pytest.raises(ValueError, match="2 inputs for 1 specs"):
        fake_server.request([np.zeros((4,), np.uint8)] * 2)
    out, = fake_server.request([np.full((4,), 2, np.uint8)])
    np.testing.assert_array_equal(out, np.full((4,), 4.0, np.float32))


def test_soft_error_mid_pipeline_keeps_server_usable(fake_server):
    """One request's error on the daemon's side must not cost the warm
    server: the generator raises for that request, drains the rest, and
    further requests work."""
    batches = [[np.full((4,), i, np.uint8)] for i in (1, 2, 255, 4, 5)]
    got = []
    with pytest.raises(ValueError, match="poisoned"):
        for out, in fake_server.request_many(iter(batches), depth=3):
            got.append(out)
    assert len(got) == 2  # the two requests before the poisoned one
    out, = fake_server.request([np.full((4,), 7, np.uint8)])
    np.testing.assert_array_equal(out, np.full((4,), 14.0, np.float32))


def test_reply_id_mismatch_detected(fake_server):
    # a stale reply answers an id behind the expected one: the client flags
    # the desync instead of returning another request's data
    fake_server._req_id = 5
    with pytest.raises(runner.NativeServerDied, match="out of sync"):
        fake_server.request([np.zeros((4,), np.uint8)])


def test_pipeline_flag_reaches_command_line(tmp_path, monkeypatch):
    _install_fake_runner(
        tmp_path, monkeypatch,
        "import json, sys\n"
        "open(sys.argv[sys.argv.index('--output') + 1] + '.args', 'w')"
        ".write(json.dumps(sys.argv[1:]))\n"
        "sys.stderr.write('ready\\n'); sys.stderr.flush()\n"
        "sys.stdin.read()\n")
    with runner.NativeServer("m.pt2", [((4,), np.uint8)], str(tmp_path / "wd"),
                             device="cpu", pipeline=3) as s:
        args = json.loads(open(os.path.join(s.workdir, "out.args")).read())
    assert args[args.index("--pipeline") + 1] == "3"
    assert args[:2] == ["--package", "m.pt2"] and "--op-library" not in args
    assert args[args.index("--serve-input") + 1] == "u8:4"


def test_daemon_death_mid_pipeline_flags_desync(fake_server):
    """A daemon that dies with requests in flight: NativeServerDied, the
    protocol marked out of sync, no request files left behind."""
    batches = [[np.full((4,), i, np.uint8)] for i in range(8)]
    gen = fake_server.request_many(iter(batches), depth=4)
    next(gen)  # several requests now in flight
    fake_server._proc.kill()
    fake_server._proc.wait()
    with pytest.raises(runner.NativeServerDied):
        list(gen)
    assert fake_server._desync
    with pytest.raises(runner.NativeServerDied):
        fake_server.request([np.zeros((4,), np.uint8)])
    assert _leftovers(fake_server, ("req",)) == []


def test_request_after_close_fails_fast_and_leaks_nothing(fake_server):
    """A write to a closed daemon stdin raises ValueError from the file
    object, the type of a soft error; it must surface as NativeServerDied
    and unlink the request's input files."""
    fake_server.request([np.zeros((4,), np.uint8)])  # healthy first
    fake_server.close()
    with pytest.raises(runner.NativeServerDied):
        fake_server.request([np.zeros((4,), np.uint8)])
    assert _leftovers(fake_server, ("req",)) == []


def test_input_write_failure_does_not_desync_id_counter(fake_server, monkeypatch):
    """An IO failure while writing the input files spends no request id."""
    before = fake_server._req_id
    good = fake_server.workdir
    monkeypatch.setattr(fake_server, "workdir", os.path.join(good, "nope", "nope"))
    with pytest.raises(OSError):
        fake_server.request([np.zeros((4,), np.uint8)])
    monkeypatch.setattr(fake_server, "workdir", good)
    assert fake_server._req_id == before
    out, = fake_server.request([np.arange(4, dtype=np.uint8)])
    np.testing.assert_array_equal(out, np.arange(4, dtype=np.float32) * 2.0)
    assert not fake_server._desync


def test_startup_death_raises(tmp_path, monkeypatch):
    _install_fake_runner(tmp_path, monkeypatch,
                         "import sys\nsys.stderr.write('no package\\n')\nsys.exit(1)\n")
    with pytest.raises(runner.NativeServerDied, match="no package"):
        runner.NativeServer("m.pt2", [((4,), np.uint8)], str(tmp_path / "wd"), device="cpu")


def test_startup_death_after_closing_stderr_raises(tmp_path, monkeypatch):
    """A runner that writes its error, closes stderr and exits only later:
    the EOF comes before the child can be reaped (poll() is still None), and
    the server must still raise, every time, not take the dead child for a
    ready one."""
    _install_fake_runner(tmp_path, monkeypatch,
                         "import os, sys, time\nsys.stderr.write('no package\\n')\n"
                         "sys.stderr.flush()\nos.close(2)\ntime.sleep(0.3)\nsys.exit(1)\n")
    for _ in range(2):
        with pytest.raises(runner.NativeServerDied, match="no package"):
            runner.NativeServer("m.pt2", [((4,), np.uint8)], str(tmp_path / "wd"),
                                device="cpu")


def test_a_cuda_package_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.NativeServer("m.pt2", [((4,), np.uint8)], "unused")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        runner.run_serving("m.pt2", [np.zeros(4, np.uint8)], "unused")


# ---------------------------------------------------------------------------
# NativeTagger and cli.tag --engine native against the JAX package's
# ---------------------------------------------------------------------------

_FAKE_SCORER = r'''
import json, sys
import numpy as np
args = sys.argv[1:]
out_prefix = args[args.index("--output") + 1]
spec = args[args.index("--serve-input") + 1]      # e.g. u8:2,4,40,56,3
dims = [int(d) for d in spec.split(":")[1].split(",")]
sys.stderr.write("ready\n"); sys.stderr.flush()
rid = 0
for line in sys.stdin:
    paths = line.split()
    if not paths:
        continue
    i = rid; rid += 1
    clips = np.fromfile(paths[0], np.uint8).reshape(dims)
    flat = clips.reshape(dims[0], -1)
    out = np.stack([flat.mean(1) / 255.0, flat.min(1) / 255.0,
                    flat.max(1) / 255.0], 1).astype(np.float32)
    f = f"{out_prefix}.req{i}.0"
    out.tofile(f)
    print(json.dumps({"request": i, "outputs": [
        {"file": f, "dtype": "f32", "shape": [dims[0], 3],
         "bytes": int(out.nbytes)}]}), flush=True)
'''

_SCORER_SAMPLER = {"clip_len": 4, "stride": 2, "eval_mode": "dense", "num_eval_clips": 10}


def _scorer_math(clips_u8, nclips):
    """_FAKE_SCORER's scoring function, in-process (a tensor, as the port's
    aggregation takes a chunk's scores)."""
    flat = clips_u8.reshape(clips_u8.shape[0], -1)
    out = np.stack([flat.mean(1) / 255.0, flat.min(1) / 255.0,
                    flat.max(1) / 255.0], 1).astype(np.float32)
    return torch.from_numpy(out[:nclips])


@pytest.fixture
def scorer(tmp_path, monkeypatch, synthetic_dataset):
    """An export-CLI-shaped artifact dir for both packages (meta.json,
    serving.stablehlo, serving.native.pt2 compiled for the CPU), both
    runners pointed at _FAKE_SCORER, the JAX side's C resize tier off, and
    a pack of the synthetic videos at the ship geometry."""
    art = tmp_path / "art"
    art.mkdir()
    (art / "meta.json").write_text(json.dumps({
        "model": "fake", "num_classes": 3, "int8": False,
        "input": {"shape": [2, 4, 40, 56, 3]}, "sampler": _SCORER_SAMPLER,
        "tag_names": ["a", "b", "c"],
        "artifacts": {"native": {"file": serving.NATIVE_PACKAGE, "device": "cpu"}}}))
    (art / "serving.stablehlo").write_text("module {}")
    (art / serving.NATIVE_PACKAGE).write_text("not a package")
    wrapper = _fake_runner(tmp_path, _FAKE_SCORER)
    monkeypatch.setattr(runner, "build_runner", lambda device="cuda": wrapper)
    monkeypatch.setattr(jpjrt, "build_runner", lambda force=False: wrapper)
    monkeypatch.setattr(jpjrt, "default_plugin", lambda: "fake.so")
    monkeypatch.setattr(jpjrt, "plugin_client_options_for", lambda p: {})
    root, list_path = synthetic_dataset  # both sides resize with their C tier
    records = jload_video_list(list_path, root=root)
    pack = str(tmp_path / "lib.fvtpack")
    jwrite_pack(records, pack, (40, 56), root=root)
    return str(art), root, records, pack


@pytest.mark.parametrize("pipeline", [0, 2])
def test_native_tagger_matches_jax(scorer, tmp_path, pipeline):
    """Video scores (streaming decode), pack scores and tags of the port's
    NativeTagger equal the JAX NativeTagger's bit for bit, sequential and
    pipelined; both equal the in-process aggregation of the same scorer."""
    art, root, records, pack = scorer
    scfg = tcfg.ClipSamplerConfig(**_SCORER_SAMPLER)
    with NativeTagger(art, workdir=str(tmp_path / "wd"), pipeline=pipeline,
                      device="cpu") as nt, \
            JNativeTagger(art, workdir=str(tmp_path / "jwd"), plugin="fake.so",
                          client_options={}, pipeline=pipeline) as jt:
        assert nt.tag_names == jt.tag_names == ["a", "b", "c"]
        for rec in records[:2]:
            got = nt.video_scores(rec.path)
            np.testing.assert_array_equal(got, jt.video_scores(rec.path))
            np.testing.assert_array_equal(
                got, stream_video_scores(rec.path, scfg, (40, 56), 3, 2, _scorer_math))
            assert [(r.tag, r.score) for r in nt.tag(rec.path, threshold=0.0)] == \
                [(r.tag, r.score) for r in jt.tag(rec.path, threshold=0.0)]
        piped = dict(nt.iter_pack_scores(pack, root=root))
        want = dict(jt.iter_pack_scores(pack, root=root))
        assert list(piped) == list(want) == [r.path for r in records]
        p = Pack(pack)
        for i, path in enumerate(piped):
            np.testing.assert_array_equal(piped[path], want[path])
            seq = nt.scores_from(lambda idx, _i=i: p.gather(_i, idx),
                                 p.entries[i]["probe_frames"])
            np.testing.assert_array_equal(piped[path], seq)
            np.testing.assert_array_equal(seq, scores_from_frames(
                lambda idx, _i=i: p.gather(_i, idx), p.entries[i]["probe_frames"], scfg,
                (40, 56), 3, 2, _scorer_math))
        # the public pack entry dispatches to the pipelined scores
        tagged = list(iter_pack_tags(nt, pack, threshold=0.0, root=root))
    for path, results in tagged:
        ref = rank_tags(want[path], ["a", "b", "c"], threshold=0.0)
        assert [(r.tag, r.score) for r in results] == [(r.tag, r.score) for r in ref]
    assert not os.listdir(tmp_path / "wd")


def test_cli_tag_native_engine_matches_jax(scorer, capsys):
    """cli.tag --engine native end to end against the fake scoring daemon,
    line for line the JAX CLI's: a pack and a video, the JSON output, the
    engine closed; sampler flags refused, not silently ignored."""
    art, root, records, pack = scorer
    common = ["--engine", "native", "--artifacts", art, "--data-root", root, "--model",
              "tiny3d", "--num-classes", "3", "--multilabel", "--threshold", "0.0"]
    jcli_tag.main([pack, records[0].path] + common)
    want = capsys.readouterr().out.splitlines()
    cli_tag.main([pack, records[0].path] + common + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == len(records) + 1
    lines = [json.loads(line) for line in got]
    assert [r["video"] for r in lines] == [r.path for r in records] + [records[0].path]
    for line in lines:
        assert {t["tag"] for t in line["tags"]} == {"a", "b", "c"}
    for frozen in (["--eval-mode", "uniform"], ["--weights", "w.pt"], ["--clip-batch", "4"]):
        with pytest.raises(SystemExit, match="fixed at export time"):
            cli_tag.main([pack, "--device", "cpu"] + common + frozen)


def test_cli_serve_native_engine(scorer, monkeypatch, capsys):
    """cli.serve --engine native answers a video, a pack and a missing file
    (an error line, the daemon alive after it), as the in-process serve
    loop does; a dead daemon stops the loop (NativeServerDied)."""
    import io

    art, root, records, pack = scorer
    missing = os.path.join(root, "missing.mp4")
    monkeypatch.setattr("sys.stdin", io.StringIO(
        f"{records[0].path}\n{missing}\n" + json.dumps({"video": pack, "top_k": 1}) + "\n"))
    stats = cli_serve.main(["--engine", "native", "--artifacts", art, "--device", "cpu",
                            "--threshold", "0.0", "--data-root", root])
    assert stats == {"served": 2, "errors": 1}
    captured = capsys.readouterr()
    assert "ready" in captured.err
    lines = [json.loads(line) for line in captured.out.splitlines()]
    assert len(lines) == 2 + len(records) and "error" in lines[1]
    assert [r["video"] for r in lines[2:]] == [r.path for r in records]
    assert all(len(r["tags"]) == 1 for r in lines[2:])
    with NativeTagger(art, device="cpu") as nt:
        nt.server._proc.kill()
        nt.server._proc.wait()
        out = io.StringIO()
        with pytest.raises(runner.NativeServerDied):
            cli_serve.serve(nt, [records[0].path + "\n", records[1].path + "\n"], out)
        assert out.getvalue() == ""


def test_native_tagger_needs_an_artifact_dir_of_its_device(scorer, tmp_path):
    art = scorer[0]
    with pytest.raises(FileNotFoundError, match="cli.export"):
        NativeTagger(str(tmp_path), device="cpu")
    if not torch.cuda.is_available():  # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            NativeTagger(art)
    meta = json.load(open(os.path.join(art, "meta.json")))
    meta["artifacts"]["native"]["device"] = "cuda"
    json.dump(meta, open(os.path.join(art, "meta.json"), "w"))
    with pytest.raises(ValueError, match="compiled for 'cuda'"):
        NativeTagger(art, device="cpu")


# ---------------------------------------------------------------------------
# export_serving_native of the 'cuda'-route program, through AOTInductor
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def native_packages(tmp_path_factory):
    """r2plus1d_18 (its kernels='cuda' route, bf16) at a 4x32x32 clip:
    AOTInductor packages of the bf16 program and of the int8 engine, static
    and dynamic, exported on the CPU, with the eager serving fns."""
    d = tmp_path_factory.mktemp("native")
    cfg = tcfg.ExperimentConfig(
        model=tcfg.ModelConfig(name="r2plus1d_18", num_classes=5, multilabel=True,
                               dropout=0.0),
        data=tcfg.DataConfig(source_hw=(40, 48), resize_hw=(36, 40), crop_hw=(32, 32),
                             sampler=tcfg.ClipSamplerConfig(clip_len=4)))
    sd = get_model("r2plus1d_18", num_classes=5, device="cpu",
                   generator=torch.Generator().manual_seed(0)).state_dict()
    clips = np.random.default_rng(1).integers(0, 256, (2, 4, 40, 48, 3), dtype=np.uint8)
    qpack = serving.quantize_for_serving(cfg, sd, [clips], device="cpu")
    out = {}
    for name, qp, dyn in (("bf16", None, None), ("int8", qpack, False),
                          ("int8_dynamic", qpack, True)):
        path = serving.export_serving_native(cfg, sd, 2, str(d / f"{name}.pt2"), qpack=qp,
                                             device="cpu", dynamic=dyn)
        out[name] = (path, serving.ServingFn(cfg, sd, qpack=qp, device="cpu", dynamic=dyn))
    return out, clips


# fvt op calls a forward of the int8 engine, at any clip: (Q1, Q2, Q2's amax pass)
NATIVE_INT8 = {"int8": (28, 1, 0), "int8_dynamic": (28, 26, 1)}


@pytest.mark.parametrize("engine", ["bf16", "int8", "int8_dynamic"])
def test_native_package_runs_the_fvt_ops(native_packages, engine, monkeypatch):
    """The package calls each fvt op as an extern kernel, as often as the
    eager forward does (their plain versions counted: K1 / K2 at the sites
    this 4x32x32 clip leaves them, none in the int8 engine's stage 4 here,
    28 Q1 and 1 or 26 + 1 Q2 calls), and
    its scores are the eager ServingFn's within the serving tolerance, 5e-2
    (the same plain kernels, but Inductor's fused bf16 glue, the
    preprocess and eval BatchNorm, rounds at other places than the eager
    f32 chain: 3.4e-3 at most here)."""
    packages, clips = native_packages
    path, fn = packages[engine]
    counts = [0] * 5

    def counted(i, plain):
        def call(*args):
            counts[i] += 1
            if i == 3 and args[2] is None and args[3] is None:  # Q2's amax pass
                counts[4] += 1
            return plain(*args)
        return call

    for i, (mod, name) in enumerate(((k12, "spatial_conv_plain"), (k12, "temporal_conv_plain"),
                                     (q8, "conv3d_s8_plain"), (q8, "quantize_s8_plain"))):
        monkeypatch.setattr(mod, name, counted(i, getattr(mod, name)))
    run = torch._inductor.aoti_load_package(path)
    x = torch.from_numpy(clips)
    with torch.no_grad():
        want = fn(x)
    eager = tuple(counts)
    counts[:] = [0] * 5
    got = run(x)
    assert tuple(counts) == eager
    # the int8 engine's bf16 stage 4 is 1x2x2 at this clip: F.conv3d, not K1 / K2
    assert (eager[0] > 0 and eager[1] > 0) == (engine == "bf16")
    assert eager[2:] == NATIVE_INT8.get(engine, (0, 0, 0))
    assert got.shape == (2, 5) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=5e-2)
