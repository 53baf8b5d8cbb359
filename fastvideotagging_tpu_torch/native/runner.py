"""Build and drive the native serving runner (the counterpart of
``fastvideotagging_tpu/native/pjrt.py``).

The runner (csrc/native_runner.cpp, built by ops/_build.py against the
installed libtorch) is the no-Python deployment tier: it loads the
serving program's AOTInductor package (``serving.native.pt2`` of
``evaluation.serving.export_serving_native``) and executes it on raw input
files. A CUDA package calls the hand kernels through the ``fvt::*`` ops, so
the CUDA runner is given the C++ op library (csrc/fvt_ops.cpp); the CPU
runner serves CPU packages. ``run_serving`` runs it once; ``NativeServer``
keeps it warm behind a stdin / stdout line protocol, the tier behind
``cli.serve --engine native``. Nothing here imports the model: the Python
side writes input files and reads one JSON line a request.

The reference's PJRT knobs (``--plugin``, ``--client-option``,
``--compile-options``, ``make_compile_options``) have no counterpart: the
package holds the compiled program, and libtorch needs no plugin.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
from collections import deque

import numpy as np

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.ops import _build

_DTYPES = {"u8": np.uint8, "s32": np.int32, "f32": np.float32, "s8": np.int8,
           "pred": np.bool_}


def build_runner(device: str = "cuda") -> str:
    """The runner binary for packages of ``device`` ('cpu' or 'cuda'),
    built on first use (ops/_build.py; raises without a compiler)."""
    return _build.build_runner(device)


def _command(package_path: str, device) -> list[str]:
    """The runner's command line for a package of ``device`` (the card
    unless the caller asks for the CPU; raises without a card): the CUDA
    runner with the op library, or the CPU runner."""
    dev = resolve_device(device).type
    cmd = [build_runner(dev), "--package", package_path]
    if dev == "cuda":
        cmd += ["--op-library", _build.build_op_library()]
    return cmd


def _dtype_tag(arr: np.ndarray) -> str:
    for tag, dt in _DTYPES.items():
        if arr.dtype == dt:
            return tag
    raise TypeError(f"unsupported input dtype {arr.dtype}")


def run_summary(package_path: str, inputs: list[np.ndarray], workdir: str,
                device: str = "cuda", timeout: int = 600, bench: int = 1) -> dict:
    """Execute a serving package once in the native runner process; returns
    the runner's summary: ``outputs`` (loaded as numpy arrays), ``launches``
    (the op library's counts; None from the CPU runner) and, with ``bench``
    > 1, ``bench`` (each input array then carries a leading instance axis of
    that size, distinct contents per instance, and the runner reports a
    two-point-slope time an execution)."""
    cmd = _command(package_path, device)
    os.makedirs(workdir, exist_ok=True)
    cmd += ["--output", os.path.join(workdir, "out")]
    if bench > 1:
        cmd += ["--bench", str(bench)]
    for i, arr in enumerate(inputs):
        arr = np.ascontiguousarray(arr)
        path = os.path.join(workdir, f"in{i}.bin")
        arr.tofile(path)
        dims = ",".join(str(d) for d in (arr.shape[1:] if bench > 1 else arr.shape))
        cmd += ["--input", f"{_dtype_tag(arr)}:{dims}:{path}"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"native runner failed (rc={proc.returncode}):\n{proc.stderr}")
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    summary["outputs"] = _load_outputs(summary["outputs"])
    return summary


def run_serving(package_path: str, inputs: list[np.ndarray], workdir: str,
                device: str = "cuda", timeout: int = 600, bench: int = 1):
    """Execute a serving package once in the native runner process; returns
    the program outputs as numpy arrays, or ``(outputs, bench_dict)`` with
    ``bench`` > 1 (``run_summary``)."""
    summary = run_summary(package_path, inputs, workdir, device=device, timeout=timeout,
                          bench=bench)
    if bench > 1:
        return summary["outputs"], summary.get("bench")
    return summary["outputs"]


class NativeServerDied(RuntimeError):
    """The runner's ``--serve`` child exited; the server is unusable.

    Raised instead of a plain RuntimeError so request-loop callers
    (cli.serve) can fail fast: a dead daemon would otherwise turn every
    remaining request of a backfill into an error line."""


def _load_outputs(entries) -> list[np.ndarray]:
    outs = []
    for o in entries:
        dt = _DTYPES.get(o["dtype"])
        if dt is None:
            raise TypeError(f"runner returned unsupported dtype {o['dtype']}")
        outs.append(np.fromfile(o["file"], dtype=dt).reshape(o["shape"]))
    return outs


class NativeServer:
    """Long-running native serving daemon over ``fvt_native_runner --serve``.

    Loads the serving package once in a no-Python child process, then
    answers requests over a stdin / stdout line protocol: the deployment
    tier behind ``cli.serve --engine native``. Python only writes raw input
    files and parses one JSON line a request; the device work (staging,
    the program, readback) happens in the C++ runner.

        with NativeServer(package, [((2, 4, 40, 56, 3), np.uint8)], wd) as s:
            scores, = s.request([clips_u8])

    ``launches`` holds the op library's launch counts of the last reply
    (None from the CPU runner, which has no op library).
    """

    def __init__(self, package_path: str, specs, workdir: str, device: str = "cuda",
                 ready_timeout: float = 600.0, pipeline: int = 0):
        cmd = _command(package_path, device)
        os.makedirs(workdir, exist_ok=True)
        self.workdir = workdir
        self.specs = [(tuple(shape), np.dtype(dt)) for shape, dt in specs]
        self.pipeline = int(pipeline)
        self.launches = None
        self._req_id = 0
        self._desync = False
        cmd += ["--serve", "--output", os.path.join(workdir, "out")]
        if self.pipeline > 0:
            cmd += ["--pipeline", str(self.pipeline)]
        for shape, dt in self.specs:
            tag = _dtype_tag(np.empty((0,), dt))
            cmd += ["--serve-input", f"{tag}:{','.join(str(d) for d in shape)}"]
        self._proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)
        # stderr drains on a thread (load logs may precede "ready"). The
        # event unblocks the wait on "ready" or on EOF; ``_saw_ready`` says
        # which. A child that closed stderr may not have been reaped yet
        # (poll() is still None), so EOF without "ready" is a death, not a
        # start.
        self._ready = threading.Event()
        self._saw_ready = False
        self._stderr: list[str] = []

        def _drain():
            for line in self._proc.stderr:
                if line.strip() == "ready":
                    self._saw_ready = True
                    self._ready.set()
                else:
                    self._stderr.append(line)
            self._ready.set()  # EOF: unblock waiters (startup failure)

        self._drainer = threading.Thread(target=_drain, daemon=True)
        self._drainer.start()
        deadline = time.monotonic() + ready_timeout
        while not self._ready.wait(timeout=min(1.0, ready_timeout)):
            if time.monotonic() > deadline:
                self.close()
                raise TimeoutError("native server never became ready")
        if not self._saw_ready or self._proc.poll() is not None:
            self._drainer.join(timeout=5)
            try:
                self._proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass  # closed stderr but lives on: close() kills it
            self.close()
            raise NativeServerDied("native server died during startup:\n"
                                   + "".join(self._stderr))

    @property
    def pid(self) -> int:
        return self._proc.pid

    def _submit(self, inputs) -> tuple[int, list[str]]:
        """Write one request's input files and stdin line; returns (request
        id, file paths). Delete the files only after the matching reply:
        the daemon reads them when it stages the request, which in
        pipelined mode can happen well after the write."""
        if self._desync:
            raise NativeServerDied(
                "native server protocol is out of sync (an earlier reply was lost or "
                "mismatched); close() and start a fresh server")
        if len(inputs) != len(self.specs):
            raise ValueError(f"{len(inputs)} inputs for {len(self.specs)} specs")
        # Validate everything before the request id is allocated or any
        # file is written: a client-side ValueError must leave the line
        # protocol untouched (ids are matched against replies).
        arrays = []
        for i, (arr, (shape, dt)) in enumerate(zip(inputs, self.specs)):
            arr = np.ascontiguousarray(arr, dtype=dt)
            if arr.shape != shape:
                raise ValueError(f"input {i} shape {arr.shape} != spec {shape}")
            arrays.append(arr)
        rid = self._req_id  # consumed only once the input files exist: an IO
        # failure here must not desync the id counter from the daemon's line
        # counter (it never sees this request)
        paths = []
        try:
            for i, arr in enumerate(arrays):
                path = os.path.join(self.workdir, f"req{rid}_in{i}.bin")
                arr.tofile(path)
                paths.append(path)
        except OSError:
            for p in paths:
                if os.path.exists(p):
                    os.unlink(p)
            raise
        self._req_id += 1
        try:
            self._proc.stdin.write(" ".join(paths) + "\n")
            self._proc.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            # ValueError: a write on a closed stdin (after close()), the same
            # type _read_reply uses for a soft error of one request, so it
            # becomes NativeServerDied here: a backfill loop would otherwise
            # retry every request against a closed server
            for p in paths:
                os.unlink(p)
            self._desync = True  # dead server: unusable either way
            raise NativeServerDied("native server exited or is closed:\n"
                                   + "".join(self._stderr))
        return rid, paths

    def _read_reply(self, rid: int, paths: list[str]) -> list[np.ndarray]:
        """Read the reply for request ``rid``; cleans up its input files."""
        try:
            line = self._proc.stdout.readline()
        finally:
            for p in paths:
                if os.path.exists(p):
                    os.unlink(p)
        if not line:
            self._desync = True  # dead server: unusable either way
            raise NativeServerDied("native server exited:\n" + "".join(self._stderr))
        reply = json.loads(line)
        if reply.get("request") != rid:
            self._desync = True
            raise NativeServerDied(
                f"native server reply out of sync: expected request {rid}, got "
                f"{reply.get('request')}")
        if "error" in reply:
            raise ValueError(f"native server request failed: {reply['error']}")
        self.launches = reply.get("launches")
        outs = _load_outputs(reply["outputs"])
        for o in reply["outputs"]:
            os.unlink(o["file"])
        return outs

    def request(self, inputs) -> list[np.ndarray]:
        """One synchronous request: arrays in (matching specs) -> outputs."""
        return self._read_reply(*self._submit(inputs))

    def request_many(self, batches, depth: int | None = None):
        """Pipelined requests: yields each batch's outputs in order while
        keeping up to ``depth`` requests in flight (default: the daemon's
        --pipeline stage-ahead + 1 executing, or 2). With a plain daemon
        this overlaps host-side framing with device work; with ``pipeline >
        0`` the daemon also overlaps the staging of request N+k with the
        execution of request N.

        The daemon's fault isolation per request survives pipelining: if a
        reply raises (a soft daemon error) or the consumer abandons the
        generator, the remaining in-flight replies are drained (blocking
        reads, errors swallowed) so the line protocol stays in sync and the
        server stays usable."""
        depth = depth if depth is not None else max(2, self.pipeline + 1)
        if depth < 1:
            raise ValueError(f"depth must be >= 1 (got {depth})")
        inflight: deque[tuple[int, list[str]]] = deque()
        try:
            for batch in batches:
                if len(inflight) >= depth:
                    rid, paths = inflight.popleft()
                    yield self._read_reply(rid, paths)
                inflight.append(self._submit(batch))
            while inflight:
                rid, paths = inflight.popleft()
                yield self._read_reply(rid, paths)
        finally:
            while inflight:
                rid, paths = inflight.popleft()
                try:
                    self._read_reply(rid, paths)
                except ValueError:
                    pass  # a soft error of one request; the protocol is in sync
                except NativeServerDied:
                    self._desync = True  # dead or mismatched: unusable
                    for _rid, ps in inflight:
                        for p in ps:
                            if os.path.exists(p):
                                os.unlink(p)
                    break

    def close(self) -> None:
        if self._proc.poll() is None:
            try:
                self._proc.stdin.close()
                self._proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self._proc.kill()
                self._proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
