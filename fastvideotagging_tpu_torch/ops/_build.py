"""nvcc build and ctypes loader for the hand-written kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, on first use,
into ``fastvideotagging_tpu_torch/_build/lib<name>-<hash>.so`` for
``sm_90a``; the hash covers the source and the flags, so an edited source
rebuilds and an unchanged one is reused. Nothing is built when the package
is imported: a missing ``nvcc`` or a failed build raises when a CUDA tensor
first reaches a kernel wrapper (or when ``build_all`` is called).

A source whose tile plan lives in its Python wrapper (``_PLANNED``) is
compiled with the wrapper's ``NVCC_DEFINES`` as well, so that the plan the
wrapper sizes its launches with is the one the kernel is built with.

``build_all()`` starts one nvcc per source, all at once, and returns each
build's ``-Xptxas -v`` report (registers, shared memory, spills).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_BUILD_TIMEOUT_S = 600
# source -> the wrapper module whose NVCC_DEFINES (its tile plan) it takes
_PLANNED = {"fused_block": "fastvideotagging_tpu_torch.ops.fused_block",
            "spatial_conv": "fastvideotagging_tpu_torch.ops.conv2plus1d",
            "temporal_dw": "fastvideotagging_tpu_torch.ops.conv2plus1d"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(cand):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin); the CUDA kernels cannot be "
            "built on this machine")
    return cand


def _flags(name: str) -> tuple[str, ...]:
    module = _PLANNED.get(name)
    return NVCC_FLAGS + (importlib.import_module(module).NVCC_DEFINES if module else ())


def _so_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def _start(name: str):
    """Start nvcc for one source; None when the library is already built."""
    so = _so_path(name)
    if os.path.exists(so):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_flags(name), "-o", tmp, os.path.join(CSRC, name + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, so


def _finish(name: str, started) -> None:
    if started is None:
        _logs.setdefault(name, "(cached build)")
        return
    proc, tmp, so = started
    try:
        out, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise RuntimeError(f"nvcc timed out building {name}.cu")
    _logs[name] = out
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{out}")
    os.replace(tmp, so)


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` in parallel; returns {name: ptxas report}."""
    with _lock:
        started = {n: _start(n) for n in sources()}
        errors = []
        for n, s in started.items():
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        return {n: _logs[n] for n in started}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _finish(name, _start(name))
            _libs[name] = ctypes.CDLL(_so_path(name))
        return _libs[name]
