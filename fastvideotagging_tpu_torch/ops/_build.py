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

The native serving tier builds against the installed libtorch with ``g++``
(flags from ``torch.utils.cpp_extension``): ``build_op_library()`` the op
library ``libfvt_ops-<hash>.so`` (csrc/fvt_ops.cpp, the ``fvt::*`` ops for
the card, linked with the kernel libraries it calls) and
``build_runner(device)`` the runner ``fvt_native_runner-<device>-<hash>``
(csrc/native_runner.cpp; ``'cpu'`` or ``'cuda'``), keyed like the kernels on
a hash of their sources, flags and torch version. ``build_native()`` starts
both card builds at once. A missing compiler or a failed build raises.

The host data plane (csrc/framepack.c, a plain C interface bound by
``native/__init__.py``) is built by ``build_framepack()`` with the system C
compiler and the JAX package's flags for it (``FRAMEPACK_FLAGS``), into
``libfvt_framepack-<hash>.so``, the hash over the source, the flags, the
torch version and the host CPU (``-march=native`` code runs only where it
was built).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib
import os
import platform
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
_native_lock = threading.Lock()  # the native tier's g++ builds
_host_lock = threading.Lock()  # the host data plane's cc build
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


def _run_builds(jobs: dict) -> None:
    """Run ``{label: (cmd, out_path)}`` in parallel, each into a temporary
    file renamed over ``out_path`` when it succeeds; the compiler's output
    goes to ``_logs[label]``; raises with that of each build that failed."""
    procs = {}
    for label, (cmd, out) in jobs.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[label] = (subprocess.Popen([*cmd, "-o", tmp], stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp, out)
    errors = []
    for label, (proc, tmp, out) in procs.items():
        try:
            log, _ = proc.communicate(timeout=_BUILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            log = "timed out"
        _logs[label] = log
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            errors.append(f"building {label} failed:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def _nvcc_job(name: str) -> tuple[tuple[str, ...], str]:
    return (_nvcc(), *_flags(name), os.path.join(CSRC, name + ".cu")), _so_path(name)


def _build(names: list[str]) -> None:
    """Build the kernel libraries of ``names`` that are not built yet, one
    nvcc each, in parallel (under ``_lock``)."""
    todo = {n: _nvcc_job(n) for n in names if not os.path.exists(_so_path(n))}
    for n in names:
        if n not in todo:
            _logs.setdefault(n, "(cached build)")
    if todo:
        os.makedirs(BUILD_DIR, exist_ok=True)
        _run_builds(todo)


def build_all() -> dict[str, str]:
    """Build every ``csrc/*.cu`` in parallel; returns {name: ptxas report}."""
    with _lock:
        names = sources()
        _build(names)
        return {n: _logs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            _build([name])
            _libs[name] = ctypes.CDLL(_so_path(name))
        return _libs[name]


# ---------------------------------------------------------------------------
# The native serving tier: the op library and the runner, against libtorch
# ---------------------------------------------------------------------------

CXX_FLAGS = ("-O2", "-std=c++20", "-fPIC", "-Wall", "-Wno-unused-function")
# the kernel libraries the op library calls (their C entry points)
OP_KERNELS = ("spatial_conv", "int8_conv")


def _gxx() -> str:
    cand = shutil.which("g++")
    if cand is None:
        raise RuntimeError("g++ not found (PATH); the native runner and the op library "
                           "cannot be built on this machine")
    return cand


def _cuda_home() -> str:
    """The CUDA toolkit of the nvcc that builds the kernels (raises as
    ``_nvcc`` does where there is none)."""
    return os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))


def _torch_flags(cuda: bool) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(compile flags, link flags) for a C++ file built against the
    installed torch: its headers, its C++ ABI, its libraries (the CUDA ones
    with ``cuda``), each linked even where no symbol of it is referenced, so
    that its static registrars run (the CUDA backend, the dispatcher's
    kernels)."""
    import torch
    from torch.utils import cpp_extension

    lib = cpp_extension.library_paths()[0]
    compile_flags = (*CXX_FLAGS, f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
                     *(f"-I{p}" for p in cpp_extension.include_paths()),
                     *((f"-I{os.path.join(_cuda_home(), 'include')}",) if cuda else ()))
    # the CUDA runtime is the one libc10_cuda was built with (a wheel's own),
    # taken through libc10_cuda's dependencies: c10's inline event code
    # calls it
    libs = ("-Wl,--copy-dt-needed-entries", "-ltorch_cuda", "-lc10_cuda") if cuda else ()
    link_flags = (f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed", *libs, "-ltorch",
                  "-ltorch_cpu", "-lc10", "-Wl,--as-needed", "-ldl", "-pthread")
    return compile_flags, link_flags


def _keyed(stem: str, sources: tuple[str, ...], flags: tuple[str, ...], suffix: str = "") -> str:
    """``_build/<stem>-<hash><suffix>``, the hash over the sources, the flags
    and the torch version."""
    import torch

    digest = hashlib.sha256(" ".join(flags).encode() + torch.__version__.encode())
    for src in sources:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}{suffix}")


def _native_sources(main: str) -> tuple[str, ...]:
    return tuple(os.path.join(CSRC, f) for f in (main, "plans.h", "fvt_schemas.inc"))


def _op_library_job() -> tuple[tuple[str, ...], str]:
    kernels = tuple(_so_path(name) for name in OP_KERNELS)
    compile_flags, link_flags = _torch_flags(cuda=True)
    flags = (*compile_flags, "-shared", os.path.join(CSRC, "fvt_ops.cpp"), *kernels,
             f"-Wl,-rpath,{BUILD_DIR}", *link_flags)
    return (_gxx(), *flags), _keyed("libfvt_ops", _native_sources("fvt_ops.cpp"), flags, ".so")


def _runner_job(device: str) -> tuple[tuple[str, ...], str]:
    if device not in ("cpu", "cuda"):
        raise ValueError(f"the runner is built for 'cpu' or 'cuda', not {device!r}")
    cuda = device == "cuda"
    compile_flags, link_flags = _torch_flags(cuda)
    flags = (*compile_flags, *(("-DFVT_RUNNER_CUDA",) if cuda else ()),
             os.path.join(CSRC, "native_runner.cpp"), *link_flags)
    return (_gxx(), *flags), _keyed(f"fvt_native_runner-{device}",
                                    _native_sources("native_runner.cpp"), flags)


def _build_native(jobs: dict, kernels: tuple[str, ...] = ()) -> dict[str, str]:
    """Build each ``{label: (cmd, path)}`` of ``jobs`` where needed, after
    the kernel libraries it links (``kernels``); under a lock of its own, so
    that a build in a thread does not hold up the kernels' loads."""
    with _native_lock:
        if kernels:
            with _lock:
                _build(list(kernels))
        todo = {label: job for label, job in jobs.items() if not os.path.exists(job[1])}
        if todo:
            os.makedirs(BUILD_DIR, exist_ok=True)
            _run_builds(todo)
        return {label: out for label, (_, out) in jobs.items()}


def build_op_library() -> str:
    """The op library's path (csrc/fvt_ops.cpp), building it if needed."""
    return _build_native({"libfvt_ops": _op_library_job()}, OP_KERNELS)["libfvt_ops"]


def build_runner(device: str = "cuda") -> str:
    """The runner's path for ``device`` ('cpu' or 'cuda'), building it if
    needed."""
    return _build_native({"runner": _runner_job(device)})["runner"]


def build_native() -> dict[str, str]:
    """The op library and the CUDA runner, built at once where needed;
    {label: path}. Their compiler output is in ``_logs`` under the labels."""
    return _build_native({"libfvt_ops": _op_library_job(), "runner-cuda": _runner_job("cuda")},
                         OP_KERNELS)


# ---------------------------------------------------------------------------
# The host data plane: csrc/framepack.c with the system C compiler
# ---------------------------------------------------------------------------

# The JAX package's flags for framepack.c. Keep them: -march=native lets gcc
# contract the resize's lerps into fused multiply-adds, and the port's resize
# equals the JAX package's bit for bit only when both round there.
FRAMEPACK_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")


def _cc() -> str:
    for name in ("cc", "gcc", "clang"):
        cand = shutil.which(name)
        if cand is not None:
            return cand
    raise RuntimeError("no C compiler (cc, gcc or clang on PATH); the host data plane "
                       "(csrc/framepack.c) cannot be built on this machine")


def _host_cpu() -> str:
    """The host CPU's model and feature flags (from /proc/cpuinfo where there
    is one): a ``-march=native`` build's key."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = sorted({line for line in f if line.startswith(("model name", "flags"))})
    except OSError:
        lines = [platform.processor()]
    return hashlib.sha256("".join(lines).encode()).hexdigest()[:16]


def build_framepack() -> str:
    """The host data plane's shared library (csrc/framepack.c), building it
    if needed; raises when there is no C compiler or the build fails."""
    src = os.path.join(CSRC, "framepack.c")
    out = _keyed("libfvt_framepack", (src,), (*FRAMEPACK_FLAGS, "-lm", _host_cpu()), ".so")
    with _host_lock:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            _run_builds({"framepack": ((_cc(), *FRAMEPACK_FLAGS, src, "-lm"), out)})
    return out
