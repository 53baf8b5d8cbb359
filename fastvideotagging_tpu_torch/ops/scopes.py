"""Profiler scopes that name the layer a kernel launch belongs to.

utils/step_profiler.py joins each device kernel of a ``torch.profiler``
trace to the innermost of these scopes around its launch: ``fvt/<role>/<path>``
for a conv site (role ``fwd``, ``dx``, ``dw``, ``bwd`` for a backward that
computes both, or ``quant`` for the int8 engine's quantize pass; ``path``
the module path or the int8 engine's conv id), and ``fvt/<region>`` for a
stretch of a step (``preprocess``, ``optimizer``).

Scopes are off unless a profiler turns them on (``recording``); off, each
call here reads one flag and opens nothing. The flag is process-wide,
since a CUDA backward runs on the autograd engine's own thread; the
current site path is per thread.
"""

from __future__ import annotations

import contextlib
import threading

import torch

PREFIX = "fvt/"
SITE_ROLES = ("fwd", "dx", "dw", "bwd", "quant")


class _Flag:
    on = 0


_flag = _Flag()
_local = threading.local()


@contextlib.contextmanager
def recording():
    """Turn the scopes on while the block runs."""
    _flag.on += 1
    try:
        yield
    finally:
        _flag.on -= 1


def active() -> bool:
    return _flag.on > 0


def current_path() -> str | None:
    """The path of the innermost conv site open on this thread, or None."""
    return getattr(_local, "path", None)


@contextlib.contextmanager
def site(role: str, path: str | None):
    """``fvt/<role>/<path>`` around the block, with ``path`` this thread's
    current site; nothing when the scopes are off or ``path`` is None."""
    if not active() or path is None:
        yield
        return
    prev = current_path()
    _local.path = path
    try:
        with torch.profiler.record_function(f"{PREFIX}{role}/{path}"):
            yield
    finally:
        _local.path = prev


@contextlib.contextmanager
def region(name: str):
    """``fvt/<name>`` around the block, when the scopes are on."""
    if not active():
        yield
        return
    with torch.profiler.record_function(PREFIX + name):
        yield


def parse(name: str):
    """('site', role, path) or ('region', name, None) of a scope's name;
    None for any other event."""
    if not name.startswith(PREFIX):
        return None
    rest = name[len(PREFIX):]
    role, sep, path = rest.partition("/")
    if sep and role in SITE_ROLES:
        return "site", role, path
    return "region", rest, None
