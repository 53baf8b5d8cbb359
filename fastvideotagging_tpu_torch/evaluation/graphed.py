"""Captured CUDA graphs at the serving boundaries: the port's counterpart of
``jax.jit`` there.

The JAX package compiles each serving forward once per input shape
(``evaluation/quantized.py``'s int8 engine, built once with the qpack
traced; the tagger's and the serving function's ``jax.jit``) and runs it
as one dispatch. The port's forwards are an eager Python walk of tens to
hundreds of kernel launches, and where the card finishes them faster than
the host issues them the wall time follows the host. ``Graphed`` wraps a
forward ``fn(*args)`` (tensors, or dicts, lists and tuples of them, such as
a qpack) and replays it as one CUDA graph per input signature, as
``jax.jit`` caches one executable per abstract signature:

* The signature is the arguments' tree structure and each leaf's shape,
  dtype and device.
* The first call of a signature runs ``fn`` eagerly on a side stream (the
  warm-up: the kernels build, their plans are made and the tensor-map
  encoder is looked up; its result is the call's result), then captures
  ``fn`` on static copies of the arguments, keeps the static inputs and
  outputs, and records the launches one captured forward makes on the hand
  kernels' counters (the capture itself launches nothing, so it leaves the
  counters as they were).
* Every later call copies each leaf into its static buffer, replays the
  graph, adds the recorded launches to the counters (so they stay those of
  the eager walk) and returns a clone of the output, enqueued on the
  current stream: the next replay overwrites the static output. A leaf
  whose storage is its static buffer is not copied; nor is a leaf of a
  ``reused`` argument (a qpack served over many chunks) that is the tensor
  copied there last, unmodified since (its version counter; an inference
  tensor has none and counts as unmodified while it is the same tensor).
* A capture that fails raises, naming the forward and the step; nothing
  falls back to the eager walk.

On the CPU (every leaf on the host) ``Graphed`` calls ``fn`` directly.
Every call runs under ``torch.inference_mode``: these are serving
forwards. To reach the eager walk on the card, call the wrapped function
(``Graphed.fn``) or the model itself.
"""

from __future__ import annotations

import torch

from fastvideotagging_tpu_torch.ops import conv2plus1d, int8_conv

# the serving kernels' launch counters (K1-K4; Q1, Q2): each wrapper adds one
# where it launches
COUNTERS = (conv2plus1d.launch_counts, int8_conv.launch_counts)


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` in order -> its structure."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        return ("d", tuple(tree), tuple(_flatten(v, leaves) for v in tree.values()))
    if type(tree) in (list, tuple):
        return (type(tree), tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"a graphed forward takes tensors and dicts, lists and tuples of them, "
                    f"not {type(tree).__name__}")


def _unflatten(spec, leaves):
    """The tree of ``spec`` with its tensors taken in order from the iterator
    ``leaves``."""
    if spec is None:
        return next(leaves)
    if spec[0] == "d":
        return {k: _unflatten(s, leaves) for k, s in zip(spec[1], spec[2])}
    return spec[0](_unflatten(s, leaves) for s in spec[1])


def _counts() -> list[dict]:
    return [dict(c) for c in COUNTERS]


def _version(t: torch.Tensor):
    return None if t.is_inference() else t._version


class _Capture:
    """One captured forward: the graph, its static inputs and output, which
    leaves belong to reused arguments, and the launches a replay makes."""

    def __init__(self, graph, static, out_spec, out_leaves, reused, launches):
        self.graph = graph
        self.static = static
        self.out_spec, self.out_leaves = out_spec, out_leaves
        self.reused = reused
        self.launches = launches
        self.last = [None] * len(static)  # (source, its version) copied last, reused leaves

    def replay(self, leaves):
        dst, src = [], []
        for i, (x, buf) in enumerate(zip(leaves, self.static)):
            if x.data_ptr() == buf.data_ptr():
                continue
            if self.reused[i]:
                last = self.last[i]
                if last is not None and last[0] is x and last[1] == _version(x):
                    continue
                self.last[i] = (x, _version(x))
            dst.append(buf)
            src.append(x)
        if dst:
            torch._foreach_copy_(dst, src)
        self.graph.replay()
        for counter, added in zip(COUNTERS, self.launches):
            for k, n in added.items():
                counter[k] += n
        return _unflatten(self.out_spec, iter([t.clone() for t in self.out_leaves]))


class Graphed:
    """``fn(*args)`` replayed as one captured CUDA graph per input signature
    on the card, called directly on the CPU (the module docstring).

    ``name`` names the forward in a capture's error; ``reused``: the
    positions of arguments that callers pass again unchanged (a qpack),
    copied into their static buffers only when they change."""

    def __init__(self, fn, name: str, reused: tuple[int, ...] = ()):
        self.fn = fn
        self.name = name
        self.reused = frozenset(reused)
        self._captures: dict = {}

    @property
    def captures(self) -> int:
        """Signatures captured so far (one graph each)."""
        return len(self._captures)

    def __call__(self, *args):
        with torch.inference_mode():
            leaves: list = []
            flags: list = []
            specs = []
            for i, a in enumerate(args):
                n = len(leaves)
                specs.append(_flatten(a, leaves))
                flags += [i in self.reused] * (len(leaves) - n)
            if not leaves or not any(t.is_cuda for t in leaves):
                return self.fn(*args)
            spec = tuple(specs)
            key = (spec, tuple((tuple(t.shape), t.dtype, t.device) for t in leaves))
            cap = self._captures.get(key)
            if cap is None:
                return self._capture(key, spec, args, leaves, flags)
            return cap.replay(leaves)

    def _step_failed(self, step: str, key, err: Exception) -> RuntimeError:
        shapes = [tuple(s) for s, _, _ in key[1]][:4]
        return RuntimeError(f"{self.name}: the CUDA graph's {step} failed for inputs "
                            f"{shapes}{' ...' if len(key[1]) > 4 else ''}: "
                            f"{type(err).__name__}: {err}")

    def _capture(self, key, spec, args, leaves, flags):
        dev = next(t.device for t in leaves if t.is_cuda)
        current = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                out = self.fn(*args)
        except Exception as e:
            raise self._step_failed("warm-up (the eager forward before the capture)", key,
                                    e) from e
        current.wait_stream(side)
        out_leaves: list = []
        _flatten(out, out_leaves)
        for t in out_leaves:
            if t.is_cuda:
                t.record_stream(current)
        static = [t.clone() for t in leaves]
        it = iter(static)
        static_args = tuple(_unflatten(s, it) for s in spec)
        graph = torch.cuda.CUDAGraph()
        before = _counts()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = self.fn(*static_args)
        except Exception as e:
            raise self._step_failed("capture", key, e) from e
        finally:
            after = _counts()
            for counter, saved in zip(COUNTERS, before):
                counter.update(saved)  # a capture records launches, it makes none
        launches = [{k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}
                    for a, b in zip(after, before)]
        static_leaves: list = []
        out_spec = _flatten(static_out, static_leaves)
        self._captures[key] = cap = _Capture(graph, static, out_spec, static_leaves, flags,
                                             launches)
        for i, x in enumerate(leaves):
            if flags[i]:
                cap.last[i] = (x, _version(x))
        return out
