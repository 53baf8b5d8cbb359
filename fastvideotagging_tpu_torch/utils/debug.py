"""Numerics debugging (the counterpart of
``fastvideotagging_tpu/utils/debug.py``): NaN/Inf detection for the train
state and a finiteness metric for the train step.

A tree is a tensor or array, or a mapping / list / tuple of trees (a
``state_dict``, say). Paths are written as the JAX package writes them
(``['conv1']['kernel']``), so a report on the same nested dict reads the
same in both packages.
"""

from __future__ import annotations

from typing import Any, Iterator, Mapping

import numpy as np
import torch


def _leaves_with_path(tree: Any, path: str = "") -> Iterator[tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for key in sorted(tree):
            yield from _leaves_with_path(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            yield from _leaves_with_path(value, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def _is_float(leaf: Any) -> bool:
    if torch.is_tensor(leaf):
        return leaf.is_floating_point()
    return hasattr(leaf, "dtype") and np.issubdtype(leaf.dtype, np.floating)


def nonfinite_report(tree: Any, max_entries: int = 10) -> list[str]:
    """Paths of float leaves containing NaN/Inf (reads each leaf back to the
    host: a sync per leaf on the card)."""
    bad = []
    for path, leaf in _leaves_with_path(tree):
        if not _is_float(leaf):
            continue
        if torch.is_tensor(leaf):
            n_bad = int((~torch.isfinite(leaf.detach())).sum())
        else:
            arr = np.asarray(leaf)
            n_bad = int(np.size(arr) - np.isfinite(arr).sum())
        if n_bad:
            bad.append(f"{path}: {n_bad} non-finite")
            if len(bad) >= max_entries:
                break
    return bad


def assert_all_finite(tree: Any, what: str = "tree") -> None:
    bad = nonfinite_report(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


def finite_guard(tree: Any) -> torch.Tensor:
    """0-d bool tensor, on the leaves' device: True iff every float leaf is
    finite. Nothing is read back (cheap to log every step)."""
    oks = [torch.isfinite(leaf.detach()).all()
           for _, leaf in _leaves_with_path(tree)
           if torch.is_tensor(leaf) and leaf.is_floating_point()]
    return torch.stack(oks).all() if oks else torch.tensor(True)


def debug_train_step(step_fn):
    """Wrap a train step (train/loop.py): adds a 'finite' metric, a 0-d
    device tensor that is True iff the loss and every updated parameter are
    finite; no extra sync."""

    def wrapped(state, batch, generator=None):
        new_state, metrics = step_fn(state, batch, generator)
        metrics = dict(metrics)
        params = dict(new_state.model.named_parameters())
        metrics["finite"] = torch.logical_and(
            finite_guard(params), torch.isfinite(metrics["loss"]))
        return new_state, metrics

    return wrapped
