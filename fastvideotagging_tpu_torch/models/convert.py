"""Weights carried across from the JAX package.

``from_jax_variables`` maps the JAX package's R(2+1)D variables — nested
dicts of numpy arrays, ``{'params': ..., 'batch_stats': ...}`` — onto the
port model's ``state_dict``. Both trees share module names, so the map is by
name:

- conv kernels ``.../<conv>/kernel`` (kt, kh, kw, Cin, Cout) are kept as
  they are (the port keeps the JAX layout);
- BN ``params/.../<norm>/BatchNorm_0/{scale,bias}`` and
  ``batch_stats/.../<norm>/BatchNorm_0/{mean,var}`` drop the ``BatchNorm_0``
  level;
- ``fc/kernel`` (512, classes) becomes ``fc.weight`` (classes, 512).

Neither JAX nor Flax is imported: any array with ``__array__`` works.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX-layout R(2+1)D variables -> the port model's state_dict."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            names = [p for p in path if p != "BatchNorm_0"]
            value = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if names == ["fc", "kernel"]:
                names, value = ["fc", "weight"], value.T.contiguous()
            state[".".join(names)] = value
    return state
