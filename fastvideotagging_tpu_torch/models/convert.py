"""Weights carried across from and to the JAX package.

``from_jax_variables`` maps the JAX package's R(2+1)D or tiny3d variables —
nested dicts of numpy arrays, ``{'params': ..., 'batch_stats': ...}`` — onto
the port model's ``state_dict``. Both trees share module names, so the map
is by name:

- conv kernels ``.../<conv>/kernel`` (kt, kh, kw, Cin, Cout) are kept as
  they are (the port keeps the JAX layout);
- BN ``params/.../<norm>/BatchNorm_0/{scale,bias}`` and
  ``batch_stats/.../<norm>/BatchNorm_0/{mean,var}`` drop the ``BatchNorm_0``
  level;
- ``fc/kernel`` (512, classes) becomes ``fc.weight`` (classes, 512).

``to_jax_variables`` is the inverse: a state_dict of the port (a trained
model's, say) becomes nested dicts of numpy arrays that the JAX package's
``model.apply`` takes.

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


_BN_PARAMS = ("scale", "bias")
_BN_STATS = ("mean", "var")


def to_jax_variables(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The port model's state_dict -> JAX-layout R(2+1)D variables
    ``{'params': ..., 'batch_stats': ...}`` of float32 numpy arrays."""
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        *path, leaf = key.split(".")
        value = tensor.detach().to("cpu", torch.float32).numpy()
        collection = "params"
        if key == "fc.weight":
            leaf, value = "kernel", value.T
        elif path != ["fc"] and (leaf in _BN_PARAMS or leaf in _BN_STATS):
            path.append("BatchNorm_0")
            if leaf in _BN_STATS:
                collection = "batch_stats"
        node = variables[collection]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.ascontiguousarray(value)
    return variables
