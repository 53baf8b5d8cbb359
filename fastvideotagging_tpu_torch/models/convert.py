"""Weights carried across from and to the JAX package.

``from_jax_variables`` maps the JAX package's variables — nested dicts of
numpy arrays, ``{'params': ..., 'batch_stats': ...}`` — of any zoo model
onto the port model's ``state_dict``. Both trees share module names, so the
map is by name:

- conv kernels ``.../<conv>/kernel`` (kt, kh, kw, Cin, Cout) and conv
  biases are kept as they are (the port keeps the JAX layout);
- a norm's ``BatchNorm_0`` / ``GroupNorm_0`` level is dropped
  (``<norm>/BatchNorm_0/scale`` -> ``<norm>.scale``, the statistics
  ``mean`` / ``var`` likewise); 'scaleonly' has none;
- a Dense ``.../<name>/kernel`` (Cin, Cout), the only 2-D kernels, becomes
  ``<name>.weight`` (Cout, Cin).

``to_jax_variables`` is the inverse: a state_dict of the port (a trained
model's, say) becomes nested dicts of numpy arrays that the JAX package's
``model.apply`` takes. Which tree a key goes to follows the type of the
module that holds it: given the ``model``, from its modules; without one,
from the state_dict's own structure (a prefix with ``weight`` is a Dense,
one with ``mean``/``var`` a BatchNorm, one with ``kernel`` a conv), which
cannot tell a GroupNorm from a 'scaleonly' affine and raises there.

``qpack_from_jax`` carries the JAX package's int8 qpack
(``ops/int8_infer.quantize_variables``) over as the port's
(ops/int8_infer.py): the same keys, every leaf a tensor, each conv's int8
weights also laid out K-major for the int8 conv kernel, so that both
engines can run on one qpack.

Neither JAX nor Flax is imported: any array with ``__array__`` works.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Iterator, Mapping

import numpy as np
import torch
from torch import nn

_NORM_LEVELS = ("BatchNorm_0", "GroupNorm_0")


def _flatten(tree: Mapping, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def from_jax_variables(variables: Mapping) -> dict[str, torch.Tensor]:
    """JAX-layout variables of a zoo model -> the port model's state_dict."""
    state: dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _flatten(variables.get(collection, {})):
            names = [p for p in path if p not in _NORM_LEVELS]
            value = torch.from_numpy(np.array(leaf, dtype=np.float32))
            if names[-1] == "kernel" and value.ndim == 2:  # a Dense
                names[-1], value = "weight", value.T.contiguous()
            state[".".join(names)] = value
    return state


def _module_kinds(model: nn.Module) -> dict[str, str]:
    """Module path -> 'batch' | 'group' | 'scaleonly' | 'dense' for the
    modules whose leaves do not map one to one."""
    from fastvideotagging_tpu_torch.models.layers import Norm

    kinds = {}
    for name, module in model.named_modules():
        if isinstance(module, Norm):
            kinds[name] = "batch" if module.kind == "frozen" else module.kind
        elif isinstance(module, nn.Linear):
            kinds[name] = "dense"
    return kinds


def _structural_kinds(state_dict: Mapping[str, torch.Tensor]) -> dict[str, str]:
    leaves = defaultdict(set)
    for key in state_dict:
        prefix, _, leaf = key.rpartition(".")
        leaves[prefix].add(leaf)
    kinds = {}
    for prefix, names in leaves.items():
        if "weight" in names:
            kinds[prefix] = "dense"
        elif {"mean", "var"} & names:
            kinds[prefix] = "batch"
        elif "scale" in names and "kernel" not in names:
            raise ValueError(
                f"{prefix!r} holds scale/bias only: a GroupNorm or a 'scaleonly' affine; "
                f"pass the model to to_jax_variables to tell them apart")
    return kinds


def to_jax_variables(state_dict: Mapping[str, torch.Tensor],
                     model: nn.Module | None = None) -> dict:
    """The port model's state_dict -> JAX-layout variables ``{'params':
    ..., 'batch_stats': ...}`` of float32 numpy arrays, each a copy (JAX
    may read a numpy input in place while an optimizer updates the
    tensor); the module types come from ``model`` where it is given (module
    docstring)."""
    kinds = _module_kinds(model) if model is not None else _structural_kinds(state_dict)
    variables: dict = {"params": {}, "batch_stats": {}}
    for key, tensor in state_dict.items():
        prefix, _, leaf = key.rpartition(".")
        path = prefix.split(".") if prefix else []
        value = tensor.detach().to("cpu", torch.float32).numpy()
        collection = "params"
        kind = kinds.get(prefix)
        if kind == "dense" and leaf == "weight":
            leaf, value = "kernel", value.T
        elif kind == "batch":
            path.append("BatchNorm_0")
            if leaf in ("mean", "var"):
                collection = "batch_stats"
        elif kind == "group":
            path.append("GroupNorm_0")
        node = variables[collection]
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = np.array(value, order="C")  # a copy: never a view of a live tensor
    return variables


def qpack_from_jax(qpack: Mapping, device: str | torch.device = "cpu") -> dict:
    """The JAX package's int8 qpack (nested dicts and lists of arrays) ->
    the port's, on ``device``: float leaves f32 tensors (``s_static``'s
    scalars 0-d), int8 weights int8, and beside each conv's ``w`` its
    K-major layout ``wk`` (ops/int8_conv.py::weight_layout)."""
    from fastvideotagging_tpu_torch.ops.int8_conv import weight_layout

    def leaf(value):
        a = np.asarray(value)
        dtype = torch.int8 if a.dtype == np.int8 else torch.float32
        return torch.as_tensor(np.array(a, dtype=np.int8 if a.dtype == np.int8 else np.float32),
                               dtype=dtype, device=device)

    def tree(node):
        if isinstance(node, Mapping):
            return {k: tree(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [tree(v) for v in node]
        return leaf(node)

    out = tree(qpack)
    for pack in out["convs"].values():
        pack["wk"] = weight_layout(pack["w"])
    return out
