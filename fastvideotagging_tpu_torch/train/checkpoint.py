"""Checkpoint / resume (the counterpart of
``fastvideotagging_tpu/train/checkpoint.py``, whose orbax becomes
``torch.save``).

A checkpoint holds the full train state: the model's ``state_dict`` (params
and BatchNorm statistics), the optimizer's state (its momentum buffers),
``step`` (micro steps), the running mean of the gradients of an update in
progress with gradient accumulation (``acc_grads``, or None) and
``{"epoch"}``, all on the host. One file per step,
``step_<n>.pt`` in the checkpoint directory. Each save is atomic (a temp
file, then ``os.replace``), the newest ``max_to_keep`` are kept, and a
second save at the same step replaces the first. Saves are synchronous:
``save`` returns when the file is in place, so ``wait`` and ``close`` have
nothing to wait for. ``export_weights`` / ``load_weights`` write and read a
weights-only ``state_dict`` for the tag()/serving path.

In a job (``mesh``) every rank holds the same state, or with channel
sharding its part of it: a save gathers each sharded parameter, its
momentum and its running mean of an accumulation whole over the model group
(every rank calls ``save``), rank 0 writes the file, and the other ranks
wait at a barrier until it is in place. A checkpoint thus holds whole
tensors at any ``model_parallel``: every rank restores from it and takes
its part for the mesh it restores on, so a resumed job continues as one
process would, a ``model_parallel = 2`` checkpoint restores at 2 bit for
bit and at 1 as the gathered weights, and ``restore_weights`` gives whole
weights (for ``export_weights``, ``Tagger`` and ``cli.evaluate``).
"""

from __future__ import annotations

import os
import re

import torch

from fastvideotagging_tpu_torch.parallel.channel import gather_along, shard_of
from fastvideotagging_tpu_torch.parallel.mesh import (
    Mesh,
    barrier,
    full_state_dict,
    local_parts,
    sharded_params,
)
from fastvideotagging_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _to_host(tree):
    """A copy of ``tree`` with every tensor on the host (a device-to-host
    copy, which waits for the card)."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _by_index(state: TrainState) -> dict[int, tuple[int, object]]:
    """``{optimizer / acc_grads index: (dim, model group)}`` of the sharded
    parameters (the optimizer holds the model's parameters in order)."""
    names = [n for n, _ in state.model.named_parameters()]
    sharded = sharded_params(state.model)
    return {i: sharded[n] for i, n in enumerate(names) if n in sharded}


def _whole_optimizer(state: TrainState, sharded: dict) -> dict:
    """The optimizer's state_dict with the sharded momentum gathered whole
    (a collective over each model group)."""
    sd = state.optimizer.state_dict()
    for i, (dim, group) in sharded.items():
        buf = sd["state"].get(i, {}).get("momentum_buffer")
        if buf is not None:
            sd["state"][i] = dict(sd["state"][i], momentum_buffer=gather_along(buf, dim, group))
    return sd


def _part(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    return shard_of(t, dim, group.rank(), group.size())


def _atomic_save(obj, path: str) -> None:
    """``torch.save`` into a temp file beside ``path``, then rename; an
    interrupted save leaves no partial file and the old one untouched."""
    tmp = f"{path}.tmp"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class NullCheckpointManager:
    """Checkpointing disabled (TrainConfig.checkpoint_dir == ""), for
    throwaway and benchmark runs."""

    def save(self, step, state, extra=None):
        pass

    def latest_step(self):
        return None

    def restore(self, target_state, step=None):
        return None, None

    def restore_weights(self, step=None):
        return None, None

    def wait(self):
        pass


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3, mesh: Mesh | None = None):
        self._dir = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._mesh = mesh
        self._writes = mesh is None or mesh.is_main
        if self._writes:
            os.makedirs(self._dir, exist_ok=True)
        barrier(mesh)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"step_{step}.pt")

    def all_steps(self) -> list[int]:
        return sorted(int(m.group(1)) for name in os.listdir(self._dir)
                      if (m := _NAME.match(name)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState, extra: dict | None = None) -> None:
        """extra: {"epoch": int}. A second save at the same step replaces
        the first: when checkpoint_every_steps divides the epoch length, the
        mid-epoch save records epoch - 1 and the epoch-end save at the same
        step records epoch, and a resume must take the latter (or it would
        replay the whole completed epoch). In a job, the sharded tensors are
        gathered whole, rank 0 writes and every rank returns once the file
        is in place."""
        sharded = _by_index(state)
        model_sd = full_state_dict(state.model)
        optimizer_sd = _whole_optimizer(state, sharded)
        acc = state.acc_grads
        if acc is not None and sharded:
            acc = [gather_along(g, *sharded[i]) if i in sharded else g
                   for i, g in enumerate(acc)]
        if self._writes:
            payload = {
                "model": _to_host(model_sd),
                "optimizer": _to_host(optimizer_sd),
                "step": int(state.step),
                "acc_grads": _to_host(acc),
                "epoch": int((extra or {}).get("epoch", 0)),
            }
            _atomic_save(payload, self._path(step))
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))
        barrier(self._mesh)

    def _load(self, step: int | None):
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore(self, target_state: TrainState, step: int | None = None):
        """Load the checkpoint at ``step`` (the latest by default) into
        ``target_state`` in place — model and optimizer state go to the
        model's device, each rank of a channel-sharded model taking its
        part — and return ``(state, {"epoch": e})``, or ``(None, None)``
        when there is none."""
        payload = self._load(step)
        if payload is None:
            return None, None
        sharded = _by_index(target_state)
        target_state.model.load_state_dict(local_parts(target_state.model, payload["model"]))
        optimizer_sd = payload["optimizer"]
        for i, (dim, group) in sharded.items():
            buf = optimizer_sd["state"].get(i, {}).get("momentum_buffer")
            if buf is not None:
                optimizer_sd["state"][i]["momentum_buffer"] = _part(buf, dim, group)
        target_state.optimizer.load_state_dict(optimizer_sd)
        target_state.step = payload["step"]
        acc = payload.get("acc_grads")
        dev = next(target_state.model.parameters()).device
        target_state.acc_grads = None if acc is None else [
            (_part(g, *sharded[i]) if i in sharded else g).to(dev) for i, g in enumerate(acc)]
        return target_state, {"epoch": payload["epoch"]}

    def restore_weights(self, step: int | None = None):
        """Weights only, for eval/serving consumers: ``(state_dict, step)``
        or ``(None, None)``. Needs no optimizer of the matching structure
        (a clipped or accumulated optimizer would not have one)."""
        payload = self._load(step)
        if payload is None:
            return None, None
        return payload["model"], payload["step"]

    def wait(self) -> None:
        pass  # saves are synchronous

    def close(self) -> None:
        pass


def export_weights(path: str, state_dict: dict) -> None:
    """Weights-only export for inference (the tag() path), atomic."""
    _atomic_save(_to_host(dict(state_dict)), os.path.abspath(path))


def load_weights(path: str) -> dict:
    """A ``state_dict`` written by ``export_weights``, on the host."""
    return torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
