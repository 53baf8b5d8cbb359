"""Train state (counterpart of ``fastvideotagging_tpu/train/state.py``):
the model (params and BatchNorm running statistics), the optimizer with its
momentum buffers, the schedule, the step count and, with gradient
accumulation, the running mean of the micro steps' gradients, as one object.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.parallel.mesh import sharded_params
from fastvideotagging_tpu_torch.train.lr import clip_by_global_norm_, make_optimizer


@dataclasses.dataclass
class TrainState:
    """Updated in place by ``apply_gradients`` (JAX states are replaced).

    ``step`` counts micro steps (calls of ``apply_gradients``), as the JAX
    state's ``step`` does. With ``grad_accum_steps = k > 1`` (``optax.
    MultiSteps``): the micro step ``step % k`` of an update adds its
    gradients to ``acc_grads``, their running mean; the k-th runs the
    optimizer on that mean and clears it. The parameters and the momentum
    move only then; the schedule sees the updates made so far, ``step //
    k``. BatchNorm's statistics move in every micro step's forward.

    ``model_group``: the model group of a channel-sharded model (the
    parallel step sets it), over which the clip's global norm sums the
    sharded gradients' parts; the optimizer's momentum of a sharded
    parameter is this rank's part, as the parameter is."""

    model: nn.Module
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    clip_grad_norm: float = 0.0
    step: int = 0
    grad_accum_steps: int = 1
    acc_grads: list[torch.Tensor] | None = None
    model_group: object = None

    def apply_gradients(self) -> None:
        """One micro step from the ``.grad`` of the model's params; the
        gradients are dropped afterwards. An update: clip by global norm (if
        set), lr from the schedule, SGD. ``step += 1``."""
        k = self.grad_accum_steps
        params = [p for p in self.model.parameters() if p.grad is not None]
        if k > 1:
            mini = self.step % k
            grads = [p.grad for p in params]
            if self.acc_grads is None:
                self.acc_grads = [torch.zeros_like(g) for g in grads]
            # optax's Welford mean: acc + (g - acc) / (n + 1)
            torch._foreach_add_(self.acc_grads, torch._foreach_div(
                torch._foreach_sub(grads, self.acc_grads), float(mini + 1)))
            if mini < k - 1:
                self.optimizer.zero_grad(set_to_none=True)
                self.step += 1
                return
            for p, acc in zip(params, self.acc_grads):
                p.grad = acc
            self.acc_grads = None
        if self.clip_grad_norm > 0:
            sharded = None
            if self.model_group is not None:
                named = dict(self.model.named_parameters())
                parts = {id(named[n]) for n in sharded_params(self.model)}
                sharded = [id(p) in parts for p in params]
            clip_by_global_norm_([p.grad for p in params], self.clip_grad_norm,
                                 sharded=sharded, group=self.model_group)
        lr = self.schedule(self.step // k)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(cfg: ExperimentConfig, steps_per_epoch: int,
                       device: str | torch.device = "cuda",
                       generator: torch.Generator | None = None,
                       model: nn.Module | None = None) -> TrainState:
    """The state for ``cfg``: its model (seeded init from ``generator``;
    params stay f32) in train mode on ``device`` — the card by default,
    raises without one unless ``device='cpu'`` — and its optimizer. A
    ``model`` built elsewhere is taken as it is and moved to ``device``."""
    dev = resolve_device(device)
    if model is None:
        model = model_from_config(cfg.model, device=dev, generator=generator,
                                  clip_shape=config_clip_shape(cfg.data))
    model = model.to(dev).train()
    optimizer, schedule = make_optimizer(model.parameters(), cfg.train, steps_per_epoch)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      clip_grad_norm=cfg.train.clip_grad_norm,
                      grad_accum_steps=cfg.train.grad_accum_steps)
