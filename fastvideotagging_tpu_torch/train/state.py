"""Train state (counterpart of ``fastvideotagging_tpu/train/state.py``):
the model (params and BatchNorm running statistics), the optimizer with its
momentum buffers, the schedule and the step count, as one object.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.models.zoo import model_from_config
from fastvideotagging_tpu_torch.train.lr import clip_by_global_norm_, make_optimizer


@dataclasses.dataclass
class TrainState:
    """Updated in place by ``apply_gradients`` (JAX states are replaced)."""

    model: nn.Module
    optimizer: torch.optim.SGD
    schedule: Callable[[int], float]
    clip_grad_norm: float = 0.0
    step: int = 0

    def apply_gradients(self) -> None:
        """One optimizer update from the ``.grad`` of the model's params:
        clip by global norm (if set), lr from the schedule at ``step``,
        SGD, ``step += 1``; the gradients are dropped afterwards."""
        if self.clip_grad_norm > 0:
            clip_by_global_norm_([p.grad for p in self.model.parameters()
                                  if p.grad is not None], self.clip_grad_norm)
        lr = self.schedule(self.step)
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
    if cfg.model.remat != "none":
        raise NotImplementedError(
            f"remat={cfg.model.remat!r} is not ported yet; only 'none'")
    if model is None:
        model = model_from_config(cfg.model, device=dev, generator=generator)
    model = model.to(dev).train()
    optimizer, schedule = make_optimizer(model.parameters(), cfg.train, steps_per_epoch)
    return TrainState(model=model, optimizer=optimizer, schedule=schedule,
                      clip_grad_norm=cfg.train.clip_grad_norm)
