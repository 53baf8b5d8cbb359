"""The explicit data-parallel train step (the counterpart of
``fastvideotagging_tpu/train/shardmap_step.py``).

The JAX package's default step is one GSPMD program; this variant spells
the same math out: each rank computes its rows' gradients and BatchNorm
batch statistics, the statistics are averaged over the data group inside the
forward (the model's Norms carry the group), and then

  * gradients: one all-reduce of each gradient, then a division by the
    world size (``lax.pmean`` over the data axis);
  * loss and top-1: averaged the same way.

It is ``train/loop.py``'s step with a mesh, under the reference's name.
"""

from __future__ import annotations

from typing import Callable

import torch

from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.parallel.mesh import Mesh
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.state import TrainState


def make_train_step_shardmap(model: torch.nn.Module, cfg: ExperimentConfig, mesh: Mesh,
                             ) -> Callable[..., tuple[TrainState, dict]]:
    """The explicit step over ``mesh``'s data group: ``(state, batch,
    generator) -> (state, metrics)`` on this rank's rows of the global
    batch. The model's BatchNorms are put on the group (the reference's
    ``bn_axis_name=data_axis``)."""
    return make_train_step(model, cfg, mesh=mesh)
