"""LR schedule and optimizer (counterpart of
``fastvideotagging_tpu/train/lr.py``): SGD-momentum with multi-factor decay.

The JAX package chains optax ``clip_by_global_norm`` -> ``add_decayed_weights``
-> ``sgd(schedule, momentum)``. ``torch.optim.SGD(weight_decay=...)`` adds
``weight_decay * p`` to the gradient before the momentum buffer and steps by
``lr * buffer``: the same arithmetic once the gradient is clipped first and
``lr`` is set from the schedule before every step. The decay has no mask:
BN scale/bias and the fc bias decay too, as in the optax chain.

``grad_accum_steps = k > 1`` wraps that chain in ``optax.MultiSteps`` in the
JAX package; train/state.py keeps its semantics (the chain runs every k-th
micro step on the mean of the k gradients). The schedule counts the chain's
updates but is built with ``steps_per_epoch`` in micro steps, as the JAX
package builds it, so its warmup and decay epochs come k times later in
epochs than the config says (ROADMAP.md Queue C).
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.distributed as dist

from fastvideotagging_tpu_torch.config import TrainConfig


def multifactor_schedule(cfg: TrainConfig, steps_per_epoch: int) -> Callable[[int], float]:
    """``step -> lr``: base_lr, x lr_decay at each epoch in lr_steps, with
    linear warmup from 0 over ``warmup_epochs``.

    The decay boundaries are counted from the end of warmup (the
    post-warmup schedule sees ``step - warmup_steps``), so an lr_steps epoch
    fires at that epoch and not warmup_epochs later."""
    warmup_steps = (max(1, int(cfg.warmup_epochs * steps_per_epoch))
                    if cfg.warmup_epochs > 0 else 0)
    if cfg.lr_steps and cfg.warmup_epochs >= min(cfg.lr_steps):
        # A boundary at or before the end of warmup would otherwise apply
        # its decay factor from the first post-warmup step.
        raise ValueError(
            f"warmup_epochs={cfg.warmup_epochs} must end before the first "
            f"lr_steps decay epoch {min(cfg.lr_steps)}")
    boundaries = sorted(int(e * steps_per_epoch) - warmup_steps for e in cfg.lr_steps)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return cfg.base_lr * step / warmup_steps
        lr = cfg.base_lr
        for boundary in boundaries:
            if step - warmup_steps >= boundary:
                lr *= cfg.lr_decay
        return lr

    return schedule


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         sharded: list[bool] | None = None, group=None) -> None:
    """Scale ``grads`` in place to a global L2 norm of at most ``max_norm``
    (optax ``clip_by_global_norm``: untouched below it, ``g / norm *
    max_norm`` above). Stays on the device: no host sync.

    ``sharded`` marks the gradients of which this rank holds only a part
    (channel sharding over the model group ``group``): their squares are
    summed over the group before they join the norm, so every rank clips
    with the norm of the whole gradient."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is not None and sharded is not None and any(sharded):
        mask = torch.tensor(sharded, device=norms.device)
        sq = norms * norms
        parts = torch.where(mask, sq, torch.zeros_like(sq)).sum()
        dist.all_reduce(parts, group=group)
        norm = torch.sqrt(torch.where(mask, torch.zeros_like(sq), sq).sum() + parts)
    else:
        norm = torch.linalg.vector_norm(norms)
    coef = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, coef)


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   steps_per_epoch: int) -> tuple[torch.optim.SGD, Callable[[int], float]]:
    """SGD + momentum + weight decay over ``params`` and the schedule that
    sets its ``lr`` before every update (train/state.py applies it, after the
    clip when ``clip_grad_norm > 0``, to the mean gradient of
    ``grad_accum_steps`` micro steps)."""
    if cfg.grad_accum_steps < 1:
        raise ValueError(f"grad_accum_steps must be >= 1, got {cfg.grad_accum_steps}")
    schedule = multifactor_schedule(cfg, steps_per_epoch)
    sgd = torch.optim.SGD(params, lr=schedule(0), momentum=cfg.momentum,
                          weight_decay=cfg.weight_decay, dampening=0, nesterov=False)
    return sgd, schedule
