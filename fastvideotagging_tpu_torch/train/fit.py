"""fit(): the end-to-end training orchestration (the counterpart of
``fastvideotagging_tpu/train/fit.py``) on one card.

Epoch/batch loop, periodic speed/loss logging, per-epoch checkpoint and
eval: worker-decoded uint8 batches (``train_batches``) are prefetched onto
the card (``device_prefetch``) and run through one eager train step
(``make_train_step``: preprocess, forward, backward through the hand
kernels, SGD); checkpoints hold the full state, so a resume is exact. With
``DataConfig.cache_on_device`` the whole pack is copied to the card once
(data/device_cache.py) and the batches carry cache rows, gathered there.

Dropout draws from a generator seeded from ``(seed, global_step)`` on the
model's device (the counterpart of ``fold_in(rng, global_step)``), so a
resumed run needs no generator state to draw the same masks.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.data.device_cache import build_cache, train_index_batches
from fastvideotagging_tpu_torch.data.packed import PackedDataset, open_dataset
from fastvideotagging_tpu_torch.data.pipeline import device_prefetch, train_batches
from fastvideotagging_tpu_torch.evaluation.evaluate import make_eval_fn
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.train.checkpoint import CheckpointManager, NullCheckpointManager
from fastvideotagging_tpu_torch.train.loop import make_train_step
from fastvideotagging_tpu_torch.train.metrics import RunningMean
from fastvideotagging_tpu_torch.train.state import TrainState, create_train_state
from fastvideotagging_tpu_torch.utils.interrupt import GracefulStopper
from fastvideotagging_tpu_torch.utils.logging import MetricsLogger, get_logger

log = get_logger("fvt.train")


def dropout_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The step's dropout generator on ``device``, seeded from (seed, step)
    alone."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence((seed, step)).generate_state(1, np.uint64)[0]))
    return g


def _check_single_card(cfg: ExperimentConfig, mesh) -> None:
    p = cfg.parallel
    if mesh is not None or p.data_parallel > 1 or p.model_parallel > 1:
        raise NotImplementedError(
            "fit runs on one card: mesh=, data_parallel > 1 and model_parallel > 1 "
            "are not ported yet (ROADMAP.md Queue A item 7, parallelism)")


def fit(
    cfg: ExperimentConfig,
    train_records,
    val_records=None,
    mesh=None,
    num_tags: int | None = None,
    metrics_path: str | None = None,
    eval_fn=None,
    init_variables: dict | None = None,
    device: str | torch.device = "cuda",
) -> TrainState:
    """Train per config; returns the final TrainState.

    train_records / val_records: lists of VideoRecords (streaming decode) or
    ``.fvtpack`` paths (the decode-once tier, data/packed.py).
    eval_fn: optional callable (state, epoch) -> dict of eval scalars, run
    after each epoch. If absent and ``val_records`` is given, the standard
    multi-clip evaluator is built on the same device.
    init_variables: optional pretrained weights used instead of the seeded
    init: a state_dict of the port (``zoo.load_pretrained``, as the train
    CLI's ``--pretrained`` gives it) or JAX-package variables ``{'params',
    'batch_stats'}``; structure and shape mismatches raise.
    device: the card by default; raises without one unless ``'cpu'``.
    mesh: only None (one card).
    """
    _check_single_card(cfg, mesh)
    dev = resolve_device(device)
    t_cfg, d_cfg, m_cfg = cfg.train, cfg.data, cfg.model
    if eval_fn is None and val_records:
        eval_fn = make_eval_fn(cfg, val_records, num_tags=num_tags, device=dev)
    num_tags = num_tags or (m_cfg.num_classes if m_cfg.multilabel else None)

    dataset = open_dataset(train_records, d_cfg, mode="train",
                           num_tags=num_tags, seed=t_cfg.seed)
    if len(dataset) < t_cfg.batch_size:
        # train_batches with drop_last would yield zero batches per epoch
        # while still paying full decode cost — fail loudly instead.
        raise ValueError(
            f"dataset has {len(dataset)} samples < batch_size="
            f"{t_cfg.batch_size}; no full batch can be formed")
    steps_per_epoch = max(1, len(dataset) // t_cfg.batch_size)

    state = create_train_state(cfg, steps_per_epoch, device=dev,
                               generator=torch.Generator().manual_seed(t_cfg.seed))
    if init_variables is not None:
        _apply_pretrained(state, init_variables)

    ckpt = (CheckpointManager(t_cfg.checkpoint_dir) if t_cfg.checkpoint_dir
            else NullCheckpointManager())  # benchmark/throwaway runs
    start_epoch = 0
    if t_cfg.resume:
        restored, extra = ckpt.restore(state)
        if restored is not None:
            start_epoch = int(extra["epoch"]) + 1
            log.info("resumed from step %d (epoch %d)", state.step, start_epoch)

    cache = None
    if d_cfg.cache_on_device:
        if not isinstance(dataset, PackedDataset):
            raise ValueError(
                "cache_on_device=True needs a .fvtpack train source "
                "(cli.prepare --pack); streaming records cannot be staged "
                "into device memory")
        cache = build_cache(dataset, device=dev)
        raw_step = make_train_step(state.model, cfg, device_cache=True)
        step_fn = lambda s, b, g: raw_step(s, b, g, cache.frames)  # noqa: E731
    else:
        step_fn = make_train_step(state.model, cfg)
    mlog = MetricsLogger(metrics_path)
    try:
        with GracefulStopper() as stopper:
            _epoch_loop(cfg, state, step_fn, dataset, ckpt, mlog, dev,
                        start_epoch, eval_fn, stopper, cache)
    finally:
        ckpt.wait()
        mlog.close()
    return state


def _apply_pretrained(state: TrainState, variables: dict) -> None:
    """Load pretrained weights into the state's model, after checking their
    structure and shapes against it: a state_dict of the port replaces
    every tensor; the JAX package's variables replace the params, and the
    BatchNorm statistics only when ``batch_stats`` is given."""
    model = state.model
    current = model.state_dict()
    if "params" in variables:
        new = from_jax_variables(variables)
        want = {name for name, _ in model.named_parameters()}
        if variables.get("batch_stats"):
            want |= {name for name, _ in model.named_buffers()}
    else:
        new, want = dict(variables), set(current)
    if set(new) != want:
        missing = sorted(want - set(new))[:4]
        extra = sorted(set(new) - want)[:4]
        raise ValueError(f"pretrained tree mismatch: missing={missing} extra={extra}")
    for name, value in new.items():
        if tuple(value.shape) != tuple(current[name].shape):
            raise ValueError(
                f"pretrained shape mismatch at {name}: {tuple(value.shape)} vs "
                f"{tuple(current[name].shape)}")
    with torch.no_grad():
        for name, value in new.items():
            current[name].copy_(value)


def _epoch_loop(cfg, state, step_fn, dataset, ckpt, mlog, dev, start_epoch,
                eval_fn, stopper, cache=None) -> None:
    t_cfg, d_cfg = cfg.train, cfg.data

    def make_batches(epoch):
        if cache is not None:
            # index-only batches: a few KB a step; the pixels are on the card
            return train_index_batches(dataset, cache, t_cfg.batch_size, epoch)
        return train_batches(dataset, t_cfg.batch_size, epoch,
                             num_workers=d_cfg.num_workers)

    global_step = state.step
    for epoch in range(start_epoch, t_cfg.num_epochs):
        loss_avg, top1_avg = RunningMean(), RunningMean()
        metrics = None  # this epoch's last step; None if the epoch is empty
        epoch_start = time.time()
        tic = time.time()
        source = make_batches(epoch)
        batches = device_prefetch(source, dev, depth=d_cfg.prefetch_depth)
        data_wait = 0.0  # host-blocked-on-loader time this logging window
        try:
            while True:
                t_wait = time.time()
                batch = next(batches, None)
                if batch is None:
                    break
                data_wait += time.time() - t_wait
                if stopper.stop_requested:
                    ckpt.save(global_step, state, {"epoch": epoch - 1})
                    log.warning("stopping at step %d on request; checkpoint saved "
                                "(resume with --resume)", global_step)
                    return
                state, metrics = step_fn(
                    state, batch, dropout_generator(t_cfg.seed, global_step, dev))
                global_step += 1
                if global_step % t_cfg.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # sync
                    loss_avg.update(metrics["loss"], t_cfg.batch_size)
                    if "top1" in metrics:
                        top1_avg.update(metrics["top1"], t_cfg.batch_size)
                    window = time.time() - tic
                    speed = t_cfg.log_every * t_cfg.batch_size / window
                    # data_wait_frac: share of the window the host spent
                    # blocked on the loader. ~0: the loader is hidden behind
                    # the device; near 1: loader-bound (use a .fvtpack).
                    wait_frac = data_wait / window if window > 0 else 0.0
                    data_wait = 0.0
                    tic = time.time()
                    mlog.log(global_step, epoch=epoch, loss=metrics["loss"],
                             top1=metrics.get("top1", float("nan")),
                             samples_per_sec=speed,
                             data_wait_frac=round(wait_frac, 4))
                if (t_cfg.checkpoint_every_steps
                        and global_step % t_cfg.checkpoint_every_steps == 0):
                    # Mid-epoch save records epoch-1 (like the graceful-stop
                    # path) so resume re-runs the interrupted epoch rather
                    # than silently skipping its remaining batches.
                    ckpt.save(global_step, state, {"epoch": epoch - 1})
        finally:
            # an early return leaves both generators suspended: closing the
            # loader shuts its decode pool down
            batches.close()
            source.close()

        if loss_avg.weight == 0 and metrics is not None:
            # short epochs can finish between log_every sync points; pull
            # the last step's metrics once so the summary is never nan
            last = {k: float(v) for k, v in metrics.items()}
            loss_avg.update(last["loss"], t_cfg.batch_size)
            if "top1" in last:
                top1_avg.update(last["top1"], t_cfg.batch_size)
        log.info("epoch %d done in %.1fs loss=%.4f top1=%.4f", epoch,
                 time.time() - epoch_start, loss_avg.value, top1_avg.value)
        ckpt.save(global_step, state, {"epoch": epoch})
        if eval_fn is not None:
            scalars = eval_fn(state, epoch)
            mlog.log(global_step, **{f"eval_{k}": v for k, v in scalars.items()})
