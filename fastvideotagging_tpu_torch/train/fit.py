"""fit(): the end-to-end training orchestration (the counterpart of
``fastvideotagging_tpu/train/fit.py``), on one card or over the processes of
a job, one card each: data-parallel, and with ``model_parallel > 1``
channel-sharded as well.

Epoch/batch loop, periodic speed/loss logging, per-epoch checkpoint and
eval: worker-decoded uint8 batches (``train_batches``) are prefetched onto
the card (``device_prefetch``) and run through one eager train step
(``make_train_step``: preprocess, forward, backward through the hand
kernels, SGD); checkpoints hold the full state, so a resume is exact. With
``DataConfig.cache_on_device`` the whole pack is copied to the card once
(data/device_cache.py) and the batches carry cache rows, gathered there.

Dropout draws from a generator seeded from ``(seed, global_step)`` on the
model's device (the counterpart of ``fold_in(rng, global_step)``), so a
resumed run needs no generator state to draw the same masks. On the card the
epochs, their steps and evaluations run under PyTorch's deterministic mode
(train/loop.py::deterministic), so one recipe gives the same weights every
run, as the JAX package's does.

Parallel (a job joined by ``parallel.init_multihost``; the mesh comes from
``cfg.parallel``, ``data_parallel = -1`` meaning the world size over
``model_parallel``): each data index loads only its rows of every global
batch (``local_batch_rows``; the ranks of a model group load the same
rows), every rank starts from rank 0's weights, and runs the parallel step
(train/loop.py), so every rank holds the same state, or its part of it,
after every step. With ``model_parallel > 1`` the model is built with
``shard_axis`` = the mesh's model group (the slowfast family; another model
raises ``ValueError``, as the reference's fit does): each rank keeps its
part of every sharded conv kernel and its momentum. The per-epoch
evaluation runs on the same mesh; rank 0 alone logs and writes checkpoints
(whole tensors, gathered over the model group), and every rank restores
them and takes its part, also on a resume. A stop request (a signal on any
one rank) is decided collectively every step (an all-reduce with MAX), so
all ranks save and return at the same step.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fastvideotagging_tpu_torch.config import ExperimentConfig
from fastvideotagging_tpu_torch.data.device_cache import build_cache, train_index_batches
from fastvideotagging_tpu_torch.data.packed import PackedDataset, open_dataset
from fastvideotagging_tpu_torch.data.pipeline import device_prefetch, train_batches
from fastvideotagging_tpu_torch.evaluation.evaluate import make_eval_fn
from fastvideotagging_tpu_torch.models.convert import from_jax_variables
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.parallel.mesh import (
    Mesh,
    any_rank,
    check_mesh,
    local_batch_rows,
    local_parts,
    make_mesh,
    shard_train_state,
    whole_shapes,
)
from fastvideotagging_tpu_torch.train.checkpoint import CheckpointManager, NullCheckpointManager
from fastvideotagging_tpu_torch.train.loop import deterministic, make_train_step
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
    device: the card by default (in a job, this rank's); raises without one
    unless ``'cpu'``.
    mesh: the job's mesh (``parallel.make_mesh``), whose device is then the
    run's; by default the one ``cfg.parallel`` gives on ``device``.
    """
    if check_mesh(mesh) is None:
        mesh = make_mesh(cfg.parallel.data_parallel, cfg.parallel.model_parallel,
                         device=device)
    dev = mesh.device
    t_cfg, d_cfg, m_cfg = cfg.train, cfg.data, cfg.model
    if t_cfg.batch_size % mesh.data_parallel:
        raise ValueError(
            f"batch_size={t_cfg.batch_size} must be divisible by the data-parallel "
            f"degree {mesh.data_parallel}; set train.batch_size or parallel.data_parallel "
            f"accordingly")
    if eval_fn is None and val_records:
        # per-epoch eval rides the same mesh as training (clip chunks split
        # over the ranks), not one card
        eval_fn = make_eval_fn(cfg, val_records, num_tags=num_tags, device=dev, mesh=mesh)
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

    model_kw = {}
    if mesh.model_parallel > 1:
        # channel parallelism over the model group (the SlowFast config)
        model_kw["shard_axis"] = mesh.model_group
    try:
        model = model_from_config(m_cfg, device=dev,
                                  generator=torch.Generator().manual_seed(t_cfg.seed),
                                  clip_shape=config_clip_shape(d_cfg), **model_kw)
    except TypeError as e:
        if "shard_axis" in str(e):
            raise ValueError(
                f"model {m_cfg.name!r} does not support model_parallel="
                f"{mesh.model_parallel} (channel sharding needs a shard_axis-capable "
                f"model — the slowfast family); use data_parallel only") from e
        raise
    state = create_train_state(cfg, steps_per_epoch, device=dev, model=model)
    if init_variables is not None:
        _apply_pretrained(state, init_variables)
    shard_train_state(state, mesh)  # every rank starts from rank 0's weights

    ckpt = (CheckpointManager(t_cfg.checkpoint_dir, mesh=mesh) if t_cfg.checkpoint_dir
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
        cache = build_cache(dataset, mesh=mesh, device=dev)
        raw_step = make_train_step(state.model, cfg, device_cache=True, mesh=mesh)
        step_fn = lambda s, b, g: raw_step(s, b, g, cache.frames)  # noqa: E731
    else:
        step_fn = make_train_step(state.model, cfg, mesh=mesh)
    # Each rank loads only its rows of every global batch; the metrics are
    # averaged over the ranks by the step, so only rank 0 logs them.
    local_rows = None
    if mesh.data_parallel > 1:
        local_rows = local_batch_rows(mesh, t_cfg.batch_size)
        log.info("data parallel: process %d/%d (data index %d/%d) loads %d/%d rows per "
                 "batch", mesh.rank, mesh.world, mesh.data_index, mesh.data_parallel,
                 len(local_rows), t_cfg.batch_size)
    mlog = MetricsLogger(metrics_path, enabled=mesh.is_main)
    try:
        with GracefulStopper() as stopper, deterministic(dev):
            _epoch_loop(cfg, state, step_fn, dataset, ckpt, mlog, dev,
                        start_epoch, eval_fn, stopper, cache, mesh, local_rows)
    finally:
        ckpt.wait()
        mlog.close()
    return state


def _apply_pretrained(state: TrainState, variables: dict) -> None:
    """Load pretrained weights into the state's model, after checking their
    structure and shapes against it: a state_dict of the port replaces
    every tensor; the JAX package's variables replace the params, and the
    BatchNorm statistics only when ``batch_stats`` is given. The weights
    are whole tensors; a channel-sharded model takes its part of each
    sharded one."""
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
    whole = whole_shapes(model)
    for name, value in new.items():
        if tuple(value.shape) != whole[name]:
            raise ValueError(
                f"pretrained shape mismatch at {name}: {tuple(value.shape)} vs "
                f"{whole[name]}")
    with torch.no_grad():
        for name, value in local_parts(model, new).items():
            current[name].copy_(value)


def _epoch_loop(cfg, state, step_fn, dataset, ckpt, mlog, dev, start_epoch,
                eval_fn, stopper, cache, mesh: Mesh, local_rows: list[int] | None) -> None:
    t_cfg, d_cfg = cfg.train, cfg.data

    def make_batches(epoch):
        if cache is not None:
            # index-only batches: a few KB a step; the pixels are on the card
            return train_index_batches(dataset, cache, t_cfg.batch_size, epoch,
                                       rows=local_rows)
        return train_batches(dataset, t_cfg.batch_size, epoch,
                             num_workers=d_cfg.num_workers, rows=local_rows)

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
                # In a job the decision is collective: a signal lands on one
                # rank, and if it alone saved and returned, the others would
                # wait in the next step's all-reduce for ever.
                if any_rank(stopper.stop_requested, mesh):
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
        if mesh.is_main:
            log.info("epoch %d done in %.1fs loss=%.4f top1=%.4f", epoch,
                     time.time() - epoch_start, loss_avg.value, top1_avg.value)
        ckpt.save(global_step, state, {"epoch": epoch})
        if eval_fn is not None:
            scalars = eval_fn(state, epoch)
            mlog.log(global_step, **{f"eval_{k}": v for k, v in scalars.items()})
