"""Shared argparse plumbing: flags -> frozen config tree (the counterpart of
``fastvideotagging_tpu/cli/common.py``).

``--preset`` selects one of the BASELINE configs and flags override its
fields. The JAX package's ``--platform`` / ``--cpu-devices`` become
``--device cuda|cpu`` (the card by default; ``apply_platform``).

A multi-process job runs the same command once a process, each with its
``--process-id``: ``--coordinator HOST:PORT --num-processes N --process-id
i`` join it (``maybe_init_multihost``), one card a process, over NCCL on
the card and gloo on the CPU (``--dist-backend`` overrides: two processes
that share one card take gloo). Training and evaluation then run over the
job: data-parallel, and with ``--model-parallel`` > 1 (or a preset's, such
as ``slowfast_stretch``'s 2) SlowFast's convs channel-sharded over each
model group of that many consecutive ranks (parallel/mesh.py).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import PRESETS, ExperimentConfig


def add_common_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="named BASELINE config; flags override its fields")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where to run (default: the card; without one the run "
                        "raises unless --device cpu is given)")
    # model
    p.add_argument("--model", default=None, help="zoo name, e.g. r2plus1d_18")
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--multilabel", action=argparse.BooleanOptionalAction,
                   default=None, help="--no-multilabel overrides a preset's True")
    p.add_argument("--dropout", type=float, default=None)
    p.add_argument("--kernels", choices=["cuda", "torch"], default=None,
                   help="cuda: the hand-written Hopper kernels (default); "
                        "torch: F.conv3d everywhere")
    p.add_argument("--norm", choices=["batch", "frozen", "group", "scaleonly"], default=None,
                   help="normalization: batch (faithful) | frozen (BN-lite) | group "
                        "(GroupNorm) | scaleonly (stats-free affine + weight "
                        "standardization + SkipInit)")
    p.add_argument("--compute-dtype", choices=["bfloat16", "float32"], default=None)
    # data
    p.add_argument("--data-root", default=None)
    p.add_argument("--train-list", default=None)
    p.add_argument("--val-list", default=None)
    p.add_argument("--clip-len", type=int, default=None)
    p.add_argument("--stride", type=int, default=None)
    p.add_argument("--eval-mode", choices=["center", "uniform", "dense"], default=None)
    p.add_argument("--num-eval-clips", type=int, default=None)
    p.add_argument("--resize", type=int, nargs=2, metavar=("H", "W"), default=None)
    p.add_argument("--crop", type=int, nargs=2, metavar=("H", "W"), default=None)
    p.add_argument("--num-workers", type=int, default=None)
    p.add_argument("--cache-mb", type=int, default=None,
                   help=">0 caches decoded videos in host RAM (small sets)")
    p.add_argument("--host-crop", action=argparse.BooleanOptionalAction, default=None,
                   help="crop on the host before the copy to the card "
                        "(needs frames shipped at resize_hw)")
    p.add_argument("--cache-on-device", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="copy the whole .fvtpack to the card once and gather clips "
                        "there: a step copies a few KB of indices (needs a packed "
                        "--train-list; batches bitwise the streaming loader's)")


def add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--momentum", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--lr-steps", type=int, nargs="*", default=None)
    p.add_argument("--lr-decay", type=float, default=None)
    p.add_argument("--warmup-epochs", type=int, default=None)
    p.add_argument("--clip-grad-norm", type=float, default=None,
                   help=">0 clips gradients to this global L2 norm")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="k > 1: update every k-th micro step on the mean of the k "
                        "gradients (--batch-size is the micro batch)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action=argparse.BooleanOptionalAction, default=None,
                   help="--no-resume overrides a preset's True")
    p.add_argument("--log-every", type=int, default=None)
    p.add_argument("--data-parallel", type=int, default=None)
    p.add_argument("--model-parallel", type=int, default=None)
    p.add_argument("--metrics-jsonl", default=None)
    add_multihost_flags(p)


def add_multihost_flags(p: argparse.ArgumentParser) -> None:
    """The multi-process flags: run the same command in every process with
    its --process-id; used by train and evaluate."""
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address; joins the multi-process job "
                        "(torch.distributed over tcp://HOST:PORT)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="total number of processes in the job (one card each)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in [0, num-processes)")
    p.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                   help="the job's backend (default: nccl on the card, gloo on the "
                        "CPU; ranks that share one card need gloo)")
    p.add_argument("--dist-timeout", type=float, default=600.0,
                   help="seconds a collective may wait before the job fails")


def apply_platform(args: argparse.Namespace) -> torch.device:
    """The device of ``--device`` (the JAX package's ``--platform``): the
    card unless ``--device cpu``; raises without a card."""
    return resolve_device(getattr(args, "device", None) or "cuda")


def maybe_init_multihost(args: argparse.Namespace) -> None:
    """Join the multi-process job when --coordinator is given (before the
    run builds anything on its device)."""
    if getattr(args, "coordinator", None) is None:
        return
    if args.num_processes is None or args.process_id is None:
        raise SystemExit("--coordinator needs --num-processes and --process-id")
    import torch.distributed as dist

    from fastvideotagging_tpu_torch.parallel.mesh import init_multihost

    if dist.is_initialized():
        raise SystemExit("this process already joined a job")
    init_multihost(args.coordinator, args.num_processes, args.process_id,
                   backend=args.dist_backend, device=getattr(args, "device", None) or "cuda",
                   timeout=args.dist_timeout)


def finish_multihost() -> None:
    """Leave the job, if this process joined one."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _override(dc, **kw):
    updates = {k: v for k, v in kw.items() if v is not None}
    return dataclasses.replace(dc, **updates) if updates else dc


def build_config(args: argparse.Namespace) -> ExperimentConfig:
    cfg = PRESETS[args.preset] if args.preset else ExperimentConfig()
    g = lambda name: getattr(args, name, None)  # noqa: E731

    sampler = _override(
        cfg.data.sampler,
        clip_len=g("clip_len"), stride=g("stride"), eval_mode=g("eval_mode"),
        num_eval_clips=g("num_eval_clips"),
    )
    data = _override(
        cfg.data,
        root=g("data_root"), train_list=g("train_list"), val_list=g("val_list"),
        resize_hw=tuple(args.resize) if g("resize") else None,
        crop_hw=tuple(args.crop) if g("crop") else None,
        num_workers=g("num_workers"), cache_mb=g("cache_mb"),
        host_crop=g("host_crop"), cache_on_device=g("cache_on_device"),
    )
    data = dataclasses.replace(data, sampler=sampler)
    model = _override(
        cfg.model,
        name=g("model"), num_classes=g("num_classes"), multilabel=g("multilabel"),
        dropout=g("dropout"), kernels=g("kernels"), norm=g("norm"),
        compute_dtype=g("compute_dtype"),
    )
    train = _override(
        cfg.train,
        batch_size=g("batch_size"), num_epochs=g("epochs"), base_lr=g("lr"),
        momentum=g("momentum"), weight_decay=g("wd"),
        lr_steps=tuple(args.lr_steps) if g("lr_steps") else None,
        lr_decay=g("lr_decay"), warmup_epochs=g("warmup_epochs"),
        clip_grad_norm=g("clip_grad_norm"),
        grad_accum_steps=g("grad_accum"), seed=g("seed"),
        checkpoint_dir=g("checkpoint_dir"), resume=g("resume"),
        log_every=g("log_every"),
    )
    parallel = _override(
        cfg.parallel,
        data_parallel=g("data_parallel"), model_parallel=g("model_parallel"),
    )
    return ExperimentConfig(model=model, data=data, train=train, parallel=parallel)
