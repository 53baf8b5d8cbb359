"""Eval CLI (the counterpart of ``fastvideotagging_tpu/cli/evaluate.py``):
the UCF101 parity protocol as one command.

    python -m fastvideotagging_tpu_torch.cli.evaluate --preset ucf101_parity \
        --data-root /data/ucf101 --val-list testlist01.txt \
        --class-index classInd.txt --checkpoint-dir checkpoints

Restores the weights of the latest checkpoint of a port training run
(``train/checkpoint.py``; the optimizer state is not read), evaluates a
``.fvtpack`` or a video list on the card (``--device cpu`` for the host)
and prints one JSON line of metrics. ``--int8`` evaluates the int8 engine,
calibrated on the first ``--int8-calib-videos`` videos' eval clips. In a
multi-process job (``--coordinator``, ``--num-processes``,
``--process-id``) the evaluation runs over its ranks, one card each: every
rank restores the weights and decodes the list, the clip chunks are split
over the data indices, with ``--model-parallel`` > 1 (or a preset's) the
ranks of a model group score their rows through the channel-sharded model,
each taking its part of the restored weights, and rank 0 prints the
metrics. A mesh that does not fit the job (``slowfast_stretch``'s
``model_parallel = 2`` in one process) evaluates unsharded, with a warning,
as the JAX package's CLI does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fastvideotagging_tpu_torch.cli.common import (
    add_common_flags,
    add_multihost_flags,
    apply_platform,
    build_config,
    finish_multihost,
    maybe_init_multihost,
)
from fastvideotagging_tpu_torch.data import ucf101
from fastvideotagging_tpu_torch.data.packed import is_pack, open_dataset
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate
from fastvideotagging_tpu_torch.evaluation.quantized import make_int8_apply
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
from fastvideotagging_tpu_torch.ops.preprocess import preprocess_eval_clip
from fastvideotagging_tpu_torch.parallel.mesh import local_parts, make_mesh
from fastvideotagging_tpu_torch.train.checkpoint import CheckpointManager
from fastvideotagging_tpu_torch.utils.logging import get_logger


def main(argv=None) -> dict:
    """Evaluate per the flags; prints and returns the metrics."""
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--class-index", default=None)
    p.add_argument("--clip-batch", type=int, default=8)
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--int8", action="store_true",
                   help="evaluate the int8 PTQ engine (calibrated on the first "
                        "--int8-calib-videos videos)")
    p.add_argument("--int8-calib-videos", type=int, default=8)
    add_multihost_flags(p)
    args = p.parse_args(argv)
    cfg = build_config(args)
    maybe_init_multihost(args)
    try:
        mesh = make_mesh(cfg.parallel.data_parallel, cfg.parallel.model_parallel,
                         device=args.device)
        dev = mesh.device
    except ValueError as e:
        # a config whose (training) parallelism does not fit the job, e.g. a
        # model_parallel preset evaluated in one process, still evaluates:
        # unsharded, on this process's device
        get_logger("fvt.eval").warning(
            "eval: config mesh unavailable in this job (%s); evaluating unsharded", e)
        mesh, dev = None, apply_platform(args)

    num_tags = cfg.model.num_classes if cfg.model.multilabel else None
    if is_pack(cfg.data.val_list):
        dataset = open_dataset(cfg.data.val_list, cfg.data, mode="eval",
                               num_tags=num_tags)
    else:
        cidx = (ucf101.load_class_index(args.class_index)
                if args.class_index else None)
        records = ucf101.load_video_list(cfg.data.val_list, cfg.data.root, cidx)
        dataset = ClipDataset(records, cfg.data, mode="eval", num_tags=num_tags)

    kw = {} if mesh is None or mesh.model_group is None else {"shard_axis": mesh.model_group}
    model = model_from_config(cfg.model, device=dev, clip_shape=config_clip_shape(cfg.data),
                              **kw)
    # Weights only: evaluation needs no optimizer state, so this CLI's
    # optimizer flags need not match the training run's. The checkpoint
    # holds whole tensors; a channel-sharded model takes its parts.
    state_dict, _step = CheckpointManager(args.checkpoint_dir).restore_weights()
    if state_dict is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
    variables = {k: v.to(dev) for k, v in local_parts(model, state_dict).items()}
    apply_fn = None
    if args.int8:
        d = cfg.data
        dtype = getattr(torch, cfg.model.compute_dtype)
        calib = []
        for i in range(min(args.int8_calib_videos, len(dataset))):
            clips_u8, _ = dataset.get_eval_clips(i)
            calib.append(preprocess_eval_clip(
                torch.from_numpy(np.ascontiguousarray(clips_u8)).to(dev), d.resize_hw,
                d.crop_hw, d.mean, d.std, out_dtype=dtype))
        variables, apply_fn = make_int8_apply(cfg.model.name, variables, calib,
                                              multilabel=cfg.model.multilabel)
    out = evaluate(model, variables, dataset, cfg, clip_batch=args.clip_batch,
                   threshold=args.threshold, apply_fn=apply_fn, mesh=mesh)
    if mesh is None or mesh.is_main:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
    finish_multihost()
