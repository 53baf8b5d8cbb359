"""Eval CLI (the counterpart of ``fastvideotagging_tpu/cli/evaluate.py``):
the UCF101 parity protocol as one command.

    python -m fastvideotagging_tpu_torch.cli.evaluate --preset ucf101_parity \
        --data-root /data/ucf101 --val-list testlist01.txt \
        --class-index classInd.txt --checkpoint-dir checkpoints

Restores the weights of the latest checkpoint of a port training run
(``train/checkpoint.py``; the optimizer state is not read), evaluates a
``.fvtpack`` or a video list on the card (``--device cpu`` for the host)
and prints one JSON line of metrics. ``--int8`` is not ported yet
(ROADMAP.md Queue A item 5); a config that asks for several devices is
evaluated on one card (the multi-device evaluation is item 7).
"""

from __future__ import annotations

import argparse
import json

from fastvideotagging_tpu_torch.cli.common import (
    add_common_flags,
    add_multihost_flags,
    apply_platform,
    build_config,
)
from fastvideotagging_tpu_torch.data import ucf101
from fastvideotagging_tpu_torch.data.packed import is_pack, open_dataset
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset
from fastvideotagging_tpu_torch.evaluation.evaluate import evaluate
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, model_from_config
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
                   help="not ported yet (ROADMAP.md Queue A item 5)")
    p.add_argument("--int8-calib-videos", type=int, default=8)
    add_multihost_flags(p)
    args = p.parse_args(argv)
    dev = apply_platform(args)
    cfg = build_config(args)
    if args.int8:
        raise NotImplementedError(
            "--int8 needs the int8 engine, which is not ported yet "
            "(ROADMAP.md Queue A item 5)")

    num_tags = cfg.model.num_classes if cfg.model.multilabel else None
    if is_pack(cfg.data.val_list):
        dataset = open_dataset(cfg.data.val_list, cfg.data, mode="eval",
                               num_tags=num_tags)
    else:
        cidx = (ucf101.load_class_index(args.class_index)
                if args.class_index else None)
        records = ucf101.load_video_list(cfg.data.val_list, cfg.data.root, cidx)
        dataset = ClipDataset(records, cfg.data, mode="eval", num_tags=num_tags)

    model = model_from_config(cfg.model, device=dev, clip_shape=config_clip_shape(cfg.data))
    # Weights only: evaluation needs no optimizer state, so this CLI's
    # optimizer flags need not match the training run's.
    state_dict, _step = CheckpointManager(args.checkpoint_dir).restore_weights()
    if state_dict is None:
        raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
    if cfg.parallel.data_parallel > 1 or cfg.parallel.model_parallel > 1:
        get_logger("fvt.eval").warning(
            "eval: the config asks for data_parallel=%d, model_parallel=%d; "
            "evaluating on one card (multi-device evaluation is ROADMAP.md "
            "Queue A item 7)", cfg.parallel.data_parallel, cfg.parallel.model_parallel)
    variables = {k: v.to(dev) for k, v in state_dict.items()}
    out = evaluate(model, variables, dataset, cfg, clip_batch=args.clip_batch,
                   threshold=args.threshold)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
