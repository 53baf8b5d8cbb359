"""Train CLI (the counterpart of ``fastvideotagging_tpu/cli/train.py``).

    python -m fastvideotagging_tpu_torch.cli.train --preset r2plus1d18_ucf101 \
        --train-list train.fvtpack --val-list val.fvtpack \
        --checkpoint-dir ckpt --metrics-jsonl metrics.jsonl

Trains on the card unless ``--device cpu`` is given; without a card it
raises. ``--train-list`` is a ``.fvtpack`` (labels inside) or a video list
(``path label`` rows, ``--class-index`` for UCF101's 1-based lists,
``--tag-lists`` for ``path tag_a,tag_b`` rows).
"""

from __future__ import annotations

import argparse

from fastvideotagging_tpu_torch.cli.common import (
    add_common_flags,
    add_train_flags,
    build_config,
)
from fastvideotagging_tpu_torch.data import ucf101
from fastvideotagging_tpu_torch.data.packed import Pack, is_pack
from fastvideotagging_tpu_torch.models.zoo import config_clip_shape, load_pretrained
from fastvideotagging_tpu_torch.train.fit import fit


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    add_common_flags(p)
    add_train_flags(p)
    p.add_argument("--class-index", default=None,
                   help="UCF101 classInd.txt (enables 1-based label parsing)")
    p.add_argument("--tag-lists", action="store_true",
                   help="parse lists as multi-label tag lists")
    p.add_argument("--pretrained", default=None,
                   help="initial weights: an export of this port (export_weights) or a "
                        "public torch checkpoint (.pth/.pt; models/torch_import.py); a "
                        "head of another class count is re-initialized")
    return p.parse_args(argv)


def load_records(cfg, args):
    """-> (train records or pack path, val records or pack path or None,
    num_tags or None)."""
    if is_pack(cfg.data.train_list):
        # Decode-once tier: labels/tags live inside the pack; pass the
        # paths straight through (fit/make_eval_fn open PackedDatasets).
        if args.class_index:
            raise SystemExit(
                "--class-index is unused with a .fvtpack train list: "
                "labels were resolved when the pack was written")
        val = cfg.data.val_list or None
        if val is not None and not is_pack(val):
            raise SystemExit(
                "--train-list is a .fvtpack but --val-list is not; pack "
                "both splits or neither")
        num_tags = None
        if args.tag_lists:
            num_tags = Pack(cfg.data.train_list).num_tags
            if num_tags is None:
                raise SystemExit(
                    "--tag-lists: this pack carries no tag sets (it was "
                    "written from class lists); re-pack the tag lists")
        return cfg.data.train_list, val, num_tags
    cidx = (ucf101.load_class_index(args.class_index)
            if args.class_index else None)
    num_tags = None
    if args.tag_lists:
        train, tag_index = ucf101.load_tag_list(cfg.data.train_list, cfg.data.root)
        val = (ucf101.load_tag_list(cfg.data.val_list, cfg.data.root, tag_index)[0]
               if cfg.data.val_list else None)
        num_tags = len(tag_index)
    else:
        train = ucf101.load_video_list(cfg.data.train_list, cfg.data.root, cidx)
        val = (ucf101.load_video_list(cfg.data.val_list, cfg.data.root, cidx)
               if cfg.data.val_list else None)
    return train, val, num_tags


def main(argv=None):
    """Train per the flags; returns the final TrainState."""
    args = parse_args(argv)
    cfg = build_config(args)
    train_records, val_records, num_tags = load_records(cfg, args)
    init_variables = None
    if args.pretrained:
        # on the host: fit moves the weights into its own model
        _, init_variables = load_pretrained(
            cfg.model.name, args.pretrained, num_classes=cfg.model.num_classes,
            device="cpu", clip_shape=config_clip_shape(cfg.data))
    return fit(cfg, train_records, val_records=val_records, num_tags=num_tags,
               metrics_path=args.metrics_jsonl, init_variables=init_variables,
               device=args.device)


if __name__ == "__main__":
    main()
