"""Dataset preparation CLI (the counterpart of
``fastvideotagging_tpu/cli/prepare.py``).

Scans a UCF101-style directory tree (``root/ClassName/video.ext``) and writes
``classInd.txt`` plus train/val split lists for cli/train.py, byte for byte
the JAX CLI's for the same tree, seed and fraction:

    python -m fastvideotagging_tpu_torch.cli.prepare /data/ucf101 \
        --val-fraction 0.25 --seed 0 --out /data/ucf101 [--pack]

``--pack`` (or ``--pack-lists``) decodes each video once into ``.fvtpack``
files (data/packed.py; the host resize is the C tier, data/frames.py).
Runs on the host only.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

VIDEO_EXTS = (".avi", ".mp4", ".mkv", ".mov", ".webm", ".m4v")


def scan_tree(root: str) -> dict[str, list[str]]:
    """{class_name: [relative video paths]} for root/Class/video.ext trees."""
    classes: dict[str, list[str]] = {}
    for entry in sorted(os.scandir(root), key=lambda e: e.name):
        if not entry.is_dir():
            continue
        vids = sorted(
            f"{entry.name}/{f}" for f in os.listdir(entry.path)
            if f.lower().endswith(VIDEO_EXTS)
        )
        if vids:
            classes[entry.name] = vids
    return classes


def write_splits(classes: dict[str, list[str]], out_dir: str,
                 val_fraction: float = 0.25, seed: int = 0) -> dict:
    """Write classInd.txt + trainlist01.txt + testlist01.txt (UCF101 format:
    1-based ids in the train list, bare paths in the test list)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.Generator(np.random.Philox(key=np.uint64(seed)))
    names = sorted(classes)
    with open(os.path.join(out_dir, "classInd.txt"), "w") as f:
        for i, name in enumerate(names):
            f.write(f"{i + 1} {name}\n")

    train_rows, test_rows = [], []
    for i, name in enumerate(names):
        vids = list(classes[name])
        order = rng.permutation(len(vids))
        n_val = max(1, int(round(len(vids) * val_fraction))) if len(vids) > 1 else 0
        for j, k in enumerate(order):
            if j < n_val:
                test_rows.append(vids[k])
            else:
                train_rows.append(f"{vids[k]} {i + 1}")
    with open(os.path.join(out_dir, "trainlist01.txt"), "w") as f:
        f.write("\n".join(sorted(train_rows)) + "\n")
    with open(os.path.join(out_dir, "testlist01.txt"), "w") as f:
        f.write("\n".join(sorted(test_rows)) + "\n")
    return {"classes": len(names), "train": len(train_rows),
            "val": len(test_rows)}


def pack_splits(out_dir: str, root: str, resize_hw) -> dict:
    """Decode-once step: pack both split lists that ``write_splits`` wrote to
    ``.fvtpack`` files at ``resize_hw`` (the training config's ship
    geometry)."""
    from fastvideotagging_tpu_torch.data import ucf101
    from fastvideotagging_tpu_torch.data.packed import PACK_EXT, write_pack

    cidx = ucf101.load_class_index(os.path.join(out_dir, "classInd.txt"))
    stats = {}
    for split in ("trainlist01", "testlist01"):
        records = ucf101.load_video_list(
            os.path.join(out_dir, f"{split}.txt"), root, cidx)
        stats[split] = write_pack(
            records, os.path.join(out_dir, f"{split}{PACK_EXT}"),
            resize_hw, root=root)
    return stats


def pack_lists(list_files, root: str, resize_hw, tag_lists: bool = False,
               class_index: str | None = None) -> dict:
    """Pack EXISTING split lists (no tree scan, no new splits); each
    ``x.txt`` packs to ``x.fvtpack``.

    ``tag_lists``: lists are multi-label (``path tag_a,tag_b``); the tag
    index is built from the first list in first-appearance order and reused
    for the rest, and its size is recorded in each pack.
    """
    from fastvideotagging_tpu_torch.data import ucf101
    from fastvideotagging_tpu_torch.data.packed import PACK_EXT, write_pack

    cidx = ucf101.load_class_index(class_index) if class_index else None
    tag_index = None
    stats = {}
    for lst in list_files:
        if tag_lists:
            records, tag_index = ucf101.load_tag_list(lst, root, tag_index)
            num_tags = len(tag_index)
        else:
            records = ucf101.load_video_list(lst, root, cidx)
            num_tags = None
        out = os.path.splitext(lst)[0] + PACK_EXT
        stats[os.path.basename(lst)] = write_pack(
            records, out, resize_hw, root=root, num_tags=num_tags)
    return stats


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("root", help="dataset root: root/ClassName/video.ext "
                                "(with --pack-lists: the video root the "
                                "list paths are relative to)")
    p.add_argument("--out", default=None, help="output dir (default: root)")
    p.add_argument("--val-fraction", type=float, default=0.25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pack", action="store_true",
                   help="also decode each video once into mmap-able "
                        ".fvtpack files (pass them as --train-list/--val-list)")
    p.add_argument("--pack-resize", type=int, nargs=2, default=(128, 171),
                   metavar=("H", "W"),
                   help="pack frame geometry; must equal the training "
                        "config's ship geometry: source_hw if the config "
                        "pins one, else resize_hw (default UCF101 spec 128 171)")
    p.add_argument("--pack-lists", nargs="+", metavar="LIST",
                   help="pack these existing split lists instead of "
                        "scanning root and writing new splits")
    p.add_argument("--tag-lists", action="store_true",
                   help="with --pack-lists: lists are multi-label tag "
                        "lists; the tag count is recorded in the packs")
    p.add_argument("--class-index", default=None,
                   help="with --pack-lists: classInd.txt for 1-based "
                        "label parsing")
    args = p.parse_args(argv)
    if args.tag_lists and not args.pack_lists:
        raise SystemExit("--tag-lists requires --pack-lists (the scanned "
                         "tree mode is single-label by construction)")
    if args.pack_lists:
        print(pack_lists(args.pack_lists, args.root,
                         tuple(args.pack_resize), tag_lists=args.tag_lists,
                         class_index=args.class_index))
        return
    classes = scan_tree(args.root)
    if not classes:
        raise SystemExit(f"no class directories with videos under {args.root}")
    out_dir = args.out or args.root
    stats = write_splits(classes, out_dir, args.val_fraction, args.seed)
    if args.pack:
        stats["packs"] = pack_splits(out_dir, args.root,
                                     tuple(args.pack_resize))
    print(stats)


if __name__ == "__main__":
    main()
