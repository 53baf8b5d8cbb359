"""Host pipeline throughput benchmark (the counterpart of
``fastvideotagging_tpu/cli/bench_loader.py``): decode -> batch -> card.

    python -m fastvideotagging_tpu_torch.cli.bench_loader [--videos 12] [--batch 8]

Generates synthetic ``.mp4`` videos (needs cv2), then measures: (1) host
decode + sample clips/s, (2) the packed tier (``.fvtpack``, no decode in the
loop) clips/s, (3) the loader through ``device_prefetch`` onto the card
(``--device cpu`` for the host). One JSON line of scalars.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
import time

import torch

from fastvideotagging_tpu_torch._device import resolve_device
from fastvideotagging_tpu_torch.config import ClipSamplerConfig, DataConfig
from fastvideotagging_tpu_torch.data import synthetic
from fastvideotagging_tpu_torch.data.packed import PackedDataset, write_pack
from fastvideotagging_tpu_torch.data.pipeline import ClipDataset, device_prefetch, train_batches
from fastvideotagging_tpu_torch.data.ucf101 import load_video_list


def measure(videos=12, frames=64, size=(240, 320), clip_len=16, batch=8,
            workers=8, epochs=3, device: str | torch.device = "cuda") -> dict:
    """Decode -> batch -> device throughput on synthetic mp4s; returns scalars."""
    dev = resolve_device(device)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        list_path = synthetic.make_dataset(
            root, num_classes=videos, videos_per_class=1,
            num_frames=frames, height=size[0], width=size[1],
        )
        gen_s = time.perf_counter() - t0
        records = load_video_list(list_path, root=root)
        cfg = DataConfig(
            source_hw=tuple(size), resize_hw=(128, 171),
            crop_hw=(112, 112),
            sampler=ClipSamplerConfig(clip_len=clip_len),
            num_workers=workers,
        )
        ds = ClipDataset(records, cfg, mode="train")
        batch = min(batch, len(records))  # drop_last needs >= 1 batch

        # a warm epoch (probe caches, the thread pool), then timed epochs
        for _ in train_batches(ds, batch, 0, num_workers=workers):
            pass
        # (1) host decode -> batch, no device copy
        t0 = time.perf_counter()
        n_clips = 0
        for epoch in range(1, epochs + 1):
            for b in train_batches(ds, batch, epoch, num_workers=workers):
                n_clips += b["frames"].shape[0]
        clips_s = n_clips / (time.perf_counter() - t0)

        # (2) end to end with the copy to the device (device_prefetch: a
        # producer thread pins and copies on a side stream)
        t0 = time.perf_counter()
        n_dev = 0
        source = train_batches(ds, batch, 1, num_workers=workers)
        for b in device_prefetch(source, dev):
            n_dev += b["frames"].shape[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dev_dt = time.perf_counter() - t0

        # (3) the decode-once packed tier: the same records packed once at
        # the ship geometry (no source_hw: ship == resize_hw), then served
        # from the mmap with no decode
        cfg_packed = dataclasses.replace(cfg, source_hw=None)
        pack_path = f"{root}/bench.fvtpack"
        t0 = time.perf_counter()
        write_pack(records, pack_path, cfg_packed.resize_hw)
        pack_s = time.perf_counter() - t0
        pds = PackedDataset(pack_path, cfg_packed, mode="train")
        for _ in train_batches(pds, batch, 0, num_workers=workers):
            pass  # warm (page cache, thread pool)
        t0 = time.perf_counter()
        n_packed = 0
        for epoch in range(1, epochs + 1):
            for b in train_batches(pds, batch, epoch, num_workers=workers):
                n_packed += b["frames"].shape[0]
        packed_s = n_packed / (time.perf_counter() - t0)
        return {
            "decode_clips_per_sec": round(clips_s, 2),
            "decode_frames_per_sec": round(clips_s * clip_len, 1),
            "packed_clips_per_sec": round(packed_s, 2),
            "packed_frames_per_sec": round(packed_s * clip_len, 1),
            "pack_write_s": round(pack_s, 1),
            "with_device_put_clips_per_sec": round(n_dev / dev_dt, 2),
            "source": f"{size[0]}x{size[1]} mp4",
            "workers": workers,
            "device": str(dev),
            "video_gen_s": round(gen_s, 1),
        }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--videos", type=int, default=12)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--size", type=int, nargs=2, default=(240, 320))
    p.add_argument("--clip-len", type=int, default=16)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    out = measure(args.videos, args.frames, tuple(args.size), args.clip_len,
                  args.batch, args.workers, args.epochs, device=args.device)
    out["note"] = ("compare packed_clips_per_sec with the train step's clips/s "
                   "(chip_smoke.py phase 5) to size the decode hosts")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
