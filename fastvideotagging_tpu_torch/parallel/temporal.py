"""Temporal (sequence) sharding for long clips: the counterpart of
``fastvideotagging_tpu/parallel/temporal.py``.

A clip's time axis T is split over the ranks of a time group, rank r
holding frames ``[r * T / n, (r + 1) * T / n)``. A k x 1 x 1 conv with
symmetric padding p = k // 2 then needs p frames of each neighbour: every
rank sends its first p frames left and its last p frames right (the halo
exchange), and the clip's two ends see zeros, as the unsharded conv's zero
padding gives. The only traffic a temporal conv adds is 2p frames a rank
each way.

The conv over the halo'd slab of ``T_local + 2p`` frames runs K2 (the hand
kernel of ops/conv2plus1d.py) where the slab is eligible and the stride is
1: K2 pads the slab's ends with zeros, and its output frames ``p ...
p + T_local - 1`` read only slab frames, so they are the VALID conv of the
slab, which is the unsharded conv's output on this rank's frames. The
frames around them are computed and dropped: 2p / T_local more frames than
the shard's own (25 % at T_local = 8, k = 3). Its backward is K2's dx and
K3's dw through ``_TemporalOp``, with a zero gradient at the dropped frames.
A strided conv (a stage entry) or a slab K2 does not take goes to
``F.conv3d`` over the slab without padding, as the reference computes the
halo conv with XLA's conv.

Transport: NCCL and gloo on CPU tensors send the halos rank to rank;
gloo's point-to-point does not take CUDA tensors, so on a gloo group the
halos of CUDA tensors are staged through the host (``halo_transport``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from fastvideotagging_tpu_torch.ops import conv2plus1d as ops

# Per process: slab convs routed to K2 (``temporal_conv``, the kernel on a
# card), halo exchanges run forward and backward, and the bytes this rank
# sent in each direction.
halo_counts = {"k2_slabs": 0, "exchanges_fwd": 0, "exchanges_bwd": 0,
               "bytes_fwd": 0, "bytes_bwd": 0}


def reset_halo_counts() -> None:
    for key in halo_counts:
        halo_counts[key] = 0


def halo_transport(group, device: torch.device) -> str:
    """'host' where the group's point-to-point cannot take tensors on
    ``device`` (gloo and CUDA: the halos are copied to the host, sent, and
    copied back); 'direct' otherwise."""
    if device.type == "cuda" and dist.get_backend(group) == "gloo":
        return "host"
    return "direct"


def _swap(head: torch.Tensor, tail: torch.Tensor, group) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Send ``head`` to the left neighbour and ``tail`` to the right one;
    return the left neighbour's tail and the right neighbour's head (zeros
    where the clip ends: rank 0 has no left, the last rank no right) and
    the bytes sent."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    device = head.device
    host = halo_transport(group, device) == "host"
    head, tail = ((a.to("cpu") if host else a).contiguous() for a in (head, tail))
    from_left, from_right = torch.zeros_like(tail), torch.zeros_like(head)
    ops_ = []
    sent = 0
    if r > 0:
        peer = dist.get_global_rank(group, r - 1)
        ops_ += [dist.P2POp(dist.isend, head, peer, group),
                 dist.P2POp(dist.irecv, from_left, peer, group)]
        sent += head.numel() * head.element_size()
    if r < n - 1:
        peer = dist.get_global_rank(group, r + 1)
        ops_ += [dist.P2POp(dist.isend, tail, peer, group),
                 dist.P2POp(dist.irecv, from_right, peer, group)]
        sent += tail.numel() * tail.element_size()
    if ops_:
        for req in dist.batch_isend_irecv(ops_):
            req.wait()
    if host:
        from_left, from_right = from_left.to(device), from_right.to(device)
    return from_left, from_right, sent


class HaloExchange(torch.autograd.Function):
    """x_local (B, T, ...) -> (B, p + T + p, ...): the left neighbour's last
    p frames, x_local, the right neighbour's first p frames (zeros at the
    clip's ends). Backward: each halo's gradient goes back to the rank it
    came from and is added into those frames; the clip's ends send none."""

    @staticmethod
    def forward(ctx, x, p: int, group):
        ctx.p, ctx.group = p, group
        from_left, from_right, sent = _swap(x[:, :p], x[:, -p:], group)
        halo_counts["exchanges_fwd"] += 1
        halo_counts["bytes_fwd"] += sent
        return torch.cat([from_left, x, from_right], dim=1)

    @staticmethod
    def backward(ctx, g):
        p = ctx.p
        to_left, to_right = g[:, :p], g[:, -p:]
        from_left, from_right, sent = _swap(to_left, to_right, ctx.group)
        halo_counts["exchanges_bwd"] += 1
        halo_counts["bytes_bwd"] += sent
        dx = g[:, p:-p].clone()
        dx[:, :p] += from_left
        dx[:, -p:] += from_right
        return dx, None, None


def halo_temporal_conv(x_local: torch.Tensor, w: torch.Tensor, group,
                       stride: int = 1, kernels: bool = True) -> torch.Tensor:
    """k x 1 x 1 symmetric-padded conv over a time-sharded clip.

    x_local: (B, T_local, H, W, C), this rank's frames of the clip; w: (k,
    C, Co), k odd; ``group``: the time group, ranks in clip order. Returns
    (B, T_local // stride, H, W, Co). A strided conv needs ``T_local %
    stride == 0`` (every rank owns whole output frames and the sampling
    phase is aligned over the clip). ``kernels``: the slab may go to K2
    (the 'cuda' conv backend); False keeps ``F.conv3d`` (the 'torch' one).
    """
    k = w.shape[0]
    p = k // 2
    t = x_local.shape[1]
    if stride > 1 and t % stride:
        raise ValueError(f"stride={stride} must divide T_local={t}")
    if p == 0:  # no halo: the local conv
        if kernels:
            return ops.temporal_conv(x_local, w, stride=stride)
        return ops.conv3d_nthwc(x_local, w[:, None, None], (stride, 1, 1), (0, 0, 0))
    if t < p:
        raise ValueError(f"T_local={t} must be >= halo {p}; use fewer shards")
    x_ext = HaloExchange.apply(x_local, p, group)
    if kernels and stride == 1 and ops.temporal_eligible(x_ext.shape, k, 1):
        halo_counts["k2_slabs"] += 1
        return ops.temporal_conv(x_ext, w)[:, p:p + t]
    return ops.conv3d_nthwc(x_ext, w[:, None, None], (stride, 1, 1), (0, 0, 0))


def time_shard(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of frames of ``x`` (B, T, ...); raises unless the
    group divides T."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    t = x.shape[1]
    if t % n:
        raise ValueError(f"T={t} must be divisible by n_shards={n}")
    return x[:, r * (t // n):(r + 1) * (t // n)]


def temporal_conv_time_sharded(x: torch.Tensor, w: torch.Tensor, group,
                               stride: int = 1) -> torch.Tensor:
    """Whole-array wrapper: every rank passes the whole clip x (B, T, H, W,
    C), T divisible by the group's size; each convolves its block with the
    halo conv, and the blocks are all-gathered, so every rank returns the
    whole (B, T // stride, H, W, Co) output."""
    y = halo_temporal_conv(time_shard(x, group), w, group, stride=stride)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y.contiguous(), group=group)
    return torch.cat(parts, dim=1)
