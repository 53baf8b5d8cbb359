"""The factorized (2+1)D convolutions: hand-written Hopper kernels, their
plain PyTorch versions, and the routing of the JAX package's
``ops/conv2plus1d.py`` (``spatial_conv`` / ``temporal_conv``).

- ``spatial_conv_kernel`` (K1, csrc/conv2plus1d.cu) replaces the TPU kernel
  ``_spatial_kernel`` / ``_spatial_pallas``: a stride-1 1 x k x k conv.
- ``temporal_conv_kernel`` (K2) replaces ``_temporal_kernel`` /
  ``_temporal_pallas``: a stride-1 k x 1 x 1 conv.

Each wrapper (``spatial_conv_cuda`` / ``temporal_conv_cuda``) takes bf16
contiguous CUDA tensors, launches its kernel on the current stream, raises if
the launch fails, and adds one to ``launch_counts``. ``spatial_conv`` /
``temporal_conv`` send a CUDA tensor to the kernel and a CPU tensor to the
plain version (``spatial_conv_plain`` / ``temporal_conv_plain``: the same
arithmetic as k or k*k shifted matmuls into an f32 accumulator); nothing
falls back from the kernel to the plain version.

Convs the kernels do not take (strided stage entries, the 3-channel stem,
C < MIN_C) go to ``F.conv3d``, as the JAX package sends them to
``lax.conv_general_dilated``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from fastvideotagging_tpu_torch.ops import _build

# Kernel eligibility (the JAX package's MIN_C): narrower contractions stay
# with the library conv.
MIN_C = 32

# Kernel launches since the last reset, by kernel.
launch_counts = {"spatial_conv": 0, "temporal_conv": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


_lib = None


def _kernels() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("conv2plus1d")
        for fn in (lib.fvt_spatial_conv_bf16, lib.fvt_temporal_conv_bf16):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_args(x: torch.Tensor, w: torch.Tensor, x_dims: int,
                       w_shape: tuple) -> None:
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be bfloat16, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")
    if x.ndim != x_dims:
        raise ValueError(f"x must have {x_dims} dims, got {tuple(x.shape)}")
    if tuple(w.shape) != w_shape:
        raise ValueError(f"w must be {w_shape}, got {tuple(w.shape)}")
    if w_shape[0] % 2 == 0:
        raise ValueError(f"kernel size must be odd, got {w_shape[0]}")


def _route(kernel, plain, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel for a CUDA tensor, its plain version for a CPU tensor."""
    if x.is_cuda:
        return kernel(x, w)
    if x.device.type != "cpu":
        raise ValueError(f"no kernel for device {x.device}")
    return plain(x, w)


def _launch(fn, x, w, y, dims, k) -> None:
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), *dims, k,
            x.device.index, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Spatial 1 x k x k conv
# ---------------------------------------------------------------------------


def spatial_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K1: x (N, H, W, C), w (k, k, C, Co), both bf16 contiguous on CUDA ->
    (N, H, W, Co) bf16. Stride 1, zero padding k//2."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    _check_kernel_args(x, w, 4, (k, k, c, w.shape[-1]))
    y = torch.empty((n, h, wd, w.shape[-1]), dtype=x.dtype, device=x.device)
    _launch(_kernels().fvt_spatial_conv_bf16, x, w, y, (n, h, wd, c, w.shape[-1]), k)
    launch_counts["spatial_conv"] += 1
    return y


def spatial_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of K1: k*k shifted (N*H*W, C) @ (C, Co) matmuls
    into an f32 accumulator, cast to x's dtype."""
    k = w.shape[0]
    n, h, wd, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, p, p, p, p))
    acc = torch.zeros((n, h, wd, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dh in range(k):
        for dw in range(k):
            acc += xp[:, dh : dh + h, dw : dw + wd, :].float() @ w[dh, dw].float()
    return acc.to(x.dtype)


def spatial_eligible(x_shape, k: int, stride: int) -> bool:
    """Whether the 1 x k x k conv goes to K1. The JAX routing also asks
    for an H tile of at least k-1 rows, a limit of its VMEM halo scheme
    that this kernel does not have (it holds at every path shape)."""
    _, _, h, w, c = x_shape
    return stride == 1 and c >= MIN_C and h >= k and w >= k and k % 2 == 1


def spatial_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """1 x k x k conv on NTHWC input. x: (B, T, H, W, C); w: (k, k, C, Co)."""
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    if spatial_eligible(x.shape, k, stride):
        x4 = x.reshape(b * t, h, wd, c).contiguous()
        y = _route(spatial_conv_cuda, spatial_conv_plain, x4, w.contiguous())
        return y.reshape(b, t, h, wd, -1)
    p = k // 2
    return conv3d_nthwc(x, w[None], (1, stride, stride), (0, p, p))


# ---------------------------------------------------------------------------
# Temporal k x 1 x 1 conv
# ---------------------------------------------------------------------------


def temporal_conv_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K2: x (B, T, S, C), w (k, C, Co), both bf16 contiguous on CUDA ->
    (B, T, S, Co) bf16. Stride 1, zero rows beyond the T edges."""
    k = w.shape[0]
    b, t, s, c = x.shape
    _check_kernel_args(x, w, 4, (k, c, w.shape[-1]))
    y = torch.empty((b, t, s, w.shape[-1]), dtype=x.dtype, device=x.device)
    _launch(_kernels().fvt_temporal_conv_bf16, x, w, y, (b, t, s, c, w.shape[-1]), k)
    launch_counts["temporal_conv"] += 1
    return y


def temporal_conv_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version of K2: k shifted (B*T*S, C) @ (C, Co) matmuls into
    an f32 accumulator, cast to x's dtype."""
    k = w.shape[0]
    b, t, s, c = x.shape
    p = k // 2
    xp = F.pad(x, (0, 0, 0, 0, p, p))
    acc = torch.zeros((b, t, s, w.shape[-1]), dtype=torch.float32, device=x.device)
    for dt in range(k):
        acc += xp[:, dt : dt + t].float() @ w[dt].float()
    return acc.to(x.dtype)


def temporal_eligible(x_shape, k: int, stride: int) -> bool:
    """Whether the k x 1 x 1 conv goes to K2 (the JAX routing)."""
    _, t, _, _, c = x_shape
    return stride == 1 and c >= MIN_C and t >= 2 and k % 2 == 1


def temporal_conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """k x 1 x 1 conv on NTHWC input. x: (B, T, H, W, C); w: (k, C, Co)."""
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    if temporal_eligible(x.shape, k, stride):
        x4 = x.reshape(b, t, h * wd, c).contiguous()
        y = _route(temporal_conv_cuda, temporal_conv_plain, x4, w.contiguous())
        return y.reshape(b, t, h, wd, -1)
    p = k // 2
    return conv3d_nthwc(x, w[:, None, None], (stride, 1, 1), (p, 0, 0))


# ---------------------------------------------------------------------------
# Library conv (the 'torch' kernels setting and the ineligible convs)
# ---------------------------------------------------------------------------


def conv3d_nthwc(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """``F.conv3d`` on NTHWC input with a (kt, kh, kw, Cin, Cout) kernel.

    The NTHWC tensor is passed as a channels-last-3d NCDHW view (no copy);
    the result comes back NTHWC and contiguous."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 4, 1).contiguous()
