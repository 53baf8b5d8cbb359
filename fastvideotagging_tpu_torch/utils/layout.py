"""Tensor layout helpers (the counterpart of
``fastvideotagging_tpu/utils/layout.py``).

Public boundaries are NTHWC (channels-last), as in the JAX package; these
adapters convert from and to the NCTHW layout of PyTorch's ``conv3d`` and of
the reference's MXNet models. Both return views.
"""

from __future__ import annotations

import torch


def ncthw_to_nthwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1)


def nthwc_to_ncthw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)
