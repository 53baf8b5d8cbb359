"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
card and no explicit ``device="cpu"`` they raise instead of quietly running
on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the host (the kernels then take their plain PyTorch versions)")
    return dev
