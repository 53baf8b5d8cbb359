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


def device_of(tree) -> torch.device:
    """The device of the first tensor in ``tree``: a tensor, or dicts, lists
    and tuples of them at any depth (a state_dict, a qpack)."""
    stack = [tree]
    while stack:
        node = stack.pop(0)
        if torch.is_tensor(node):
            return node.device
        if isinstance(node, dict):
            stack[:0] = list(node.values())
        elif isinstance(node, (list, tuple)):
            stack[:0] = list(node)
    raise ValueError("variables hold no tensor to take the device from")
