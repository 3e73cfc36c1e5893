# Frozen copy of cips3dpp_torch/device.py at commit af17e715d5a8,
# the plain path only: the yardstick keeps this copy whatever the program
# becomes. Edits from the source are marked "portbench:".
"""Device choice for the port's entry points.

Entry points default to the card. A host without one raises instead of
quietly running on the CPU: the CPU runs only the plain versions of the
kernels, and only when the caller asks for it with `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". Raises when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def check_on(tensor: torch.Tensor, device: torch.device, what: str) -> None:
    """Raise if `tensor` does not live on `device` (no implicit copies)."""
    if tensor.device.type != device.type or (
        device.index is not None and tensor.device.index != device.index
    ):
        raise ValueError(f"{what} is on {tensor.device}, expected {device}")
