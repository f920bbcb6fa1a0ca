"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: the CUDA
card by default, the CPU only when the caller names it.  A request for
CUDA on a host without a card raises; nothing drifts to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; ``"cpu"`` -> the CPU.

    Raises RuntimeError when CUDA is asked for (explicitly or by
    default) and no card is present, and ValueError for any other
    device type."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
