"""Shape and device helpers shared by the port's kernel wrappers."""

from __future__ import annotations

import torch


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_device(requested=None) -> torch.device:
    """The device an entry point that allocates should use.

    ``None`` means the card: it returns ``cuda`` and raises when no
    CUDA device is present. The CPU is used only when the caller asks
    for it by name (``"cpu"``), as the tests do; there is no silent
    fallback from the card to the CPU."""
    if requested is None:
        requested = "cuda"
    dev = torch.device(requested)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device={requested!r}: expected 'cuda' or 'cpu'")
    return dev
