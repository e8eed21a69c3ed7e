"""The port's default-device rule.

Entry points run on the card.  They take a ``device`` argument; ``None``
means ``cuda``, and with no CUDA device that is an error rather than a
silent move to the CPU.  The CPU is used only when the caller names it
(``device="cpu"``), as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises without a card); otherwise ``device``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "vae_connexe_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)
