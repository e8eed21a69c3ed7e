"""On-device normalisation (port of ``vae_connexe_tpu/utils/scalers.py``,
``standardize`` only)."""

from __future__ import annotations

import torch


def standardize(series: torch.Tensor, axis: int = 0,
                eps: float = 1e-8) -> torch.Tensor:
    """Zero-mean unit-variance per variable along ``axis`` (time).  The
    population standard deviation, as ``jnp.std``."""
    mean = series.mean(dim=axis, keepdim=True)
    std = series.std(dim=axis, keepdim=True, correction=0)
    return (series - mean) / (std + eps)
