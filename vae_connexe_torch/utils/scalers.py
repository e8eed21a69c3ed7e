"""On-device normalisation (port of ``vae_connexe_tpu/utils/scalers.py``)."""

from __future__ import annotations

import torch


def minmax_scale(data: torch.Tensor) -> torch.Tensor:
    """Min-max normalise over every axis but the last (per feature): the
    reference's min and max over axes (0, 1) of an (N, T, D) array; values
    land in [0, 1] per feature."""
    reduce_axes = tuple(range(data.ndim - 1))
    min_val = torch.amin(data, dim=reduce_axes)
    shifted = data - min_val
    max_val = torch.amax(shifted, dim=reduce_axes)
    return shifted / (max_val + 1e-7)


def standardize(series: torch.Tensor, axis: int = 0,
                eps: float = 1e-8) -> torch.Tensor:
    """Zero-mean unit-variance per variable along ``axis`` (time).  The
    population standard deviation, as ``jnp.std``."""
    mean = series.mean(dim=axis, keepdim=True)
    std = series.std(dim=axis, keepdim=True, correction=0)
    return (series - mean) / (std + eps)
