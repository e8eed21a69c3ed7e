"""Gaussian KL term (port of ``vae_connexe_tpu/losses/kl.py``, ``kl_gaussian``)."""

from __future__ import annotations

import torch


def kl_gaussian(mu: torch.Tensor, logvar: torch.Tensor,
                keep: int = 0) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, I)): sum over the last dim, mean over
    the rest but the first ``keep`` axes (a seed axis), which are kept."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar),
                                  dim=-1)
    if keep:
        return per_sample.mean(dim=tuple(range(keep, per_sample.ndim)))
    return per_sample.mean()
