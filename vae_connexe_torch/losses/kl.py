"""Gaussian KL term (port of ``vae_connexe_tpu/losses/kl.py``, ``kl_gaussian``)."""

from __future__ import annotations

import torch


def kl_gaussian(mu: torch.Tensor, logvar: torch.Tensor) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, I)): sum over the last dim, mean over
    the rest."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar),
                                  dim=-1)
    return per_sample.mean()
