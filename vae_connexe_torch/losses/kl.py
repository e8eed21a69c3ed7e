"""Gaussian KL terms (port of ``vae_connexe_tpu/losses/kl.py``): the
log-variance form summed over the latent and averaged over the batch
(``kl_gaussian``), and the log-sigma form with a mean or batch-normalised
sum (``kl_gaussian_logsigma``, the W_in trainer's)."""

from __future__ import annotations

import torch


def kl_gaussian(mu: torch.Tensor, logvar: torch.Tensor, *,
                keep: int = 0) -> torch.Tensor:
    """KL(N(mu, exp(logvar)) || N(0, I)): sum over the last dim, mean over
    the rest but the first ``keep`` axes (a seed axis), which are kept."""
    per_sample = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar),
                                  dim=-1)
    if keep:
        return per_sample.mean(dim=tuple(range(keep, per_sample.ndim)))
    return per_sample.mean()


def kl_gaussian_logsigma(mu: torch.Tensor, logsigma: torch.Tensor,
                         reduction: str = "mean", *,
                         keep: int = 0) -> torch.Tensor:
    """KL with a log-sigma parameterisation:
    -0.5 * reduce(1 + 2 logsigma - mu^2 - exp(2 logsigma)).

    reduction='mean': mean over every element; 'sum_over_batch': sum over
    everything / batch (the batch axis is the first after the ``keep``
    leading axes, which are kept: one value each, e.g. a seed axis).
    """
    terms = -0.5 * (1.0 + 2.0 * logsigma - mu ** 2 - torch.exp(2.0 * logsigma))
    dims = tuple(range(keep, terms.ndim))
    if reduction == "mean":
        return terms.mean(dim=dims)
    if reduction == "sum_over_batch":
        return terms.sum(dim=dims) / mu.shape[keep]
    raise ValueError(f"unknown reduction {reduction!r}")
