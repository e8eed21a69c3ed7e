"""Closed-form Cauchy-Schwarz divergence between a diagonal Gaussian
posterior and a learnable equal-weight GMM prior (port of
``vae_connexe_tpu/losses/cs_divergence.py``).

D_CS(q || p) = -log int qp + 1/2 log int p^2 + 1/2 log int q^2, each cross
term a Gaussian overlap N(mu_1 | mu_2, S_1 + S_2) (diagonal).  The two
variants differ only in the int p^2 term:

- ``variant='paper'``: pairwise overlaps N(mu_k | mu_k', 2 s_k'^2), zero
  variance on the first argument;
- ``variant='symmetric'``: the symmetric overlap N(mu_k | mu_k', s_k^2 +
  s_k'^2).

Every term stays in log space end to end (``torch.logsumexp`` over the
mixture's components, minus log K or log K^2), so the value and its
gradient stay finite where exponentiating the overlaps and taking their
log again would underflow.
"""

from __future__ import annotations

import math

import torch


def log_gaussian_overlap(mu1: torch.Tensor, var1: torch.Tensor,
                         mu2: torch.Tensor, var2: torch.Tensor) -> torch.Tensor:
    """log N(mu1 | mu2, S1 + S2) for diagonal covariances; broadcasts the
    leading axes.  Inputs have a trailing latent axis D; the result drops
    it."""
    var_sum = var1 + var2
    diff = mu1 - mu2
    d = mu1.shape[-1]
    log_norm = (-0.5 * d * math.log(2.0 * math.pi)
                - 0.5 * torch.sum(torch.log(var_sum), dim=-1))
    log_exp = -0.5 * torch.sum(diff ** 2 / var_sum, dim=-1)
    return log_norm + log_exp


def cs_divergence_gmm(mu_q: torch.Tensor, var_q: torch.Tensor,
                      mu_p: torch.Tensor, var_p: torch.Tensor,
                      variant: str = "symmetric") -> torch.Tensor:
    """D_CS(q || GMM p) per batch element, clamped at 0.

    mu_q, var_q: (B, D) posterior mean and variance; mu_p, var_p: (K, D)
    the mixture's component means and variances (equal weights); variant:
    'symmetric' or 'paper', the int p^2 convention.  Returns (B,).
    """
    k = mu_p.shape[0]
    d = mu_q.shape[-1]
    # log int qp = logmeanexp_k log N(mu_q | mu_k, s_q^2 + s_k^2)
    log_qp = log_gaussian_overlap(mu_q[:, None, :], var_q[:, None, :],
                                  mu_p[None, :, :], var_p[None, :, :])
    log_term1 = torch.logsumexp(log_qp, dim=1) - math.log(k)
    # log int p^2 = logmeanexp_{k,k'} of the pairwise overlap.
    if variant == "symmetric":
        log_pp = log_gaussian_overlap(mu_p[:, None, :], var_p[:, None, :],
                                      mu_p[None, :, :], var_p[None, :, :])
    elif variant == "paper":
        zeros = torch.zeros_like(var_p)
        log_pp = log_gaussian_overlap(mu_p[:, None, :], zeros[:, None, :],
                                      mu_p[None, :, :],
                                      2.0 * var_p[None, :, :])
    else:
        raise ValueError(f"unknown variant {variant!r}")
    log_term2 = torch.logsumexp(log_pp.reshape(-1), dim=0) - math.log(k * k)
    # log int q^2 = log N(mu_q | mu_q, 2 s_q^2)
    log_term3 = (-0.5 * d * math.log(2.0 * math.pi)
                 - 0.5 * torch.sum(torch.log(2.0 * var_q), dim=-1))
    cs = -log_term1 + 0.5 * log_term2 + 0.5 * log_term3
    return torch.clamp(cs, min=0.0)
