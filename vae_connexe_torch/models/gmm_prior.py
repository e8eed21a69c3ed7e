"""Learnable isotropic Gaussian-mixture prior with equal weights (port of
``vae_connexe_tpu/models/gmm_prior.py``): K components, means drawn as
0.05 * N(0, 1), log-variances zero, trained jointly with the model."""

from __future__ import annotations

import dataclasses

import torch

from vae_connexe_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class GMMPrior:
    mu: torch.Tensor       # (K, D)
    logvar: torch.Tensor   # (K, D), log sigma_k^2

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)


def init_gmm_prior(generator: torch.Generator, k: int, latent_dim: int,
                   dtype=torch.float32, device=None) -> GMMPrior:
    """The means from one (K, D) float32 normal draw on ``generator``'s
    device, scaled by 0.05; the log-variances zero; both on ``device``
    (default ``cuda``)."""
    dev = resolve_device(device)
    mu = 0.05 * torch.randn((k, latent_dim), generator=generator,
                            device=generator.device)
    return GMMPrior(mu=mu.to(device=dev, dtype=dtype),
                    logvar=torch.zeros((k, latent_dim), dtype=dtype,
                                       device=dev))
