"""MixtureCSRAE (port of ``vae_connexe_tpu/models/csrae.py``): an MLP VAE
regularised by the Cauchy-Schwarz divergence against a learnable GMM prior
instead of the KL term.

The encoder is a ReLU MLP with two heads off its last hidden layer, mu and
log-variance; the decoder an MLP with the hidden widths reversed that gives
Bernoulli logits.  loss = BCE-with-logits summed / B + lambda_cs * mean
D_CS(q || GMM), with both conventions of the int p^2 term (``cs_variant``).
The products are ``torch.matmul`` calls: the JAX package runs them outside
any Pallas kernel too.  The reparameterisation epsilon and ``sample``'s
draws are passed in or drawn from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.losses.cs_divergence import cs_divergence_gmm
from vae_connexe_torch.models.gmm_prior import GMMPrior, init_gmm_prior
from vae_connexe_torch.utils.layers import Dense, dense, init_dense


@dataclasses.dataclass(frozen=True)
class MLPParams:
    layers: tuple[Dense, ...]
    head: Dense


def _init_mlp(generator: torch.Generator, dims: Sequence[int], out_dim: int,
              device=None) -> MLPParams:
    layers = tuple(init_dense(generator, dims[i], dims[i + 1], device=device)
                   for i in range(len(dims) - 1))
    return MLPParams(layers=layers,
                     head=init_dense(generator, dims[-1], out_dim,
                                     device=device))


def _mlp(p: MLPParams, x: torch.Tensor) -> torch.Tensor:
    for layer in p.layers:
        x = torch.relu(dense(layer, x))
    return dense(p.head, x)


@dataclasses.dataclass(frozen=True)
class MixtureCSRAEParams:
    enc: MLPParams
    enc_logvar_head: Dense
    dec: MLPParams
    prior: GMMPrior


def _draw_eps(eps, generator, shape):
    if eps is not None:
        return eps
    if generator is None:
        raise ValueError("needs an eps draw or a generator")
    return torch.randn(shape, generator=generator, device=generator.device)


class MixtureCSRAE:
    def __init__(self, input_dim: int, hidden_dims: Sequence[int] = (400,),
                 latent_dim: int = 20, k: int = 10, lambda_cs: float = 1.0,
                 cs_variant: str = "symmetric"):
        self.input_dim = input_dim
        self.hidden_dims = tuple(hidden_dims)
        self.latent_dim = latent_dim
        self.k = k
        self.lambda_cs = lambda_cs
        self.cs_variant = cs_variant

    def init(self, generator: torch.Generator,
             device=None) -> MixtureCSRAEParams:
        """torch-default init drawn from a CPU ``generator`` in field order
        (encoder, its log-variance head, decoder, the prior's means), placed
        on ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        g = generator
        enc = _init_mlp(g, (self.input_dim, *self.hidden_dims),
                        self.latent_dim, dev)
        logvar_head = init_dense(g, self.hidden_dims[-1], self.latent_dim,
                                 device=dev)
        dec = _init_mlp(g, (self.latent_dim, *self.hidden_dims[::-1]),
                        self.input_dim, dev)
        return MixtureCSRAEParams(
            enc=enc, enc_logvar_head=logvar_head, dec=dec,
            prior=init_gmm_prior(g, self.k, self.latent_dim, device=dev))

    def encode(self, params: MixtureCSRAEParams, x: torch.Tensor):
        """(mu, logvar), each (B, latent)."""
        h = x
        for layer in params.enc.layers:
            h = torch.relu(dense(layer, h))
        return dense(params.enc.head, h), dense(params.enc_logvar_head, h)

    def decode(self, params: MixtureCSRAEParams,
               z: torch.Tensor) -> torch.Tensor:
        """Bernoulli logits."""
        return _mlp(params.dec, z)

    def forward(self, params: MixtureCSRAEParams, x: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """(logits, mu, logvar); z = mu + exp(logvar / 2) * eps, eps (B,
        latent) passed in or drawn from ``generator``."""
        mu, logvar = self.encode(params, x)
        eps = _draw_eps(eps, generator, mu.shape).to(mu.device)
        z = mu + torch.exp(0.5 * logvar) * eps
        return self.decode(params, z), mu, logvar

    def sample(self, params: MixtureCSRAEParams,
               generator: Optional[torch.Generator], n: int,
               comp: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """n samples: a component of the equal-weight prior drawn uniformly
        for each (``comp`` (n,) ints), z = its mean + its std * ``eps``
        (n, latent), decoded to Bernoulli probabilities (n, input_dim).
        Draws not passed in come from ``generator``, ``comp`` first, the
        order of the reference's key split."""
        if comp is None:
            if generator is None:
                raise ValueError("sample needs a generator or the draws")
            comp = torch.randint(0, self.k, (n,), generator=generator,
                                 device=generator.device)
        eps = _draw_eps(eps, generator, (n, self.latent_dim))
        dev = params.prior.mu.device
        comp = comp.to(dev)
        mu = params.prior.mu[comp]
        std = torch.sqrt(params.prior.var[comp])
        return torch.sigmoid(self.decode(params, mu + std * eps.to(dev)))

    def loss(self, params: MixtureCSRAEParams, x: torch.Tensor,
             eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """(total, recon, cs): BCE-with-logits summed / B + lambda_cs *
        mean CS divergence, on ``forward``'s draw."""
        logits, mu, logvar = self.forward(params, x, eps, generator)
        bce = torch.sum(torch.clamp(logits, min=0) - logits * x
                        + torch.log1p(torch.exp(-torch.abs(logits)))
                        ) / x.shape[0]
        cs = cs_divergence_gmm(mu, torch.exp(logvar), params.prior.mu,
                               params.prior.var,
                               variant=self.cs_variant).mean()
        return bce + self.lambda_cs * cs, bce, cs
