"""Training configuration (port of ``vae_connexe_tpu/train/config.py``).

Plain dataclasses with the reference's names, order and defaults.
``latent_reg`` is ``'kl'`` (beta * KL) or ``'cs'`` (``lambda_cs`` times
the CS divergence against a learnable GMM prior of ``gmm_components``
components, ``losses/cs_divergence.py``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Phase1Config:
    """Structure-learning phase.

    Defaults follow the reference's Lorenz-96 script: lam=0.1 group lasso,
    lr=5e-2 manual SGD, beta=0.1 KL weight, batch 256, 5000 iterations.
    ``resample_batches=False`` trains on one fixed random batch, as the
    author scripts do.
    """

    lam: float = 0.1
    lam_ridge: float = 0.0
    lr: float = 5e-2
    beta: float = 0.1
    batch_size: int = 256
    max_iter: int = 5000
    check_every: int = 50
    resample_batches: bool = True
    latent_reg: str = "kl"
    lambda_cs: float = 0.1
    gmm_components: int = 10
    cs_variant: str = "symmetric"


@dataclasses.dataclass(frozen=True)
class Phase2Config:
    """Generation phase: lam=0, beta=1, manual SGD lr=5e-2 on the pruned
    CRVAE and Adam 1e-3 on the error VAE."""

    lr: float = 5e-2
    lr_error: float = 1e-3
    beta: float = 1.0
    beta_error: float = 1.0
    lam_ridge: float = 0.0
    batch_size: int = 256
    max_iter: int = 10000
    check_every: int = 50
    latent_reg: str = "kl"
    lambda_cs: float = 0.1
    gmm_components: int = 10
    cs_variant: str = "symmetric"


@dataclasses.dataclass(frozen=True)
class WInTrainConfig:
    """Trainer config of the explicit-W_in variant
    (``train/win_trainer.py``): Adam at ``lr`` on every leaf but W_in, an
    ISTA step of ``lr_prox`` (default ``lr``) with ``prox_groups`` on
    W_in."""

    lr: float = 2e-3
    lr_prox: float | None = None
    lam: float = 0.03
    prox_groups: str = "row"
    batch_size: int = 256
    stage1_epochs: int = 2000
    stage2_epochs: int = 1000
    prune_threshold: float = 1e-6
    update_w_in_stage2: bool = False


@dataclasses.dataclass(frozen=True)
class CSRAETrainConfig:
    """Model and trainer config of the MixtureCSRAE
    (``train/csrae_trainer.py::fit_csrae``)."""

    hidden_dims: tuple[int, ...] = (400,)
    latent_dim: int = 20
    k: int = 10
    lambda_cs: float = 1.0
    cs_variant: str = "symmetric"
    epochs: int = 30
    batch_size: int = 128
    lr: float = 1e-3


def check_latent_reg(cfg) -> None:
    """Raise where training would start on a latent regulariser that is
    neither 'kl' nor 'cs'."""
    if cfg.latent_reg not in ("kl", "cs"):
        raise ValueError(f"unknown latent_reg {cfg.latent_reg!r}")
