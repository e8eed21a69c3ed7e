"""Phase-1 configuration (port of ``vae_connexe_tpu/train/config.py``,
``Phase1Config``)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Phase1Config:
    """Structure-learning phase.

    Defaults follow the reference's Lorenz-96 script: lam=0.1 group lasso,
    lr=5e-2 manual SGD, beta=0.1 KL weight, batch 256, 5000 iterations.
    ``resample_batches=False`` trains on one fixed random batch, as the
    author scripts do.  ``latent_reg='cs'`` (the CS-divergence hybrid) is
    not ported yet and raises; its ``lambda_cs``, ``gmm_components`` and
    ``cs_variant`` are taken, with the reference's names, order and
    defaults, so that every crvae configuration of the reference builds.
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

    def __post_init__(self):
        if self.latent_reg == "cs":
            raise NotImplementedError(
                "latent_reg='cs' (CS divergence against a GMM prior) is not "
                "ported yet; the port trains with latent_reg='kl'")
        if self.latent_reg != "kl":
            raise ValueError(f"unknown latent_reg {self.latent_reg!r}")
