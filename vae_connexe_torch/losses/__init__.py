from vae_connexe_torch.losses.cs_divergence import (
    cs_divergence_gmm,
    log_gaussian_overlap,
)
from vae_connexe_torch.losses.kl import kl_gaussian, kl_gaussian_logsigma
from vae_connexe_torch.losses.penalties import group_lasso_value, ridge_value

__all__ = ["cs_divergence_gmm", "group_lasso_value", "kl_gaussian",
           "kl_gaussian_logsigma", "log_gaussian_overlap", "ridge_value"]
