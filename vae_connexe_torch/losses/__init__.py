from vae_connexe_torch.losses.kl import kl_gaussian
from vae_connexe_torch.losses.penalties import group_lasso_value, ridge_value

__all__ = ["group_lasso_value", "kl_gaussian", "ridge_value"]
