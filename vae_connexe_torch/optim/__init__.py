from vae_connexe_torch.optim.prox import prox_column_groups

__all__ = ["prox_column_groups"]
