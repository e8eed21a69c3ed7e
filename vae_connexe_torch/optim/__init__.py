from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.optim.prox import prox_column_groups

__all__ = ["AdamState", "adam_init", "adam_update", "prox_column_groups"]
