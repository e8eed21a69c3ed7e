from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.optim.prox import (
    PROX_FNS,
    ProximalSGDState,
    prox_column_groups,
    prox_elementwise,
    prox_row_groups,
    proximal_sgd,
)

__all__ = ["AdamState", "PROX_FNS", "ProximalSGDState", "adam_init",
           "adam_update", "prox_column_groups", "prox_elementwise",
           "prox_row_groups", "proximal_sgd"]
