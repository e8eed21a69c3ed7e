from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams, masked_heads
from vae_connexe_torch.models.crvae_win import WInCRVAE, WInCRVAEParams
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams

__all__ = ["CRVAE", "CRVAEParams", "ErrorVAE", "ErrorVAEParams", "WInCRVAE",
           "WInCRVAEParams", "masked_heads"]
