from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams, masked_heads
from vae_connexe_torch.models.crvae_win import WInCRVAE, WInCRVAEParams
from vae_connexe_torch.models.csrae import MixtureCSRAE, MixtureCSRAEParams
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams
from vae_connexe_torch.models.gmm_prior import GMMPrior, init_gmm_prior
from vae_connexe_torch.models.vrae import VRAE, VRAEParams

__all__ = ["CRVAE", "CRVAEParams", "ErrorVAE", "ErrorVAEParams", "GMMPrior",
           "MixtureCSRAE", "MixtureCSRAEParams", "VRAE", "VRAEParams",
           "WInCRVAE", "WInCRVAEParams", "init_gmm_prior", "masked_heads"]
