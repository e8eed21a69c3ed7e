from vae_connexe_torch.train.config import Phase1Config
from vae_connexe_torch.train.crvae_trainer import (
    Phase1State,
    fit_phase1,
    generate_from_draws,
    generate_with_compensation,
    make_phase1_step,
)

__all__ = ["Phase1Config", "Phase1State", "fit_phase1", "generate_from_draws",
           "generate_with_compensation", "make_phase1_step"]
