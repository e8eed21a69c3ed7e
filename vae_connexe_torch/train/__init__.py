"""Trainers: the two-phase CRVAE fits (in memory, or streamed from the
native window loader), compensated generation, the two-stage W_in
trainer, and the VRAE and MixtureCSRAE loops."""

from vae_connexe_torch.train.config import (
    CSRAETrainConfig,
    Phase1Config,
    Phase2Config,
    WInTrainConfig,
)
from vae_connexe_torch.train.crvae_trainer import (
    Phase1State,
    Phase2State,
    fit_phase1,
    fit_phase2,
    generate_from_draws,
    generate_with_compensation,
    make_phase1_step,
    make_phase2_step,
)
from vae_connexe_torch.train.csrae_trainer import fit_csrae
from vae_connexe_torch.train.streaming import (
    fit_phase1_streaming,
    fit_phase2_streaming,
)
from vae_connexe_torch.train.vrae_trainer import fit_vrae
from vae_connexe_torch.train.win_trainer import WInTrainer, WInTrainState

__all__ = ["CSRAETrainConfig", "Phase1Config", "Phase1State", "Phase2Config",
           "Phase2State", "WInTrainConfig", "WInTrainState", "WInTrainer",
           "fit_csrae", "fit_phase1", "fit_phase1_streaming", "fit_phase2",
           "fit_phase2_streaming", "fit_vrae",
           "generate_from_draws", "generate_with_compensation",
           "make_phase1_step", "make_phase2_step"]
