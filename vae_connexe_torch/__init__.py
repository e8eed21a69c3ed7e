"""vae_connexe_torch: the PyTorch/CUDA port of vae_connexe_tpu for one H100.

Imports ``torch`` and never ``jax`` nor the JAX package.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.  Ported: serving
(compensated generation), phase-1 and phase-2 training with checkpoints and
resume, the crvae family's experiment runner and command line
(``python -m vae_connexe_torch.cli run lorenz96_crvae``), and discovery on
the user's own series: ``discover``, the multi-seed sweep with its seeds
folded into the recurrence kernels' heads (``parallel``), stability
selection, ``cli discover`` and ``cli sweep``; the explicit-W_in family
(``WInCRVAE``, ``WInTrainer`` with its seeds folded into the kernels'
heads, context-conditioned serving) and the Hénon and VAR datasets; the
CS-divergence regulariser against a learnable GMM prior
(``latent_reg='cs'``), the MixtureCSRAE, the plain VRAE with its RNN, GRU
and LSTM cells, nan debugging (``cli run --debug-nans``), profiling and
the TimeGAN helpers.  The kernels
(``csrc/rollout.cu``, ``csrc/gru.cu``, ``csrc/step.cu``) are built with
``nvcc`` at first use.
"""

__version__ = "0.1.0"

from vae_connexe_torch.configs import EXPERIMENTS, get_experiment, run_experiment
from vae_connexe_torch.discover import DiscoveryResult, discover
from vae_connexe_torch.models import (
    CRVAE,
    CRVAEParams,
    ErrorVAE,
    ErrorVAEParams,
    MixtureCSRAE,
    MixtureCSRAEParams,
    VRAE,
    VRAEParams,
    WInCRVAE,
    WInCRVAEParams,
)
from vae_connexe_torch.serving import (
    export_generator,
    export_win_generator,
    load_generator,
)
from vae_connexe_torch.train import (
    Phase1Config,
    Phase2Config,
    WInTrainConfig,
    WInTrainer,
    fit_csrae,
    fit_phase1,
    fit_phase2,
    fit_vrae,
    generate_from_draws,
    generate_with_compensation,
)

__all__ = [
    "CRVAE",
    "CRVAEParams",
    "DiscoveryResult",
    "EXPERIMENTS",
    "ErrorVAE",
    "ErrorVAEParams",
    "MixtureCSRAE",
    "MixtureCSRAEParams",
    "Phase1Config",
    "Phase2Config",
    "VRAE",
    "VRAEParams",
    "WInCRVAE",
    "WInCRVAEParams",
    "WInTrainConfig",
    "WInTrainer",
    "discover",
    "export_generator",
    "export_win_generator",
    "fit_csrae",
    "fit_phase1",
    "fit_phase2",
    "fit_vrae",
    "generate_from_draws",
    "generate_with_compensation",
    "get_experiment",
    "load_generator",
    "run_experiment",
]
