"""vae_connexe_torch: the PyTorch/CUDA port of vae_connexe_tpu for one H100.

Imports ``torch`` and never ``jax`` nor the JAX package.  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``.  Serving (compensated
generation) and phase-1 training are ported; their kernels (``csrc/rollout.cu``,
``csrc/gru.cu``, ``csrc/step.cu``) are built with ``nvcc`` at first use.
"""

from vae_connexe_torch.models import CRVAE, CRVAEParams, ErrorVAE, ErrorVAEParams
from vae_connexe_torch.serving import export_generator, load_generator
from vae_connexe_torch.train import (
    Phase1Config,
    fit_phase1,
    generate_from_draws,
    generate_with_compensation,
)

__all__ = [
    "CRVAE",
    "CRVAEParams",
    "ErrorVAE",
    "ErrorVAEParams",
    "Phase1Config",
    "export_generator",
    "fit_phase1",
    "generate_from_draws",
    "generate_with_compensation",
    "load_generator",
]
