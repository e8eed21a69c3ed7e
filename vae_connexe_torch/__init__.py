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
the TimeGAN helpers; bfloat16 serving through the rollout kernels,
generator artifacts that run without the model code (``torch.export``
programs over the kernels' custom ops, ``ops/library.py``), the native
window loader and the out-of-core streaming fits (``cli run
--out-of-core``).  The kernels (``csrc/rollout.cu``, ``csrc/gru.cu``,
``csrc/step.cu``) are built with ``nvcc`` at first use.

The names below are imported when first used, so importing a submodule
(``serving.load_generator``'s process) loads none of the others.
"""

__version__ = "0.1.0"

import importlib
import sys
import types

# Public name -> the module that defines it.
_EXPORTS = {
    "EXPERIMENTS": "configs", "get_experiment": "configs",
    "run_experiment": "configs",
    "DiscoveryResult": "discover", "discover": "discover",
    "CRVAE": "models", "CRVAEParams": "models", "ErrorVAE": "models",
    "ErrorVAEParams": "models", "MixtureCSRAE": "models",
    "MixtureCSRAEParams": "models", "VRAE": "models", "VRAEParams": "models",
    "WInCRVAE": "models", "WInCRVAEParams": "models",
    "export_generator": "serving", "export_win_generator": "serving",
    "load_generator": "serving",
    "Phase1Config": "train", "Phase2Config": "train",
    "WInTrainConfig": "train", "WInTrainer": "train", "fit_csrae": "train",
    "fit_phase1": "train", "fit_phase1_streaming": "train",
    "fit_phase2": "train", "fit_phase2_streaming": "train",
    "fit_vrae": "train", "generate_from_draws": "train",
    "generate_with_compensation": "train",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"),
                    name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))


class _Package(types.ModuleType):
    """The package module: importing a submodule that shares its name with
    a public name (``discover``) does not bind the submodule over it, so
    ``vae_connexe_torch.discover`` stays the function, as when the names
    were imported eagerly."""

    def __setattr__(self, name, value):
        if name in _EXPORTS and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
