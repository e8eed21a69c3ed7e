"""Experiment configs: the reference's experiment scripts as data, runnable with
``python -m vae_connexe_torch.cli run <name>``."""

from vae_connexe_torch.configs.experiments import (
    EXPERIMENTS,
    Experiment,
    get_experiment,
    run_experiment,
)

__all__ = ["EXPERIMENTS", "Experiment", "get_experiment", "run_experiment"]
