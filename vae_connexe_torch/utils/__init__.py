"""Utilities: layer primitives, checkpointing, metric logging, scalers."""

from vae_connexe_torch.utils.checkpoint import (
    TrainCheckpointer,
    load_gc,
    restore_checkpoint,
    save_checkpoint,
)
from vae_connexe_torch.utils.layers import Dense, dense, init_dense, init_stacked_dense
from vae_connexe_torch.utils.metrics_log import JsonlWriter, PrintWriter
from vae_connexe_torch.utils.scalers import standardize

__all__ = [
    "Dense",
    "JsonlWriter",
    "PrintWriter",
    "TrainCheckpointer",
    "dense",
    "init_dense",
    "init_stacked_dense",
    "load_gc",
    "restore_checkpoint",
    "save_checkpoint",
    "standardize",
]
