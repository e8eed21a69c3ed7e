"""Utilities: layer primitives, checkpointing, nan debugging, profiling,
metric logging, scalers."""

from vae_connexe_torch.utils.checkpoint import (
    TrainCheckpointer,
    load_gc,
    restore_checkpoint,
    save_checkpoint,
)
from vae_connexe_torch.utils.debug import enable_nan_debugging, nan_debugging
from vae_connexe_torch.utils.layers import Dense, dense, init_dense, init_stacked_dense
from vae_connexe_torch.utils.metrics_log import JsonlWriter, PrintWriter
from vae_connexe_torch.utils.profiling import StepTimer, trace
from vae_connexe_torch.utils.scalers import minmax_scale, standardize

__all__ = [
    "Dense",
    "JsonlWriter",
    "PrintWriter",
    "StepTimer",
    "TrainCheckpointer",
    "dense",
    "enable_nan_debugging",
    "init_dense",
    "init_stacked_dense",
    "load_gc",
    "minmax_scale",
    "nan_debugging",
    "restore_checkpoint",
    "save_checkpoint",
    "standardize",
    "trace",
]
