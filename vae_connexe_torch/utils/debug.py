"""Numerical debugging (port of ``vae_connexe_tpu/utils/debug.py``): the
counterpart of ``jax_debug_nans``.

``enable_nan_debugging`` switches two things:

- ``torch.autograd.set_detect_anomaly``: a backward that makes a NaN,
  the B1/B2 ``autograd.Function`` of ``ops/cuda_gru.py`` included, raises
  with the forward call that created it;
- a flag under which the training loops (``train/crvae_trainer.py``'s
  chunked fits, the W_in trainer, ``fit_csrae``, ``fit_vrae``) check each
  step's loss before its backward (``check_finite``) and the step's
  metrics and updated parameters after it, inside ``at_step``, and raise
  ``FloatingPointError`` naming the step.

With the flag off no check runs and nothing is read back from the device.
"""

from __future__ import annotations

import contextlib

import torch

from vae_connexe_torch.utils.tree import tree_leaves

_ON = [False]


def enable_nan_debugging(enable: bool = True) -> None:
    """Raise on the first NaN or Inf a training step makes."""
    torch.autograd.set_detect_anomaly(enable)
    _ON[0] = enable


def nan_debugging_enabled() -> bool:
    return _ON[0]


@contextlib.contextmanager
def nan_debugging():
    """Scoped ``enable_nan_debugging``."""
    prev, prev_anomaly = _ON[0], torch.is_anomaly_enabled()
    enable_nan_debugging(True)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev_anomaly)
        _ON[0] = prev


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return tree_leaves(tree)


def check_finite(what: str, *trees) -> None:
    """Under nan debugging, raise ``FloatingPointError`` when a tensor of
    ``trees`` (tensors, dicts of them or parameter dataclasses) holds a
    non-finite value; one read from the device.  Off: returns at once."""
    if not _ON[0]:
        return
    leaves = [t for tree in trees for t in _tensors(tree)]
    finite = torch.stack([torch.isfinite(t).all() for t in leaves]).all()
    if not bool(finite):
        raise FloatingPointError(f"non-finite value in {what}")


@contextlib.contextmanager
def at_step(where: str):
    """Names ``where`` (a loop and its step) in a ``FloatingPointError``
    raised inside."""
    try:
        yield
    except FloatingPointError as e:
        raise FloatingPointError(f"{where}: {e}") from e
