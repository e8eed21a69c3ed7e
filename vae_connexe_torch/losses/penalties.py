"""Penalty values (port of ``vae_connexe_tpu/losses/penalties.py``).  The
non-smooth group lasso is applied by the prox, not by a gradient."""

from __future__ import annotations

import torch


def group_lasso_value(w: torch.Tensor, lam: float,
                      group_axis: int = -2) -> torch.Tensor:
    """lam * sum of the L2 norms of the slices along ``group_axis``; for a
    torch-layout (..., 3H, D) input-weight matrix, group_axis=-2 gives one
    group per input series."""
    return lam * torch.linalg.vector_norm(w, dim=group_axis).sum()


def ridge_value(readout_w: torch.Tensor, w_hh: torch.Tensor,
                lam: float, *, keep: int = 0) -> torch.Tensor:
    """lam * (||W_out||^2 + ||W_hh||^2), summed over any stacked head axes.
    The first ``keep`` axes (a seed axis) are kept: one value each."""
    return lam * (_sum_after(readout_w ** 2, keep)
                  + _sum_after(w_hh ** 2, keep))


def _sum_after(x: torch.Tensor, keep: int) -> torch.Tensor:
    """The sum over every axis after the first ``keep``."""
    return torch.sum(x, dim=tuple(range(keep, x.ndim))) if keep else x.sum()
