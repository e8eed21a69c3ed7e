"""Column-group proximal step (port of ``vae_connexe_tpu/optim/prox.py``,
``prox_column_groups``): the GISTA shrink that makes the Granger graph."""

from __future__ import annotations

import torch


def prox_column_groups(w: torch.Tensor, lam: float, lr: float) -> torch.Tensor:
    """Group soft-threshold over columns (reduce the second-to-last axis):
    W <- W / max(||W||_col, lam*lr) * max(||W||_col - lam*lr, 0)."""
    norm = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
    # The 1e-30 floor guards lam*lr == 0 (phase 2 runs with lam = 0, where
    # the prox must be the identity, not 0/0).
    denom = torch.clamp(norm, min=max(lam * lr, 1e-30))
    return w * (torch.clamp(norm - lam * lr, min=0.0) / denom)
