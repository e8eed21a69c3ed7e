"""Generation-quality metrics (port of ``vae_connexe_tpu/evals/generation.py``):
prediction MSE and the mean/std match between real and generated series."""

from __future__ import annotations

import torch


def prediction_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def moment_match(ori: torch.Tensor, syn: torch.Tensor) -> dict:
    """Per-variable mean and (population) std of the original and the
    synthetic series, and their absolute gaps.  ori: (T, D) or (N, T, D);
    syn likewise.  Returns a dict of (D,) tensors."""
    def moments(x):
        flat = x.reshape(-1, x.shape[-1])
        return flat.mean(0), flat.std(0, correction=0)

    mo, so = moments(ori)
    ms, ss = moments(syn)
    return {
        "mean_ori": mo, "mean_syn": ms, "mean_abs_gap": torch.abs(mo - ms),
        "std_ori": so, "std_syn": ss, "std_abs_gap": torch.abs(so - ss),
    }
