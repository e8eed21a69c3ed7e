"""Compensated generation (port of ``vae_connexe_tpu/train/crvae_trainer.py:510-588``).

Phase-2 sampling: draw an error sequence from the error VAE and inject it,
scaled by ``model.noise_scale``, into the CRVAE's free run.  The phase-1 and
phase-2 trainers come with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from vae_connexe_torch.models.crvae import (
    CRVAE,
    CRVAEParams,
    masked_heads,
    no_reduced_precision,
)
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams
from vae_connexe_torch.ops.cuda_rollout import (
    crvae_free_run_fused,
    errvae_sample_fused,
)
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.utils.layers import Dense

KERNELS = ("lax", "fused", "auto")


def generate_from_draws(model: CRVAE, err_model: ErrorVAE, heads: GRUParams,
                        readout: Dense, dec: GRUParams, out: Dense,
                        h0_err: torch.Tensor, h0: torch.Tensor,
                        steps: Optional[int] = None) -> torch.Tensor:
    """Compensated generation from given draws.

    ``heads``/``readout``: the (masked) CRVAE decoder heads and readout;
    ``dec``/``out``: the ErrorVAE decoder and readout; ``h0_err`` (B, H_err)
    the ErrorVAE's initial state, ``h0`` (B, H) the rollout's.  One K2
    launch then one K1 launch.  Returns (B, steps, p), steps defaulting to
    ``model.rollout_len``.
    """
    steps = model.rollout_len if steps is None else steps
    b = h0.shape[0]
    dev = heads.w_ih.device
    errs = errvae_sample_fused(dec, out, h0_err.to(dev), err_model.d, steps)
    # ErrorVAE.sample keeps a leading zero step; slice to the rollout
    # length exactly as the reference does.
    noise = torch.cat([torch.zeros((b, 1, err_model.d), device=dev), errs],
                      dim=1)[:, :steps]
    return crvae_free_run_fused(heads, readout,
                                torch.zeros((b, model.p), device=dev),
                                h0.to(dev), noise, model.noise_scale)


def generate_with_compensation(model: CRVAE, err_model: ErrorVAE,
                               params: CRVAEParams, err_params: ErrorVAEParams,
                               generator: torch.Generator, batch: int,
                               parents: Optional[torch.Tensor] = None,
                               dtype=None, kernel: str = "lax") -> torch.Tensor:
    """Phase-2 sampling.  Returns (B, rollout_len, p).

    Draws the ErrorVAE's h0 first and the rollout's h0 second from
    ``generator``, the order of the reference's key split, then runs
    ``generate_from_draws``.

    ``kernel`` keeps the reference's signature; its lax/fused crossover was
    measured on a TPU and does not carry over, so every value runs the
    rollout kernels (on a CUDA tensor) or their plain versions (on a CPU
    tensor).  ``dtype``: only float32 is ported.
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    no_reduced_precision(dtype)
    heads = params.heads if parents is None else masked_heads(params.heads, parents)
    h0_err = torch.randn((batch, err_model.hidden), generator=generator,
                         device=generator.device)
    h0 = torch.randn((batch, model.hidden), generator=generator,
                     device=generator.device)
    return generate_from_draws(model, err_model, heads, params.readout,
                               err_params.dec, err_params.out, h0_err, h0)
