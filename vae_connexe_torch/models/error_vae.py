"""Error-compensation sequence VAE, sampling half (port of
``vae_connexe_tpu/models/error_vae.py``).

Trained on the CRVAE's residuals; at generation time it synthesises an error
sequence that is blended into the rollout.  This slice ports the parameters
and free-running sampling; ``forward`` comes with the training slice.
Sampling runs through the K2 kernel (``ops/cuda_rollout.errvae_sample_fused``)
on a CUDA tensor and through its plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.models.crvae import no_reduced_precision
from vae_connexe_torch.ops.cuda_rollout import errvae_sample_fused
from vae_connexe_torch.ops.gru import GRUParams, init_gru
from vae_connexe_torch.utils.layers import Dense, init_dense


@dataclasses.dataclass(frozen=True)
class ErrorVAEParams:
    enc: GRUParams     # D -> H
    fc_mu: Dense       # H -> Z
    fc_std: Dense      # H -> Z
    z2h: Dense         # Z -> H
    dec: GRUParams     # D -> H
    out: Dense         # H -> D


class ErrorVAE:
    """Functional error-compensation VAE.

    Args:
      d: number of series.
      hidden: GRU hidden size.
      latent: latent size (default ``hidden``, the author variant).
      rollout_len: default sample length.

    The reference's ``shift_decoder_input`` belongs to ``forward`` and comes
    with it in the training slice.
    """

    def __init__(self, d: int, hidden: int, latent: Optional[int] = None,
                 rollout_len: int = 21):
        self.d = d
        self.hidden = hidden
        self.latent = hidden if latent is None else latent
        self.rollout_len = rollout_len

    def init(self, generator: torch.Generator, device=None) -> ErrorVAEParams:
        """torch-default init from a CPU ``generator``, placed on ``device``
        (default ``cuda``; see ``_device.resolve_device``)."""
        dev = resolve_device(device)
        g = generator
        return ErrorVAEParams(
            enc=init_gru(g, self.d, self.hidden, dev),
            fc_mu=init_dense(g, self.hidden, self.latent, dev),
            fc_std=init_dense(g, self.hidden, self.latent, dev),
            z2h=init_dense(g, self.latent, self.hidden, dev),
            dec=init_gru(g, self.d, self.hidden, dev),
            out=init_dense(g, self.hidden, self.d, dev),
        )

    def sample(self, params: ErrorVAEParams, batch: int,
               generator: Optional[torch.Generator] = None,
               length: Optional[int] = None,
               h0: Optional[torch.Tensor] = None,
               dtype=None) -> torch.Tensor:
        """Free-running error-sequence generation from a random hidden state.

        Starts from x0 = 0 and h0 ~ N(0, I) (B, H), drawn from ``generator``
        or passed as ``h0``, and rolls ``length`` steps.  The reference keeps
        the leading zero step and returns length + 1 steps; callers slice as
        needed.  Returns (B, length + 1, D).
        """
        no_reduced_precision(dtype)
        steps = self.rollout_len if length is None else length
        dev = params.dec.w_ih.device
        if h0 is None:
            if generator is None:
                raise ValueError("sample needs a generator or an h0 draw")
            h0 = torch.randn((batch, self.hidden), generator=generator,
                             device=generator.device)
        seq = errvae_sample_fused(params.dec, params.out, h0.to(dev), self.d,
                                  steps)
        zero = torch.zeros((batch, 1, self.d), device=dev)
        return torch.cat([zero, seq], dim=1)
