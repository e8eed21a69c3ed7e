"""Error-compensation sequence VAE (port of
``vae_connexe_tpu/models/error_vae.py``).

Trained on the CRVAE's residuals in phase 2; at generation time it
synthesises an error sequence that is blended into the rollout.

``forward``'s two recurrences (the encoder over the residuals, the decoder
from ``tanh(z2h(z))``) go through ``ops/dispatch.py::gru_sequence``: on a
CUDA tensor each is a one-head launch of the B1 forward kernel and, under
autograd, of the B2 backward kernel; on a CPU tensor they run the plain
``gru_scan``.  The JAX package calls ``gru_scan`` directly here, which on a
TPU is XLA's scan, not a Pallas kernel; on the card the port has no other
route, so these recurrences are B1/B2 launches.  Sampling runs through the
K2 kernel (``ops/cuda_rollout.errvae_sample_fused``) on a CUDA tensor and
through its plain version on a CPU tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.ops.cuda_rollout import (
    cast_weights,
    errvae_sample_fused,
    serve_dtype,
)
from vae_connexe_torch.ops.dispatch import gru_sequence
from vae_connexe_torch.ops.gru import GRUParams, init_gru
from vae_connexe_torch.utils.layers import Dense, dense, init_dense


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
      shift_decoder_input: author-variant teacher forcing (the decoder
        reads a zero step, then the residuals shifted right by one) rather
        than the residuals as they are (the W_in variants).
      rollout_len: default sample length.
    """

    def __init__(self, d: int, hidden: int, latent: Optional[int] = None,
                 shift_decoder_input: bool = True, rollout_len: int = 21):
        self.d = d
        self.hidden = hidden
        self.latent = hidden if latent is None else latent
        self.shift_decoder_input = shift_decoder_input
        self.rollout_len = rollout_len

    def init(self, generator: torch.Generator, device=None) -> ErrorVAEParams:
        """torch-default init from a CPU ``generator``, placed on ``device``
        (default ``cuda``; see ``_device.resolve_device``)."""
        dev = resolve_device(device)
        g = generator
        return ErrorVAEParams(
            enc=init_gru(g, self.d, self.hidden, device=dev),
            fc_mu=init_dense(g, self.hidden, self.latent, device=dev),
            fc_std=init_dense(g, self.hidden, self.latent, device=dev),
            z2h=init_dense(g, self.latent, self.hidden, device=dev),
            dec=init_gru(g, self.d, self.hidden, device=dev),
            out=init_dense(g, self.hidden, self.d, device=dev),
        )

    def forward(self, params: ErrorVAEParams, eps_seq: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Reconstruct a residual sequence.

        eps_seq: (B, T, D) residuals.  The encoder reads them from h0 = 0;
        z = mu + exp(logvar / 2) * eps, with eps (B, Z) passed in or drawn
        from ``generator``; ``tanh(z2h(z))`` is the decoder's h0.  Returns
        (recon (B, T, D), mu (B, Z), logvar (B, Z)).
        """
        b = eps_seq.shape[0]
        h0 = torch.zeros((b, self.hidden), device=eps_seq.device,
                         dtype=eps_seq.dtype)
        _, h_t = gru_sequence(params.enc, eps_seq, h0)
        mu = dense(params.fc_mu, h_t)
        logvar = dense(params.fc_std, h_t)
        if eps is None:
            if generator is None:
                raise ValueError("forward needs an eps draw or a generator")
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device)
        z = mu + torch.exp(0.5 * logvar) * eps.to(mu.device)
        h_dec = torch.tanh(dense(params.z2h, z))
        if self.shift_decoder_input:
            dec_in = torch.cat([torch.zeros_like(eps_seq[:, :1]),
                                eps_seq[:, :-1]], dim=1)
        else:
            dec_in = eps_seq
        outs, _ = gru_sequence(params.dec, dec_in, h_dec)
        return dense(params.out, outs), mu, logvar

    def sample(self, params: ErrorVAEParams,
               generator: Optional[torch.Generator], batch: int,
               length: Optional[int] = None, dtype=None,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Free-running error-sequence generation from a random hidden state.

        Starts from x0 = 0 and h0 ~ N(0, I) (B, H), drawn from ``generator``
        or passed as ``h0`` (then ``generator`` may be None), and rolls
        ``length`` steps.  JAX's parameters in JAX's order, ``h0`` after
        them.  The reference keeps
        the leading zero step and returns length + 1 steps; callers slice as
        needed.  ``dtype``: the serving precision; with bfloat16 the
        decoder and readout are cast to bf16 and the run takes K2's bf16
        instantiation.  Returns (B, length + 1, D) float32.
        """
        dt = serve_dtype(dtype)
        steps = self.rollout_len if length is None else length
        dev = params.dec.w_ih.device
        if h0 is None:
            if generator is None:
                raise ValueError("sample needs a generator or an h0 draw")
            h0 = torch.randn((batch, self.hidden), generator=generator,
                             device=generator.device)
        dec, out = params.dec, params.out
        if dt != torch.float32:
            dec, out = cast_weights(dec, dt), cast_weights(out, dt)
        seq = errvae_sample_fused(dec, out, h0.to(dev), self.d, steps)
        zero = torch.zeros((batch, 1, self.d), device=dev)
        return torch.cat([zero, seq], dim=1)
