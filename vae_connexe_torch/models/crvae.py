"""CRVAE (port of ``vae_connexe_tpu/models/crvae.py``).

A GRU encoder maps a short past window to a latent Gaussian; p GRU decoder
heads, one per variable, predict each variable from all variables' pasts;
the column norms of each head's input weights are the learned
Granger-causal graph.  Ported: the parameters, the parents mask, ``encode``
and ``forward`` (training), ``conditioned_rollout``, free-running
generation and GC extraction.

``encode`` and ``forward`` run their recurrences through
``ops/dispatch.py`` (the B1/B2 kernels, or the plain recurrence where their
tiles do not fit); free-running generation runs through the K1 kernel
(``ops/cuda_rollout.crvae_free_run_fused``) on a CUDA tensor and through
its plain version on a CPU tensor, in float32 or, with
``dtype=torch.bfloat16`` (or ``"bfloat16"``), through the kernel's bf16
instantiation.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.ops.cuda_rollout import (
    cast_weights,
    crvae_free_run_fused,
    serve_dtype,
)
from vae_connexe_torch.ops.dispatch import gru_sequence, heads_recurrence
from vae_connexe_torch.ops.gru import GRUParams, init_gru, init_stacked_gru
from vae_connexe_torch.utils.layers import (
    Dense,
    dense,
    init_dense,
    init_stacked_dense,
)


@dataclasses.dataclass(frozen=True)
class CRVAEParams:
    enc: GRUParams       # p -> H shared encoder
    fc_mu: Dense         # H -> H
    fc_std: Dense        # H -> H
    heads: GRUParams     # stacked (p, 3H, p) decoder GRUs
    readout: Dense       # stacked (p, 1, H) per-head output layers


def masked_heads(heads: GRUParams, parents: torch.Tensor) -> GRUParams:
    """Zero the input-weight columns of non-parents.

    ``parents``: (p, p) binary, row i = parent indicator of variable i.
    """
    mask = parents.to(device=heads.w_ih.device, dtype=heads.w_ih.dtype)
    return dataclasses.replace(heads, w_ih=heads.w_ih * mask[:, None, :])


def decoder_input(x: torch.Tensor, enc_len: int) -> torch.Tensor:
    """The decoder's teacher-forced input (B, T - enc_len, p): a zero step,
    then the targets shifted right by one (= [0, x_enc_len .. x_{T-2}])."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, enc_len:-1]], dim=1)


class CRVAE:
    """Functional CRVAE (author variant); the JAX class's signature."""

    def __init__(self, p: int, hidden: int = 64, enc_len: int = 10,
                 rollout_len: int = 21, noise_scale: float = 0.1):
        self.p = p
        self.hidden = hidden
        self.enc_len = enc_len
        self.rollout_len = rollout_len
        self.noise_scale = noise_scale

    def init(self, generator: torch.Generator, device=None) -> CRVAEParams:
        """torch-default init from a CPU ``generator``, placed on ``device``
        (default ``cuda``; see ``_device.resolve_device``)."""
        dev = resolve_device(device)
        g = generator
        return CRVAEParams(
            enc=init_gru(g, self.p, self.hidden, device=dev),
            fc_mu=init_dense(g, self.hidden, self.hidden, device=dev),
            fc_std=init_dense(g, self.hidden, self.hidden, device=dev),
            heads=init_stacked_gru(g, self.p, self.p, self.hidden, device=dev),
            readout=init_stacked_dense(g, self.p, self.hidden, 1, device=dev),
        )

    # ---------------- encode / forward ----------------

    def encode(self, params: CRVAEParams, x: torch.Tensor, *,
               sequence=gru_sequence):
        """Past window -> (mu, logvar), each (B, H).  x: (B, T, p); the
        encoder reads the first enc_len steps from h0 = 0.  ``sequence`` is
        the single-GRU recurrence (``gru_sequence``'s contract)."""
        h0 = torch.zeros((x.shape[0], self.hidden), device=x.device,
                         dtype=x.dtype)
        _, h_t = sequence(params.enc, x[:, : self.enc_len], h0)
        return dense(params.fc_mu, h_t), dense(params.fc_std, h_t)

    def forward(self, params: CRVAEParams, x: torch.Tensor,
                eps: Optional[torch.Tensor] = None,
                parents: Optional[torch.Tensor] = None,
                deterministic: bool = False, *, recurrences=None):
        """Teacher-forced reconstruction of the window's second half.

        x: (B, T, p) window, T > enc_len; eps: (B, H) standard normals of
        the reparameterisation z = mu + exp(logvar / 2) * eps (ignored when
        ``deterministic``, which uses z = mu); parents: optional (p, p)
        binary connection mask.  ``recurrences``: optional (sequence,
        heads) pair replacing ``gru_sequence`` and ``heads_recurrence``.

        Returns (pred (B, T - enc_len, p), mu (B, H), logvar (B, H)) where
        ``pred[:, t, i]`` estimates ``x[:, enc_len + t, i]``.
        """
        if x.shape[1] <= self.enc_len:
            raise ValueError(
                f"window length {x.shape[1]} must exceed enc_len={self.enc_len}: "
                "the encoder reads the first enc_len steps and the decoder "
                "predicts the remaining T - enc_len.")
        sequence, heads_fn = recurrences or (gru_sequence, heads_recurrence)
        heads = params.heads if parents is None else masked_heads(params.heads, parents)
        mu, logvar = self.encode(params, x, sequence=sequence)
        if deterministic:
            z = mu
        elif eps is None:
            raise ValueError("forward needs an eps draw or deterministic=True")
        else:
            z = mu + torch.exp(0.5 * logvar) * eps
        # z is every head's h0.
        outs, _ = heads_fn(heads, decoder_input(x, self.enc_len), z[None])
        pred = (torch.einsum("pbth,poh->pbto", outs, params.readout.w)
                + params.readout.b[:, None, None, :])
        return pred[..., 0].permute(1, 2, 0), mu, logvar

    # ---------------- generation ----------------

    def _free_run(self, params: CRVAEParams, heads: GRUParams,
                  x0: torch.Tensor, h0: torch.Tensor, noise: torch.Tensor,
                  steps: Optional[int] = None, dtype=None) -> torch.Tensor:
        """Shared generation core: every head takes one GRU step per emitted
        value and ``noise_scale * noise_t`` is added to it (the compensated
        value feeds the next step).

        x0 (B, p); h0 (B, H), the state every head starts from (the JAX
        reference takes it broadcast to (p, B, H)); noise (B, T, p).
        ``dtype``: the serving precision (``ops.cuda_rollout.serve_dtype``):
        with bfloat16 the heads and readout are cast to bf16 and the run
        takes K1's bf16 instantiation (bf16 carries, float32 products).
        Returns (B, T, p) float32.
        """
        dt = serve_dtype(dtype)
        if steps is not None and noise.shape[1] != steps:
            raise ValueError(
                f"noise has {noise.shape[1]} steps but the rollout wants "
                f"{steps}; slice the error-VAE sample to the rollout length")
        readout = params.readout
        if dt != torch.float32:
            heads, readout = cast_weights(heads, dt), cast_weights(readout, dt)
        return crvae_free_run_fused(heads, readout, x0, h0, noise,
                                    self.noise_scale)

    def rollout(self, params: CRVAEParams,
                generator: Optional[torch.Generator], batch: int,
                noise: Optional[torch.Tensor] = None,
                parents: Optional[torch.Tensor] = None,
                length: Optional[int] = None, dtype=None,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Free-running generation (the reference's ``mode='test'``).

        Starts from x0 = 0 with one shared random h0 (B, H) for all heads,
        drawn from ``generator`` or passed as ``h0`` (then ``generator``
        may be None).  JAX's parameters in JAX's order, ``h0`` after them.
        ``noise``: optional
        (B, length, p) error sequence added as ``noise_scale * noise_t`` to
        each emitted step.  Returns (B, length, p).
        """
        steps = self.rollout_len if length is None else length
        heads = params.heads if parents is None else masked_heads(params.heads, parents)
        dev = heads.w_ih.device
        if h0 is None:
            if generator is None:
                raise ValueError("rollout needs a generator or an h0 draw")
            h0 = torch.randn((batch, self.hidden), generator=generator,
                             device=generator.device)
        x0 = torch.zeros((batch, self.p), device=dev)
        if noise is None:
            noise = torch.zeros((batch, steps, self.p), device=dev)
        return self._free_run(params, heads, x0, h0.to(dev), noise.to(dev),
                              steps, dtype=dtype)

    def conditioned_rollout(self, params: CRVAEParams, x_context: torch.Tensor,
                            generator: Optional[torch.Generator] = None,
                            noise: Optional[torch.Tensor] = None,
                            parents: Optional[torch.Tensor] = None,
                            length: Optional[int] = None, dtype=None,
                            eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Generation conditioned on a real context window.

        Encodes the context's last enc_len steps, samples z = mu +
        exp(logvar / 2) * eps as every head's initial state (eps (B, H)
        passed in, or drawn from ``generator``), and continues from the
        context's last observation.  JAX's parameters in JAX's order, the
        port's ``eps`` after them.  x_context: (B, T >= enc_len, p).
        Returns (B, length, p).
        """
        if x_context.shape[1] < self.enc_len:
            raise ValueError(
                f"context length {x_context.shape[1]} must be >= "
                f"enc_len={self.enc_len} to condition the latent")
        steps = self.rollout_len if length is None else length
        heads = params.heads if parents is None else masked_heads(params.heads, parents)
        mu, logvar = self.encode(params, x_context[:, -self.enc_len:, :])
        if eps is None:
            if generator is None:
                raise ValueError("conditioned_rollout needs a generator or "
                                 "an eps draw")
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device)
        z = mu + torch.exp(0.5 * logvar) * eps.to(mu.device)
        x0 = x_context[:, -1, :]
        if noise is None:
            noise = torch.zeros((x0.shape[0], steps, self.p), device=x0.device)
        return self._free_run(params, heads, x0, z, noise.to(x0.device),
                              steps, dtype=dtype)

    # ---------------- causal graph ----------------

    def gc(self, params: CRVAEParams, parents: Optional[torch.Tensor] = None,
           threshold: bool = True) -> torch.Tensor:
        """Learned Granger-causal matrix: row i, column j is the L2 norm over
        gate rows of head i's input-weight column j (or its presence)."""
        heads = params.heads if parents is None else masked_heads(params.heads, parents)
        scores = torch.linalg.vector_norm(heads.w_ih, dim=-2)   # (p, p)
        if threshold:
            return (scores > 0).to(torch.int32)
        return scores
