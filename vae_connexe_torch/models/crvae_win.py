"""CRVAE with an explicit per-head input matrix W_in (port of
``vae_connexe_tpu/models/crvae_win.py``).

The causal structure lives in W_in[p] (D x H), applied before a head GRU
of input width H: head p reads ``dec_in @ W_in[p]``, and row j of W_in[p]
having a nonzero L2 norm means series j causes series p.

- ``forward``: encode x_past (B, tau, D) to (mu, logsigma), z = mu +
  sigma * eps_z, h0 = tanh(z2h(z)) shared by every head; the decoder reads
  the teacher-forced [x_past[-1], x_cur[:-1]]; phase 2 adds the error
  VAE's reconstruction of the detached residual.
- ``generate``: encode the last tau context steps, then roll every head
  one GRU step a step on the previous emitted value through its W_in.
- ``granger_matrix``: the row norms of W_in.

On the card the recurrences run through the hand-written kernels
(``ops/dispatch.py``): the decoder is one D-head launch of B1 (B2 under
autograd) on the per-head input ``x_sel`` (D, B, T, H), whose gradient
``dx`` carries W_in's; the encoder is a one-head launch, as
``dispatch.gru_sequence`` makes it (the JAX package runs it as a plain
``lax.scan``); the error VAE's encoder and decoder are one-head launches
too.  ``forward_stacked`` is the same forward for S parameter sets
stacked on a leading seed axis (``train/win_trainer.py::fit_many``): the
seeds fold into the kernels' heads, so a forward is two launches (four in
phase 2) at any S.  ``generate`` is a PyTorch loop over steps of
``gru_step_heads`` with the W_in and readout products (JAX: a
``lax.scan``, not a Pallas kernel), in float32 or, with
``dtype=torch.bfloat16``, in bf16 (its encoder in float32), as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams
from vae_connexe_torch.ops.cuda_rollout import cast_weights, serve_dtype
from vae_connexe_torch.ops.dispatch import gru_sequence, heads_recurrence
from vae_connexe_torch.ops.gru import (
    GRUParams,
    gru_step_heads,
    init_gru,
    init_stacked_gru,
)
from vae_connexe_torch.utils.layers import (
    Dense,
    dense,
    dense_stacked,
    init_dense,
    init_stacked_dense,
)
from vae_connexe_torch.utils.tree import tree_map


@dataclasses.dataclass(frozen=True)
class WInCRVAEParams:
    enc: GRUParams          # D -> H
    fc_mu: Dense            # H -> Z
    fc_logsig: Dense        # H -> Z
    z2h: Dense              # Z -> H
    w_in: torch.Tensor      # (D, D, H): head p's input matrix is w_in[p]
    heads: GRUParams        # stacked (D, 3H, H)
    readout: Dense          # stacked (D, 1, H)
    err: ErrorVAEParams     # error-compensation VAE (D, H // 2, Z // 2)


def _flat_heads(heads: GRUParams) -> GRUParams:
    """(S, P, ...) stacked heads -> (S * P, ...)."""
    return GRUParams(*(leaf.flatten(0, 1) for leaf in
                       (heads.w_ih, heads.w_hh, heads.b_ih, heads.b_hh)))


def _h_t(params: GRUParams, x: torch.Tensor) -> torch.Tensor:
    """Final state of S stacked GRUs, each over its own input x (S, B, T,
    D), from h0 = 0: one S-head recurrence."""
    h0 = torch.zeros((1, x.shape[1], params.hidden), device=x.device,
                     dtype=x.dtype)
    return heads_recurrence(params, x, h0)[1]


def _err_forward_stacked(err: ErrorVAEParams, eps_seq: torch.Tensor,
                         eps: torch.Tensor):
    """``ErrorVAE.forward`` (no input shift, the W_in variants') for S
    stacked error VAEs: eps_seq (S, B, T, D), eps (S, B, Z).  Its encoder
    and decoder are each one S-head recurrence."""
    h_t = _h_t(err.enc, eps_seq)
    mu, logvar = dense_stacked(err.fc_mu, h_t), dense_stacked(err.fc_std,
                                                              h_t)
    z = mu + torch.exp(0.5 * logvar) * eps
    h_dec = torch.tanh(dense_stacked(err.z2h, z))
    outs, _ = heads_recurrence(err.dec, eps_seq, h_dec)
    return torch.matmul(outs, err.out.w[:, None].transpose(-1, -2)) \
        + err.out.b[:, None, None, :], mu, logvar


def win_rollout(w_in: torch.Tensor, heads: GRUParams, readout: Dense,
                x_t: torch.Tensor, h: torch.Tensor, length: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``generate``'s free run: from x_t (B, D) and every head's state h
    (D, B, H), ``length`` steps of each head reading the last emitted
    value through its W_in, in ``dtype`` (float32, or bfloat16 weights and
    carries).  Returns (B, length, D) float32."""
    if dtype != torch.float32:
        w_in, x_t, h = w_in.to(dtype), x_t.to(dtype), h.to(dtype)
        heads, readout = cast_weights(heads, dtype), cast_weights(readout, dtype)
    seq = []
    for _ in range(length):
        x_sel = torch.einsum("bd,pdh->pbh", x_t, w_in)
        h = gru_step_heads(heads, x_sel, h)
        out = (torch.einsum("pbh,poh->pbo", h, readout.w)
               + readout.b[:, None, :])
        x_t = out[..., 0].T
        seq.append(x_t)
    return torch.stack(seq, dim=1).to(torch.float32)


class WInCRVAE:
    """Functional W_in CRVAE; the JAX class's signature."""

    def __init__(self, d: int, hidden: int = 64, latent: int = 32,
                 tau: int = 10, w_in_init_scale: float = 0.01):
        self.d = d
        self.hidden = hidden
        self.latent = latent
        self.tau = tau
        self.w_in_init_scale = w_in_init_scale
        self.err_vae = ErrorVAE(d, hidden // 2, latent // 2,
                                shift_decoder_input=False)

    def init(self, generator: torch.Generator, device=None) -> WInCRVAEParams:
        """torch-default init (W_in ~ scale * N(0, 1)) from a CPU
        ``generator``, in field order, placed on ``device`` (default
        ``cuda``)."""
        dev = resolve_device(device)
        g, d, h = generator, self.d, self.hidden
        return WInCRVAEParams(
            enc=init_gru(g, d, h, device=dev),
            fc_mu=init_dense(g, h, self.latent, device=dev),
            fc_logsig=init_dense(g, h, self.latent, device=dev),
            z2h=init_dense(g, self.latent, h, device=dev),
            w_in=(self.w_in_init_scale
                  * torch.randn((d, d, h), generator=g)).to(dev),
            heads=init_stacked_gru(g, d, h, h, device=dev),
            readout=init_stacked_dense(g, d, h, 1, device=dev),
            err=self.err_vae.init(g, dev),
        )

    def encode(self, params: WInCRVAEParams, x: torch.Tensor):
        """x (B, T, D) from h0 = 0 -> (mu, logsigma), each (B, Z)."""
        h0 = torch.zeros((x.shape[0], self.hidden), device=x.device,
                         dtype=x.dtype)
        _, h_t = gru_sequence(params.enc, x, h0)
        return dense(params.fc_mu, h_t), dense(params.fc_logsig, h_t)

    def _heads_decode(self, params: WInCRVAEParams, dec_in: torch.Tensor,
                      h0: torch.Tensor) -> torch.Tensor:
        """dec_in (S, B, T, D) through each seed's per-head W_in, GRU heads
        and readout -> (S, B, T, D); every leaf of ``params`` carries the
        leading seed axis and h0 is (S, B, H).  One S * D-head recurrence:
        head s * D + p reads seed s's ``dec_in @ w_in[p]`` (no copies, each
        head has its own input) from seed s's h0."""
        s, b, t, d = dec_in.shape
        x_sel = torch.einsum("sbtd,spdh->spbth", dec_in, params.w_in)
        h0 = h0[:, None].expand(s, d, b, self.hidden)
        outs, _ = heads_recurrence(_flat_heads(params.heads),
                                   x_sel.flatten(0, 1), h0.flatten(0, 1))
        pred = (torch.einsum("spbth,spoh->spbto", outs.view(s, d, b, t, -1),
                             params.readout.w)
                + params.readout.b[:, :, None, None, :])
        return pred[..., 0].permute(0, 2, 3, 1)

    def forward_stacked(self, params: WInCRVAEParams, x_past: torch.Tensor,
                        x_cur: torch.Tensor, eps_z: torch.Tensor,
                        phase: int = 1,
                        eps_e: Optional[torch.Tensor] = None):
        """``forward`` for S parameter sets stacked on a leading axis:
        x_past, x_cur (S, B, tau, D), eps_z (S, B, Z), eps_e (S, B, Z // 2)
        in phase 2.  Returns what ``forward`` does, each with the leading
        S axis."""
        h_t = _h_t(params.enc, x_past)
        mu = dense_stacked(params.fc_mu, h_t)
        logsig = dense_stacked(params.fc_logsig, h_t)
        z = mu + torch.exp(logsig) * eps_z
        h0 = torch.tanh(dense_stacked(params.z2h, z))
        dec_in = torch.cat([x_past[:, :, -1:], x_cur[:, :, :-1]], dim=2)
        recon = self._heads_decode(params, dec_in, h0)
        if phase == 1:
            return recon, mu, logsig, None, None
        if eps_e is None:
            raise ValueError("phase 2 needs the error VAE's eps_e draw")
        # The residual is a gradient firewall: the error VAE never sends a
        # gradient into the causal decoder.
        eps = (x_cur - recon).detach()
        eps_hat, mu_e, logvar_e = _err_forward_stacked(params.err, eps, eps_e)
        return recon + eps_hat, mu, logsig, mu_e, logvar_e

    def forward(self, params: WInCRVAEParams, x_past: torch.Tensor,
                x_cur: torch.Tensor, eps_z: Optional[torch.Tensor] = None,
                phase: int = 1, eps_e: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Teacher-forced reconstruction of x_cur (B, tau, D) from x_past.

        The draws are tensors: ``eps_z`` (B, Z) and, in phase 2, the error
        VAE's ``eps_e`` (B, Z // 2); or a ``generator`` draws the missing
        ones in JAX's order (``k_z`` first, then ``k_e``).  Returns (recon,
        mu, logsigma, mu_e, logvar_e); the error-VAE stats are None in
        phase 1.
        """
        b = x_past.shape[0]
        if eps_z is None or (phase == 2 and eps_e is None):
            if generator is None:
                raise ValueError("forward needs its draws or a generator")
            gdev = generator.device
            if eps_z is None:
                eps_z = torch.randn((b, self.latent), generator=generator,
                                    device=gdev)
            if phase == 2 and eps_e is None:
                eps_e = torch.randn((b, self.err_vae.latent),
                                    generator=generator, device=gdev)
        dev = x_past.device
        one = tree_map(lambda t: t[None], params)
        outs = self.forward_stacked(
            one, x_past[None], x_cur[None], eps_z.to(dev)[None], phase,
            None if eps_e is None else eps_e.to(dev)[None])
        return tuple(None if o is None else o[0] for o in outs)

    def generate(self, params: WInCRVAEParams, x_context: torch.Tensor,
                 generator: Optional[torch.Generator], length: int,
                 dtype=None, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Autoregressive free-running generation.  Returns (B, length, D).

        Encodes the context's last tau steps, z = mu + sigma * eps (eps
        (B, Z) passed in, or drawn from ``generator``), h0 = tanh(z2h(z))
        for every head, then each step feeds every head the previous
        emitted value through its W_in.  ``dtype``: the serving precision;
        with bfloat16 the rollout's weights (W_in, heads, readout) and
        carries are bf16 and its products and gate math run in PyTorch's
        bf16 ops, the one-pass encoder stays float32 and the output is
        float32, as JAX's ``generate(dtype=jnp.bfloat16)``.
        """
        dt = serve_dtype(dtype)
        mu, logsig = self.encode(params, x_context[:, -self.tau:, :])
        if eps is None:
            if generator is None:
                raise ValueError("generate needs a generator or an eps draw")
            eps = torch.randn(mu.shape, generator=generator,
                              device=generator.device)
        z = mu + torch.exp(logsig) * eps.to(mu.device)
        h = torch.tanh(dense(params.z2h, z)).expand(self.d, -1, -1)
        return win_rollout(params.w_in, params.heads, params.readout,
                           x_context[:, -1, :], h, length, dt)

    def granger_matrix(self, params: WInCRVAEParams, thr: float = 1e-6,
                       threshold: bool = True) -> torch.Tensor:
        """(D, D) causal matrix, entry (p, j) from ||W_in[p][j, :]||_2 (a
        leading seed axis is kept)."""
        scores = torch.linalg.vector_norm(params.w_in, dim=-1)
        if threshold:
            return (scores > thr).to(torch.float32)
        return scores
