"""Plain variational recurrent autoencoder (port of
``vae_connexe_tpu/models/vrae.py``).

A cell-configurable encoder (RNN, GRU or LSTM), a per-step decoder loop of
the same cell with a learnable start token and stochastic teacher forcing
(each step one coin, shared by the batch: with probability
``teacher_forcing_ratio`` the next input is the ground truth, else the
model's own output), a configurable output activation, the beta-VAE loss
(sum-reduced MSE / B + beta * KL), ``generate``/``sample`` from the prior,
and the exponential and linear teacher-forcing schedules.

For ``rnn_type='gru'`` the encoder goes through
``ops/dispatch.py::gru_sequence``, the function of JAX's ``gru_scan``: on a
CUDA tensor a one-head launch of B1 and, under autograd, of B2, routed as
``ErrorVAE.forward``'s; on a CPU tensor the plain ``gru_scan``.  The RNN
and LSTM encoders are plain scans (``ops/rnn_cells.py``).  The decoder's
input at each step is its own last output, so it is a PyTorch loop of the
cell, as the JAX package runs it as a ``lax.scan``: no kernel applies.
The draws (epsilon, the coins) are passed in or drawn from a generator.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.ops.dispatch import gru_sequence
from vae_connexe_torch.ops.gru import GRUParams, gru_cell, init_gru
from vae_connexe_torch.ops.rnn_cells import (
    LSTMCellParams,
    RNNCellParams,
    init_lstm_cell,
    init_rnn_cell,
    lstm_cell,
    lstm_scan,
    rnn_cell,
    rnn_scan,
)
from vae_connexe_torch.utils.layers import Dense, dense, init_dense

CellParams = Union[GRUParams, LSTMCellParams, RNNCellParams]


@dataclasses.dataclass(frozen=True)
class VRAEParams:
    enc_rnn: CellParams
    fc_mu: Dense
    fc_logvar: Dense
    z2h: Dense
    dec_cell: CellParams
    fc_out: Dense
    start_token: torch.Tensor   # (1, D)


_ACTIVATIONS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "none": lambda x: x,
}


def _draw(given, generator, what: str, fn):
    if given is not None:
        return given
    if generator is None:
        raise ValueError(f"needs a {what} draw or a generator")
    return fn(generator)


class VRAE:
    def __init__(self, input_dim: int, hidden_dim: int = 64,
                 latent_dim: int = 2, rnn_type: str = "gru",
                 output_activation: str = "sigmoid"):
        if rnn_type not in ("rnn", "gru", "lstm"):
            raise ValueError(f"unknown rnn_type {rnn_type!r}")
        self.d = input_dim
        self.hidden = hidden_dim
        self.latent = latent_dim
        self.rnn_type = rnn_type
        self.act = _ACTIVATIONS[output_activation]

    def init(self, generator: torch.Generator, device=None) -> VRAEParams:
        """torch-default init drawn from a CPU ``generator`` in field order,
        the start token N(0, 1), placed on ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        g = generator
        init_cell = {"rnn": init_rnn_cell, "gru": init_gru,
                     "lstm": init_lstm_cell}[self.rnn_type]
        return VRAEParams(
            enc_rnn=init_cell(g, self.d, self.hidden, device=dev),
            fc_mu=init_dense(g, self.hidden, self.latent, device=dev),
            fc_logvar=init_dense(g, self.hidden, self.latent, device=dev),
            z2h=init_dense(g, self.latent, self.hidden, device=dev),
            dec_cell=init_cell(g, self.d, self.hidden, device=dev),
            fc_out=init_dense(g, self.hidden, self.d, device=dev),
            start_token=torch.randn((1, self.d), generator=g).to(dev),
        )

    # ---------------- encoder ----------------

    def encode(self, params: VRAEParams, x: torch.Tensor):
        """x (B, T, D) -> (mu, logvar), each (B, latent)."""
        h0 = torch.zeros((x.shape[0], self.hidden), device=x.device,
                         dtype=x.dtype)
        if self.rnn_type == "lstm":
            _, (h_t, _) = lstm_scan(params.enc_rnn, x,
                                    (h0, torch.zeros_like(h0)))
        elif self.rnn_type == "gru":
            _, h_t = gru_sequence(params.enc_rnn, x, h0)
        else:
            _, h_t = rnn_scan(params.enc_rnn, x, h0)
        return dense(params.fc_mu, h_t), dense(params.fc_logvar, h_t)

    @staticmethod
    def reparameterize(eps: torch.Tensor, mu: torch.Tensor,
                       logvar: torch.Tensor) -> torch.Tensor:
        return mu + torch.exp(0.5 * logvar) * eps

    # ---------------- decoder ----------------

    def _cell(self, params: VRAEParams, x_in, state):
        if self.rnn_type == "lstm":
            return lstm_cell(params.dec_cell, x_in, state)
        if self.rnn_type == "gru":
            return gru_cell(params.dec_cell, x_in, state)
        return rnn_cell(params.dec_cell, x_in, state)

    def decode(self, params: VRAEParams, z: torch.Tensor, seq_len: int,
               generator: Optional[torch.Generator] = None,
               target: Optional[torch.Tensor] = None,
               teacher_forcing_ratio: float = 1.0,
               coins: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Autoregressive decode with per-step stochastic teacher forcing.

        With a target (B, seq_len, D), step 0 reads ``target[:, 0]`` when
        the ratio is above 0 (else the start token), and step t + 1 reads
        ``target[:, t + 1]`` where ``coins[t] < teacher_forcing_ratio``,
        else the model's own output at t.  ``coins`` (seq_len,) are
        uniform draws on [0, 1), passed in or drawn from ``generator``.
        Without a target every step reads the model's own output and
        nothing is drawn.  Returns (B, seq_len, D).
        """
        b = z.shape[0]
        h = torch.tanh(dense(params.z2h, z))
        state = (h, torch.zeros_like(h)) if self.rnn_type == "lstm" else h
        x_in = params.start_token.expand(b, self.d)
        take = None
        if target is not None:
            if teacher_forcing_ratio > 0:
                x_in = target[:, 0, :]
            coins = _draw(coins, generator, "coins", lambda g: torch.rand(
                (seq_len,), generator=g, device=g.device))
            take = coins.to(z.device) < teacher_forcing_ratio
        outs = []
        for t in range(seq_len):
            state = self._cell(params, x_in, state)
            h_new = state[0] if self.rnn_type == "lstm" else state
            x_t = self.act(dense(params.fc_out, h_new))
            outs.append(x_t)
            if take is None:
                x_in = x_t
            else:
                # The next-frame feed of step t is target[:, t + 1]; the
                # last step's is never read.
                nxt = target[:, min(t + 1, target.shape[1] - 1), :]
                x_in = torch.where(take[t], nxt, x_t)
        return torch.stack(outs, dim=1)

    # ---------------- public API ----------------

    def forward(self, params: VRAEParams, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                teacher_forcing_ratio: float = 1.0,
                eps: Optional[torch.Tensor] = None,
                coins: Optional[torch.Tensor] = None):
        """(recon, mu, logvar).  Draws not passed in come from
        ``generator``: eps (B, latent) first, then the coins (T,), the
        order of the reference's key split."""
        mu, logvar = self.encode(params, x)
        eps = _draw(eps, generator, "eps", lambda g: torch.randn(
            mu.shape, generator=g, device=g.device))
        z = self.reparameterize(eps.to(mu.device), mu, logvar)
        if coins is None and generator is not None:
            coins = torch.rand((x.shape[1],), generator=generator,
                               device=generator.device)
        recon = self.decode(params, z, x.shape[1], target=x,
                            teacher_forcing_ratio=teacher_forcing_ratio,
                            coins=coins)
        return recon, mu, logvar

    def generate(self, params: VRAEParams, z: torch.Tensor,
                 seq_len: int) -> torch.Tensor:
        """Decode latent codes with no teacher forcing."""
        return self.decode(params, z, seq_len)

    def sample(self, params: VRAEParams, generator: Optional[torch.Generator],
               batch: int, seq_len: int,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Sequences from the N(0, I) prior: z = ``eps`` (batch, latent),
        passed in or drawn from ``generator``."""
        z = _draw(eps, generator, "eps", lambda g: torch.randn(
            (batch, self.latent), generator=g, device=g.device))
        return self.generate(params, z.to(params.start_token.device), seq_len)

    @staticmethod
    def loss(recon: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
             logvar: torch.Tensor, beta: float = 1.0):
        """beta-VAE loss, sum-reduced and normalised by the batch:
        (total, rec, kld)."""
        b = x.shape[0]
        rec = torch.sum((recon - x) ** 2) / b
        kld = -0.5 * torch.sum(1.0 + logvar - mu ** 2 - torch.exp(logvar)) / b
        return rec + beta * kld, rec, kld


def exponential_teacher_forcing_schedule(epoch: int, initial_ratio: float = 1.0,
                                         decay_rate: float = 0.05) -> float:
    return initial_ratio * (1.0 - decay_rate) ** epoch


def linear_teacher_forcing_schedule(epoch: int, initial_ratio: float = 1.0,
                                    final_ratio: float = 0.0,
                                    total_epochs: int = 100) -> float:
    return initial_ratio - (initial_ratio - final_ratio) * (epoch / total_epochs)
