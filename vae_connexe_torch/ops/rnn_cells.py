"""Elman-RNN and LSTM cells for the plain VRAE (port of
``vae_connexe_tpu/ops/rnn_cells.py``).

torch's layouts: the LSTM's gate rows [i; f; g; o] in (4H, D) and (4H, H)
weights; the RNN is tanh.  Plain PyTorch: the JAX package has no kernel for
these cells either (its scans are ``lax.scan``).  The GRU is
``ops/gru.py``'s.  Initialisation is torch's U(-1/sqrt(H), 1/sqrt(H)) for
every leaf, drawn in field order from a CPU generator.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vae_connexe_torch.utils.layers import uniform


@dataclasses.dataclass(frozen=True)
class RNNCellParams:
    w_ih: torch.Tensor   # (H, D)
    w_hh: torch.Tensor   # (H, H)
    b_ih: torch.Tensor   # (H,)
    b_hh: torch.Tensor   # (H,)


@dataclasses.dataclass(frozen=True)
class LSTMCellParams:
    w_ih: torch.Tensor   # (4H, D)
    w_hh: torch.Tensor   # (4H, H)
    b_ih: torch.Tensor   # (4H,)
    b_hh: torch.Tensor   # (4H,)


def _uniform_init(generator, shapes, hidden, dtype, device):
    k = 1.0 / math.sqrt(hidden)
    return [uniform(generator, s, k, device, dtype) for s in shapes]


def init_rnn_cell(generator: torch.Generator, d_in: int, hidden: int,
                  dtype=torch.float32, device=None) -> RNNCellParams:
    return RNNCellParams(*_uniform_init(
        generator, [(hidden, d_in), (hidden, hidden), (hidden,), (hidden,)],
        hidden, dtype, device))


def init_lstm_cell(generator: torch.Generator, d_in: int, hidden: int,
                   dtype=torch.float32, device=None) -> LSTMCellParams:
    g = 4 * hidden
    return LSTMCellParams(*_uniform_init(
        generator, [(g, d_in), (g, hidden), (g,), (g,)], hidden, dtype,
        device))


def rnn_cell(p: RNNCellParams, x_t: torch.Tensor,
             h: torch.Tensor) -> torch.Tensor:
    return torch.tanh(x_t @ p.w_ih.T + p.b_ih + h @ p.w_hh.T + p.b_hh)


def _lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def lstm_cell(p: LSTMCellParams, x_t: torch.Tensor, state):
    """state = (h, c) -> (h', c')."""
    h, c = state
    return _lstm_gates(x_t @ p.w_ih.T + p.b_ih + h @ p.w_hh.T + p.b_hh, c)


def rnn_scan(p: RNNCellParams, x: torch.Tensor, h0: torch.Tensor):
    """x (B, T, D), h0 (B, H) -> (outs (B, T, H), h_T)."""
    xp = x @ p.w_ih.T + p.b_ih
    h, outs = h0, []
    for t in range(x.shape[1]):
        h = torch.tanh(xp[:, t] + h @ p.w_hh.T + p.b_hh)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def lstm_scan(p: LSTMCellParams, x: torch.Tensor, state0):
    """x (B, T, D), state0 = (h0, c0) -> (outs (B, T, H), (h_T, c_T))."""
    xp = x @ p.w_ih.T + p.b_ih
    (h, c), outs = state0, []
    for t in range(x.shape[1]):
        h, c = _lstm_gates(xp[:, t] + h @ p.w_hh.T + p.b_hh, c)
        outs.append(h)
    return torch.stack(outs, dim=1), (h, c)
