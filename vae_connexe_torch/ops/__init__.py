"""Recurrence primitives, the plain RNN/LSTM cells and the hand-written
CUDA kernels (``cuda_gru``, ``cuda_rollout``, ``cuda_step``, imported by
name).

The JAX package's ``set_fused`` is not exported: its switch between the
Pallas and the XLA recurrence was set from TPU measurements, and the
port's dispatch goes by the tensor's device alone (``ops/dispatch.py``).
"""

from vae_connexe_torch.ops.dispatch import gru_sequence, heads_recurrence
from vae_connexe_torch.ops.gru import (
    GRUParams,
    gru_cell,
    gru_scan,
    gru_scan_heads,
    gru_step_heads,
    init_gru,
    init_stacked_gru,
)
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

__all__ = [
    "GRUParams",
    "LSTMCellParams",
    "RNNCellParams",
    "gru_cell",
    "gru_scan",
    "gru_scan_heads",
    "gru_sequence",
    "gru_step_heads",
    "heads_recurrence",
    "init_gru",
    "init_lstm_cell",
    "init_rnn_cell",
    "init_stacked_gru",
    "lstm_cell",
    "lstm_scan",
    "rnn_cell",
    "rnn_scan",
]
