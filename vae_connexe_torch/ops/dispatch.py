"""Recurrence dispatch (port of ``vae_connexe_tpu/ops/dispatch.py``).

A CUDA tensor goes through the hand-written kernels (B1 forward, B2
backward, ``ops/cuda_gru.py``); a CPU tensor goes through the plain
recurrence of ``ops/gru.py``.  The decision is the tensor's device and
nothing else; on the card, ``cuda_gru.recurrence_route`` picks the
kernels' variant from the shapes, and shapes no kernel fits raise.

Not ported: the JAX module's ``use_fused``/``set_fused`` switch, the
``VAE_CONNEXE_FUSED_GRU`` variable and its short-sequence cutoffs, which
were crossovers measured on a TPU, and the sequence-parallel routing
(``set_seq_parallel``), which belongs with ``parallel/`` (ROADMAP A7).
"""

from __future__ import annotations

import dataclasses

import torch

from vae_connexe_torch.ops.cuda_gru import gru_scan_heads_fused
from vae_connexe_torch.ops.gru import GRUParams, gru_scan


def heads_recurrence(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """Stacked-head GRU sequence; contract of ``ops.gru.gru_scan_heads``:
    x (B, T, D) shared or (P, B, T, D), h0 broadcastable to (P, B, H) ->
    (outs (P, B, T, H), h_T (P, B, H))."""
    return gru_scan_heads_fused(params, x, h0)


def gru_sequence(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """Single GRU sequence; contract of ``ops.gru.gru_scan``: x (B, T, D),
    h0 (B, H) -> (outs (B, T, H), h_T (B, H)).  On the card it runs as a
    one-head stack through B1/B2."""
    if x.device.type == "cpu":
        return gru_scan(params, x, h0)
    stacked = GRUParams(*(getattr(params, f.name)[None]
                          for f in dataclasses.fields(params)))
    outs, h_t = gru_scan_heads_fused(stacked, x, h0[None])
    return outs[0], h_t[0]
