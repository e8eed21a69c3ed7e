"""Recurrence dispatch (port of ``vae_connexe_tpu/ops/dispatch.py``).

A CUDA tensor goes through the hand-written kernels (B1 forward, B2
backward, ``ops/cuda_gru.py``); a CPU tensor goes through the plain
recurrence of ``ops/gru.py``.  The decision is the tensor's device and
nothing else; on the card, ``cuda_gru.recurrence_route`` picks the
kernels' variant from the shapes, and shapes no kernel fits raise.

Under a sequence-parallel context (``set_seq_parallel``/``seq_parallel``,
which the fits enter when their mesh has an sp axis), ``heads_recurrence``
runs time-split over the mesh's sp ranks instead
(``parallel/seq_parallel.py``), each chunk through the same kernels.

Not ported: the JAX module's ``use_fused``/``set_fused`` switch, the
``VAE_CONNEXE_FUSED_GRU`` variable and its short-sequence cutoffs, which
were crossovers measured on a TPU.
"""

from __future__ import annotations

import dataclasses
from contextlib import contextmanager

import torch

from vae_connexe_torch.ops.cuda_gru import gru_scan_heads_fused
from vae_connexe_torch.ops.gru import GRUParams, gru_scan

# (mesh, axis, batch_axis, microbatches) while a sequence-parallel context
# is active, else None.
_SP_CTX: tuple | None = None


def set_seq_parallel(mesh=None, axis: str = "sp",
                     batch_axis: str | None = "dp",
                     microbatches: int | None = None) -> None:
    """Enable (mesh given) or disable (None) sp routing of stacked-head
    recurrences.  ``batch_axis`` names the mesh axis the batch is split
    over (ignored if the mesh lacks it)."""
    global _SP_CTX
    if mesh is None:
        _SP_CTX = None
        return
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        batch_axis = None
    _SP_CTX = (mesh, axis, batch_axis, microbatches)


@contextmanager
def seq_parallel(mesh, axis: str = "sp", batch_axis: str | None = "dp",
                 microbatches: int | None = None):
    """Scoped ``set_seq_parallel`` (the fits' integration point)."""
    global _SP_CTX
    prev = _SP_CTX
    set_seq_parallel(mesh, axis, batch_axis, microbatches)
    try:
        yield
    finally:
        _SP_CTX = prev


def heads_recurrence(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """Stacked-head GRU sequence; contract of ``ops.gru.gru_scan_heads``:
    x (B, T, D) shared or (P, B, T, D), h0 broadcastable to (P, B, H) ->
    (outs (P, B, T, H), h_T (P, B, H)).  Under an sp context with more
    than one sp rank, the time axis is split over them."""
    if _SP_CTX is not None:
        from vae_connexe_torch.parallel.mesh import axis_size

        mesh, axis, batch_axis, m = _SP_CTX
        if axis_size(mesh, axis) > 1:
            from vae_connexe_torch.parallel.seq_parallel import (
                seq_sharded_gru_heads,
            )
            return seq_sharded_gru_heads(params, x, h0, mesh, axis,
                                         microbatches=m,
                                         batch_axis=batch_axis)
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
