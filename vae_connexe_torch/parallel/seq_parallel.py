"""Sequence-parallel (sp) recurrence: the GRU time axis split over the
ranks of a mesh axis, the carried state sent rank to rank (port of
``vae_connexe_tpu/parallel/seq_parallel.py``).

- Rank s of the sp line owns time chunk s, of length T / S, and runs its
  slice of the recurrence; on the card each chunk is one B1 launch with the
  incoming state as h0 and, backward, one B2 launch that returns dh0
  (``ops/cuda_gru.py``); on the CPU their plain versions.
- The carry (P, Bm, H) goes from rank s to rank s + 1 by ``send``/``recv``
  (``parallel/collectives.py``; staged through the host when two ranks
  share a card over gloo).
- The batch splits into M microbatches, pipelined GPipe-style: in round k
  rank s runs microbatch k - s, so after an S - 1 round fill all S ranks
  compute at once; the pipeline's efficiency is M / (M + S - 1).
- h_T lives on the last rank and is broadcast from it to the line (a
  broadcast moves one (P, B, H) message a rank; an all-gather would move S
  of them to keep one).

JAX differentiates the shard_map'ed pipeline itself.  Point-to-point sends
have no autograd, so the pipeline is one ``torch.autograd.Function``
(``_Pipeline``) whose forward runs the round schedule, keeping each
microbatch's local graph, and whose backward runs it in reverse: rank s
receives dh for microbatch m from rank s + 1 (the last rank takes it from
h_T's gradient), back-propagates its chunk, sends dh_in to rank s - 1, in
the same order on every rank, so every send meets its receive.  The
parameter gradients of the chunks are then summed over the line in rank
order and dh0 is broadcast from rank 0, so that every rank of the line
ends with the gradient the single recurrence would give.

Contract (rank-local): every rank of one sp line passes the same x and h0
(its dp slice of the batch when the batch is split over ``batch_axis``)
and computes the same function of the outputs, as the fits do; it gets
the outputs of ``ops.gru.gru_scan_heads`` on those inputs, and the
gradients of its inputs and parameters.  With ``batch_axis`` the
parameter gradients are those of this rank's batch slice; the caller sums
them over dp (the sharded steps do).
"""

from __future__ import annotations

import warnings

import torch

from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.parallel import collectives as coll
from vae_connexe_torch.parallel.mesh import axis_group, axis_index, axis_size


def _chunk_recurrence(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """Recurrence over one local time chunk: x (B, Tc, D) shared or
    (P, B, Tc, D), h0 (P, B, H) -> (outs (P, B, Tc, H), h_Tc (P, B, H)).
    The kernels project the input inside (B1), so the chunk takes the raw
    x, as JAX's fused path does, not a pre-projection; on the card B1/B2,
    on the CPU their plain versions."""
    from vae_connexe_torch.ops.cuda_gru import gru_scan_heads_fused

    return gru_scan_heads_fused(params, x, h0)


def _time_slice(x: torch.Tensor, s: int, tc: int) -> torch.Tensor:
    return x[..., s * tc:(s + 1) * tc, :]


class _GatherTime(torch.autograd.Function):
    """Forward: every rank's chunk of outs (P, B, Tc, H) concatenated along
    time.  Backward: this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, outs_loc, group, s, tc):
        ctx.s, ctx.tc = s, tc
        return coll.cat_gather(outs_loc, group, dim=2)

    @staticmethod
    def backward(ctx, grad):
        return _time_slice(grad, ctx.s, ctx.tc), None, None, None


class _SliceTime(torch.autograd.Function):
    """Forward: this rank's time chunk of x.  Backward: every rank's chunk
    of dx, concatenated (the gradient of a replicated x)."""

    @staticmethod
    def forward(ctx, x, group, s, tc):
        ctx.group = group
        return _time_slice(x, s, tc).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return coll.cat_gather(grad, ctx.group, dim=-2), None, None, None


class _Pipeline(torch.autograd.Function):
    """The GPipe round schedule over this rank's chunk (module doc)."""

    @staticmethod
    def forward(ctx, spec, x_loc, h0, w_ih, b_ih, w_hh, b_hh):
        group, s, n_sp, m = spec
        p_heads, b, hidden = h0.shape
        bm = b // m
        need_x = ctx.needs_input_grad[1]
        graphs = [None] * m
        outs, h_last = [None] * m, [None] * m
        for k in range(n_sp + m - 1):
            mi = k - s
            if not 0 <= mi < m:
                continue
            rows = slice(mi * bm, (mi + 1) * bm)
            if s == 0:
                h_in = h0[:, rows]
            else:
                h_in = coll.recv(h0.new_empty((p_heads, bm, hidden)), s - 1,
                                 group)
            x_mb = x_loc[..., rows, :, :]
            with torch.enable_grad():
                leaves = [w.detach().requires_grad_(True)
                          for w in (w_ih, b_ih, w_hh, b_hh)]
                h_l = h_in.detach().requires_grad_(True)
                x_l = x_mb.detach().requires_grad_(need_x)
                w = dict(zip(("w_ih", "b_ih", "w_hh", "b_hh"), leaves))
                o, h_t = _chunk_recurrence(GRUParams(**w), x_l, h_l)
            graphs[mi] = (leaves, h_l, x_l, o)
            if s < n_sp - 1:
                coll.send(h_t.detach(), s + 1, group)
            outs[mi], h_last[mi] = o.detach(), h_t.detach()
        ctx.spec, ctx.graphs, ctx.bm = spec, graphs, bm
        h_full = torch.cat(h_last, dim=1)
        return torch.cat(outs, dim=1), coll.broadcast(h_full, n_sp - 1,
                                                      group)

    @staticmethod
    def backward(ctx, d_outs, d_ht):
        group, s, n_sp, m = ctx.spec
        bm = ctx.bm
        dws, dh0, dx = None, [None] * m, [None] * m
        for k in reversed(range(n_sp + m - 1)):
            mi = k - s
            if not 0 <= mi < m:
                continue
            rows = slice(mi * bm, (mi + 1) * bm)
            leaves, h_l, x_l, o = ctx.graphs[mi]
            if s == n_sp - 1:
                dh = d_ht[:, rows]
            else:
                dh = coll.recv(h_l, s + 1, group)
            d_o = d_outs[:, rows].clone()
            d_o[:, :, -1] += dh
            inputs = leaves + [h_l] + ([x_l] if x_l.requires_grad else [])
            grads = torch.autograd.grad(o, inputs, d_o)
            dws = (list(grads[:4]) if dws is None
                   else [a + g for a, g in zip(dws, grads[:4])])
            if s > 0:
                coll.send(grads[4], s - 1, group)
            else:
                dh0[mi] = grads[4]
            if x_l.requires_grad:
                dx[mi] = grads[5]
        ctx.graphs = None
        dws = coll.ordered_sum_flat(dws, group)
        d_h0 = (torch.cat(dh0, dim=1) if s == 0 else
                torch.empty_like(d_ht))
        d_h0 = coll.broadcast(d_h0, 0, group)
        d_x = (torch.cat(dx, dim=-3) if ctx.needs_input_grad[1] else None)
        return (None, d_x, d_h0, *dws)


def seq_sharded_gru_heads(params: GRUParams, x: torch.Tensor,
                          h0: torch.Tensor, mesh, axis: str = "sp",
                          microbatches: int | None = None,
                          batch_axis: str | None = None):
    """Stacked-head GRU with the time axis split over ``mesh``'s ``axis``.

    Drop-in contract of ``ops.gru.gru_scan_heads`` on this rank's inputs
    (module doc):

    Args:
      params: stacked ``GRUParams``, leading head axis P (replicated).
      x: (B, T, D) shared input sequence (or (P, B, T, D) per head); T must
        divide by the sp size.
      h0: (P, B, H) initial hidden per head, or broadcastable to it.
      mesh: a port mesh (``parallel/mesh.py``) with ``axis``.
      microbatches: pipeline depth M (divides the batch).  Default: the
        largest divisor of the batch that is <= the sp size.
      batch_axis: the mesh axis the batch is split over (the fits' dp):
        x and h0 are then this rank's slice and the pipeline runs on it.

    Returns:
      (outs (P, B, T, H), h_T (P, B, H)), the same on every rank of the
      line.
    """
    n_sp = axis_size(mesh, axis)
    t_len = x.shape[-2]
    if t_len % n_sp:
        raise ValueError(
            f"sequence length {t_len} not divisible by the '{axis}' mesh size "
            f"{n_sp} — pad the window or choose a dividing sp size")
    p_heads, hidden = params.w_ih.shape[0], params.hidden
    b = x.shape[-3]
    if batch_axis is not None and batch_axis not in mesh.mesh_dim_names:
        raise ValueError(f"batch_axis '{batch_axis}' is not an axis of the "
                         f"mesh {mesh.mesh_dim_names}")
    if microbatches is not None:
        m = microbatches
    else:
        m = max(d for d in range(1, min(b, n_sp) + 1) if b % d == 0)
        if m == 1 and b > 1 and n_sp > 1:
            warnings.warn(
                f"seq-parallel pipeline: batch {b} has no divisor ≤ sp size "
                f"{n_sp} except 1 — microbatches=1 means zero compute "
                f"overlap (efficiency 1/{n_sp}). Pad the batch to a "
                f"multiple of a small integer (e.g. {n_sp}) to pipeline.",
                stacklevel=2)
    if b % m:
        raise ValueError(
            f"batch {b} not divisible by microbatches={m} — choose a pipeline "
            f"depth dividing the batch")
    group = axis_group(mesh, axis)
    s = axis_index(mesh, axis)
    tc = t_len // n_sp
    h0 = h0.expand(p_heads, b, hidden)
    if x.requires_grad:
        x_loc = _SliceTime.apply(x, group, s, tc)
    else:
        x_loc = _time_slice(x, s, tc).contiguous()
    outs_loc, h_t = _Pipeline.apply((group, s, n_sp, m), x_loc, h0,
                                    params.w_ih, params.b_ih, params.w_hh,
                                    params.b_hh)
    return _GatherTime.apply(outs_loc, group, s, tc), h_t


def seq_sharded_gru(params: GRUParams, x: torch.Tensor, h0: torch.Tensor,
                    mesh, axis: str = "sp", microbatches: int | None = None):
    """Single (unstacked) GRU with a sequence-split time axis; contract of
    ``ops.gru.gru_scan``, through the stacked pipeline as a 1-head stack."""
    stacked = GRUParams(params.w_ih[None], params.w_hh[None],
                        params.b_ih[None], params.b_hh[None])
    outs, h_t = seq_sharded_gru_heads(stacked, x, h0[None], mesh, axis,
                                      microbatches)
    return outs[0], h_t[0]
