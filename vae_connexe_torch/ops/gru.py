"""GRU cell and stacked-head step (port of ``vae_connexe_tpu/ops/gru.py``).

Gate math matches torch ``nn.GRU`` (gate order r, z, n; the reset gate
multiplies the hidden candidate projection, bias included):

    r = sigmoid(x W_ir^T + b_ir + h W_hr^T + b_hr)
    z = sigmoid(x W_iz^T + b_iz + h W_hz^T + b_hz)
    n = tanh  (x W_in^T + b_in + r * (h W_hn^T + b_hn))
    h' = (1 - z) * n + z * h

Initialisation is torch's default U(-1/sqrt(H), 1/sqrt(H)) for every leaf.
The whole-sequence recurrences ``gru_scan`` and ``gru_scan_heads`` are the
plain, autograd-differentiable reference; ``ops/dispatch.py`` routes a CUDA
tensor through the hand-written kernels instead (``ops/cuda_gru.py``).  The
JAX module's TPU scheduling levers (``UNROLL_MAX_T``, in-cell projection,
segment remat, bf16 residuals, per-cell checkpointing, batched dispatch)
have no counterpart here.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vae_connexe_torch.utils.layers import uniform


@dataclasses.dataclass(frozen=True)
class GRUParams:
    """Single-layer GRU parameters, torch layout.

    ``w_ih``: (3H, D_in) rows ordered [reset; update; new].
    ``w_hh``: (3H, H).
    ``b_ih``, ``b_hh``: (3H,).

    Stacked (multi-head) variants carry one extra leading axis on every
    leaf, e.g. ``w_ih``: (P, 3H, D_in).
    """

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor

    @property
    def hidden(self) -> int:
        return self.w_hh.shape[-1]


def init_gru(generator: torch.Generator, d_in: int, hidden: int,
             dtype=torch.float32, device=None) -> GRUParams:
    """torch-default uniform init U(-k, k), k = 1/sqrt(hidden), on
    ``device`` (default ``cuda``)."""
    return init_stacked_gru(generator, None, d_in, hidden, dtype, device)


def init_stacked_gru(generator: torch.Generator, n_heads: int | None,
                     d_in: int, hidden: int, dtype=torch.float32,
                     device=None) -> GRUParams:
    """P independent GRUs stacked on a leading axis (``n_heads=None``: one
    GRU, no leading axis)."""
    k = 1.0 / math.sqrt(hidden)
    lead = () if n_heads is None else (n_heads,)
    g = 3 * hidden
    return GRUParams(
        w_ih=uniform(generator, lead + (g, d_in), k, device, dtype),
        w_hh=uniform(generator, lead + (g, hidden), k, device, dtype),
        b_ih=uniform(generator, lead + (g,), k, device, dtype),
        b_hh=uniform(generator, lead + (g,), k, device, dtype),
    )


def _gates(xp: torch.Tensor, hp: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU state update from pre-projected input xp and hidden proj hp."""
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1.0 - z) * n + z * h


def gru_cell(params: GRUParams, x_t: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Single GRU step.  x_t: (..., D_in), h: (..., H) -> h': (..., H)."""
    xp = x_t @ params.w_ih.T + params.b_ih
    hp = h @ params.w_hh.T + params.b_hh
    return _gates(xp, hp, h)


def gru_step_heads(params: GRUParams, x_t: torch.Tensor,
                   h: torch.Tensor) -> torch.Tensor:
    """One step of P stacked GRUs (rollout inner step).

    x_t: (B, D) shared across heads, or (P, B, D) per-head inputs;
    h: (P, B, H).  Returns h': (P, B, H).
    """
    if x_t.ndim == 2:
        xp = torch.einsum("bd,pgd->pbg", x_t, params.w_ih)
    else:
        xp = torch.einsum("pbd,pgd->pbg", x_t, params.w_ih)
    xp = xp + params.b_ih[:, None, :]
    hp = torch.einsum("pbh,pgh->pbg", h, params.w_hh) + params.b_hh[:, None, :]
    return _gates(xp, hp, h)


def gru_scan(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """Full-sequence GRU.  x: (B, T, D), h0: (B, H) -> (outs (B, T, H), h_T).

    The input projection of every step is one product before the loop; the
    loop holds the hidden projection and the gate math.
    """
    xp = x @ params.w_ih.T + params.b_ih                   # (B, T, 3H)
    h = h0
    outs = []
    for t in range(x.shape[1]):
        hp = h @ params.w_hh.T + params.b_hh
        h = _gates(xp[:, t], hp, h)
        outs.append(h)
    return torch.stack(outs, dim=1), h


def gru_scan_heads(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    """P stacked GRUs over one shared or per-head input sequence.

    params: stacked ``GRUParams`` with leading axis P; x: (B, T, D) shared
    or (P, B, T, D) per head; h0: (P, B, H) or broadcastable to it, e.g.
    (P, 1, H).  Returns (outs (P, B, T, H), h_T (P, B, H)).
    """
    if x.ndim == 3:
        xp = torch.einsum("btd,pgd->pbtg", x, params.w_ih)
    else:
        xp = torch.einsum("pbtd,pgd->pbtg", x, params.w_ih)
    xp = xp + params.b_ih[:, None, None, :]
    h = h0.expand(xp.shape[0], xp.shape[1], params.hidden)
    outs = []
    for t in range(xp.shape[2]):
        hp = torch.einsum("pbh,pgh->pbg", h, params.w_hh) + params.b_hh[:, None, :]
        h = _gates(xp[:, :, t], hp, h)
        outs.append(h)
    return torch.stack(outs, dim=2), h
