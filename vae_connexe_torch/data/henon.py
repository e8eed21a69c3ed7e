"""Hénon-map benchmarks (port of ``vae_connexe_tpu/data/henon.py``).

1. The classic 2-D Hénon map, x' = 1 - 1.4 x² + y, y' = 0.3 x, from
   (0.1, 0.1), with the reference's chain truth (``henon_truth``) and the
   map's own dependency graph (``henon_dynamics_truth``).
2. The coupled D-dimensional Hénon chain: node 0 is a plain Hénon map,
   node p couples to p - 1 through ``e·x[t-1, p-1] + (1-e)·x[t-1, p]``
   before the quadratic; min-max scaled per variable to [0, 1].

Both recursions are sequential scalar loops, and chaotic: a difference of
one rounding grows past 1e-5 within some 30 steps.  They run here as a
Python loop over steps on float32 CPU tensors in the JAX package's order
of operations, with each multiply-add rounded once, as XLA's CPU backend
fuses it (``_fma``), so the same draws give the JAX package's series bit
for bit; the result then moves to ``device``, the same on every device.
They are not kernels (JAX runs them as ``lax.scan``, not Pallas).
"""

from __future__ import annotations

from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product of two float32
    values is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def henon_chain(t: int = 1000, device=None) -> torch.Tensor:
    """Classic 2-D Hénon map from (0.1, 0.1), deterministic.  Returns
    (t, 2) float32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    x = torch.tensor(0.1, dtype=torch.float32)
    y = torch.tensor(0.1, dtype=torch.float32)
    traj = torch.empty((t, 2), dtype=torch.float32)
    for step in range(t):
        x, y = _fma(-(1.4 * x), x, torch.tensor(1.0)) + y, 0.3 * x
        traj[step, 0], traj[step, 1] = x, y
    return traj.to(dev)


def henon_truth(dim: int = 2, device=None) -> torch.Tensor:
    """Chain GC (int32): self-loops plus each variable caused by its
    predecessor, the matrix the reference scores against.  It does not
    match the 2-D generator; see ``henon_dynamics_truth``."""
    dev = resolve_device(device)
    gc = torch.eye(dim, dtype=torch.int32, device=dev)
    gc = gc + torch.diag(torch.ones(dim - 1, dtype=torch.int32, device=dev),
                         -1)
    return gc.clamp(0, 1)


def henon_dynamics_truth(device=None) -> torch.Tensor:
    """The 2-D Hénon map's own dependency graph (int32): x depends on
    {x, y}, y on {x} only."""
    return torch.tensor([[1, 1], [1, 0]], dtype=torch.int32,
                        device=resolve_device(device))


def coupled_henon(generator: Optional[torch.Generator] = None, t: int = 3000,
                  d: int = 6, a: float = 1.4, b: float = 0.3, e: float = 0.3,
                  burn_in: int = 100,
                  x0_draw: Optional[torch.Tensor] = None,
                  device=None) -> torch.Tensor:
    """Coupled Hénon chain, min-max scaled per variable.  Returns (t, d)
    float32 on ``device`` (default ``cuda``).

    The two initial rows x[t-2], x[t-1] are 0.1·N(0, 1) draws, the JAX
    package's basin-safe start: two (d,) standard normals from
    ``generator`` in that order, or ``x0_draw`` (2, d) passed in.  A
    burn-in of ``burn_in`` steps is dropped.
    """
    dev = resolve_device(device)
    if x0_draw is None:
        if generator is None:
            raise ValueError("coupled_henon needs a generator or x0_draw")
        x0_draw = torch.stack([
            torch.randn((d,), generator=generator, device=generator.device)
            for _ in range(2)])
    x0 = 0.1 * x0_draw.detach().to("cpu", torch.float32)
    xm2, xm1 = x0[0], x0[1]
    n = burn_in + t - 2
    traj = torch.empty((n + 2, d), dtype=torch.float32)
    traj[0], traj[1] = xm2, xm1
    for step in range(n):
        # node 0 uncoupled; nodes 1..d-1 couple to their left neighbour.
        parent = _fma(torch.tensor(e), torch.roll(xm1, 1), (1.0 - e) * xm1)
        parent[0] = xm1[0]
        x_new = _fma(torch.tensor(b), xm2,
                     _fma(-parent, parent, torch.tensor(a)))
        xm2, xm1 = xm1, x_new
        traj[step + 2] = x_new
    traj = traj[burn_in:]
    lo = traj.min(dim=0, keepdim=True).values
    hi = traj.max(dim=0, keepdim=True).values
    return ((traj - lo) / (hi - lo + 1e-7)).to(dev)


def coupled_henon_truth(d: int = 6, include_self: bool = False,
                        device=None) -> torch.Tensor:
    """GC[i, i-1] = 1 for i >= 1 (int32), the reference's evaluation
    truth; ``include_self`` adds the self-loops the dynamics contain."""
    dev = resolve_device(device)
    gc = torch.diag(torch.ones(d - 1, dtype=torch.int32, device=dev), -1)
    if include_self:
        gc = (gc + torch.eye(d, dtype=torch.int32, device=dev)).clamp(0, 1)
    return gc
