"""Lorenz-96 benchmark series (port of ``vae_connexe_tpu/data/lorenz96.py``).

``dx_i/dt = (x_{i+1} - x_{i-2}) x_{i-1} - x_i + F``, fixed-step RK4 on a
uniform ``delta_t`` grid from a N(0, 0.01^2) start, burn-in dropped,
N(0, sd^2) observation noise, then per-variable standardisation.  The
ground-truth Granger graph is circulant: row i has parents
{i, i-1, i-2, i+1}.
"""

from __future__ import annotations

from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.utils.scalers import standardize


def _rhs(x: torch.Tensor, forcing: float) -> torch.Tensor:
    # roll(-1) = x_{i+1}, roll(2) = x_{i-2}, roll(1) = x_{i-1}
    return ((torch.roll(x, -1, -1) - torch.roll(x, 2, -1))
            * torch.roll(x, 1, -1) - x + forcing)


def lorenz96(generator: Optional[torch.Generator] = None, p: int = 10,
             t: int = 2048, forcing: float = 10.0, delta_t: float = 0.1,
             sd: float = 0.1, burn_in: int = 1000,
             x0_draw: Optional[torch.Tensor] = None,
             noise_draw: Optional[torch.Tensor] = None,
             device=None) -> torch.Tensor:
    """A standardised (t, p) float32 Lorenz-96 trajectory on ``device``
    (default ``cuda``).

    The two standard-normal draws come from ``generator`` (x0 first, then
    the noise) or are passed in: ``x0_draw`` (p,), scaled by 0.01, and
    ``noise_draw`` (burn_in + t, p), scaled by ``sd``.
    """
    dev = resolve_device(device)
    if x0_draw is None or noise_draw is None:
        if generator is None:
            raise ValueError("lorenz96 needs a generator or both draws")
        gdev = generator.device
        x0_draw = torch.randn((p,), generator=generator, device=gdev)
        noise_draw = torch.randn((burn_in + t, p), generator=generator,
                                 device=gdev)
    x = 0.01 * x0_draw.to(dev, torch.float32)
    traj = torch.empty((burn_in + t, p), device=dev, dtype=torch.float32)
    for step in range(burn_in + t):
        k1 = _rhs(x, forcing)
        k2 = _rhs(x + 0.5 * delta_t * k1, forcing)
        k3 = _rhs(x + 0.5 * delta_t * k2, forcing)
        k4 = _rhs(x + delta_t * k3, forcing)
        x = x + (delta_t / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        traj[step] = x
    traj = traj + sd * noise_draw.to(dev, torch.float32)
    return standardize(traj[burn_in:], axis=0)


def lorenz96_truth(p: int, device=None) -> torch.Tensor:
    """Circulant ground-truth GC matrix (int32): row i has parents
    {i, i-1, i-2, i+1}."""
    dev = resolve_device(device)
    idx = torch.arange(p, device=dev)
    gc = torch.zeros((p, p), dtype=torch.int32, device=dev)
    for off in (0, -1, -2, 1):
        gc[idx, (idx + off) % p] = 1
    return gc
