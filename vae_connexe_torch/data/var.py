"""Linear VAR(1) benchmark with a known sparse transition matrix (port of
``vae_connexe_tpu/data/var.py``): x_t = A x_{t-1} + 0.1 ε, A with
self-loops of 0.6 and three cross edges (0←1: 0.5, 1←2: 0.3, 2←0: 0.4);
many independent short sequences."""

from __future__ import annotations

from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device


def var_truth(d: int = 5, device=None) -> torch.Tensor:
    """The reference's sparse transition matrix (float32 weights)."""
    a = torch.zeros((d, d), dtype=torch.float32, device=resolve_device(device))
    a.fill_diagonal_(0.6)
    a[0, 1], a[1, 2], a[2, 0] = 0.5, 0.3, 0.4
    return a


def var_process(generator: Optional[torch.Generator], a: torch.Tensor,
                n: int = 500, t: int = 30, noise_scale: float = 0.1,
                x0_draw: Optional[torch.Tensor] = None,
                noise_draw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """n independent VAR(1) sequences of length t on ``a``'s device.
    Returns (n, t, d).

    The two standard-normal draws come from ``generator`` in JAX's order
    and shapes (x0 (n, d), then the noise (t - 1, n, d)), or are passed in
    as ``x0_draw`` and ``noise_draw``; x0 is scaled by 0.1, the noise by
    ``noise_scale``.
    """
    d, dev = a.shape[0], a.device
    if x0_draw is None or noise_draw is None:
        if generator is None:
            raise ValueError("var_process needs a generator or both draws")
        gdev = generator.device
        x0_draw = torch.randn((n, d), generator=generator, device=gdev)
        noise_draw = torch.randn((t - 1, n, d), generator=generator,
                                 device=gdev)
    x = 0.1 * x0_draw.to(dev, torch.float32)
    noise = noise_scale * noise_draw.to(dev, torch.float32)
    steps = [x]
    for eps_t in noise:
        x = x @ a.T + eps_t
        steps.append(x)
    return torch.stack(steps, dim=1)
