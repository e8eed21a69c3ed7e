"""Minimal functional layer primitives (port of ``vae_connexe_tpu/utils/layers.py``).

Parameters are plain frozen dataclasses of tensors, torch ``nn.Linear``
layout.  Initialisation draws from a CPU ``torch.Generator`` and then moves
to ``device``, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine layer, torch ``nn.Linear`` layout: w (out, in), b (out,)."""

    w: torch.Tensor
    b: torch.Tensor


def uniform(generator: torch.Generator, shape, k: float,
            device: torch.device) -> torch.Tensor:
    """U(-k, k) float32, drawn on the CPU generator, placed on ``device``."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * k).to(device)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               device: torch.device, scale: float | None = None) -> Dense:
    """torch-default init: U(-k, k) with k = 1/sqrt(d_in) for both w and b."""
    k = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return Dense(w=uniform(generator, (d_out, d_in), k, device),
                 b=uniform(generator, (d_out,), k, device))


def init_stacked_dense(generator: torch.Generator, n: int, d_in: int,
                       d_out: int, device: torch.device) -> Dense:
    """n independent Dense layers stacked on a leading axis."""
    k = 1.0 / math.sqrt(d_in)
    return Dense(w=uniform(generator, (n, d_out, d_in), k, device),
                 b=uniform(generator, (n, d_out), k, device))


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w.T + p.b
