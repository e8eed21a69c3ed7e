"""Minimal functional layer primitives (port of ``vae_connexe_tpu/utils/layers.py``).

Parameters are plain frozen dataclasses of tensors, torch ``nn.Linear``
layout.  Initialisation draws float32 from a CPU ``torch.Generator`` and
then casts to ``dtype`` on ``device``, so a seed gives the same weights on
every device.  The initialisers take JAX's parameters in JAX's order
(``generator`` in the place of ``key``), with ``device`` after them.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vae_connexe_torch._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Dense:
    """Affine layer, torch ``nn.Linear`` layout: w (out, in), b (out,)."""

    w: torch.Tensor
    b: torch.Tensor


def uniform(generator: torch.Generator, shape, k: float, device=None,
            dtype=torch.float32) -> torch.Tensor:
    """U(-k, k) drawn in float32 on the CPU generator, cast to ``dtype`` on
    ``device`` (default ``cuda``)."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32)
    return ((2.0 * u - 1.0) * k).to(device=resolve_device(device),
                                    dtype=dtype)


def init_dense(generator: torch.Generator, d_in: int, d_out: int,
               dtype=torch.float32, scale: float | None = None,
               device=None) -> Dense:
    """torch-default init: U(-k, k) with k = 1/sqrt(d_in) for both w and b."""
    k = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return Dense(w=uniform(generator, (d_out, d_in), k, device, dtype),
                 b=uniform(generator, (d_out,), k, device, dtype))


def init_stacked_dense(generator: torch.Generator, n: int, d_in: int,
                       d_out: int, dtype=torch.float32, device=None) -> Dense:
    """n independent Dense layers stacked on a leading axis."""
    k = 1.0 / math.sqrt(d_in)
    return Dense(w=uniform(generator, (n, d_out, d_in), k, device, dtype),
                 b=uniform(generator, (n, d_out), k, device, dtype))


def dense(p: Dense, x: torch.Tensor) -> torch.Tensor:
    return x @ p.w.T + p.b


def dense_stacked(p: Dense, x: torch.Tensor) -> torch.Tensor:
    """S affine layers stacked on a leading (seed) axis: w (S, O, I), b (S,
    O), x (S, B, I) -> (S, B, O)."""
    return torch.matmul(x, p.w.transpose(-1, -2)) + p.b[:, None, :]
