"""Sliding-window batching (port of ``vae_connexe_tpu/data/windows.py``)."""

from __future__ import annotations

import torch


def arrange_input(series: torch.Tensor, context: int):
    """Overlapping windows with one-step-shifted targets.

    series (T, p) -> (inputs (T - context, context, p),
    targets (T - context, context, p)) with ``inputs[n, i] = series[n + i]``
    and ``targets[n, i] = series[n + i + 1]``.
    """
    n = series.shape[0] - context
    starts = (torch.arange(n, device=series.device)[:, None]
              + torch.arange(context, device=series.device)[None, :])
    return series[starts], series[starts + 1]


def sliding_windows(series: torch.Tensor, seq_len: int) -> torch.Tensor:
    """All length-``seq_len`` windows (stride 1): (T, p) ->
    (T - seq_len + 1, seq_len, p)."""
    return series.unfold(0, seq_len, 1).transpose(1, 2)


def sample_batch(generator: torch.Generator, windows: torch.Tensor,
                 batch_size: int, idx: torch.Tensor | None = None):
    """Uniform with-replacement minibatch; ``idx`` (batch_size,) replaces the
    draw from ``generator``."""
    if idx is None:
        idx = torch.randint(0, windows.shape[0], (batch_size,),
                            generator=generator, device=generator.device)
    return windows[idx.to(windows.device)]
