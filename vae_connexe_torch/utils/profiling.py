"""Profiling and step timing (port of ``vae_connexe_tpu/utils/profiling.py``):
a ``StepTimer`` for steady-state steps/s, and ``trace``, a
``torch.profiler`` capture of a block written as a Chrome/Perfetto trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the enclosed block (host, and the card's kernels where there
    is one) and write ``log_dir/trace.json``, which chrome://tracing and
    Perfetto open."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock steps/s with the first ``warmup`` ticks left out.

    Usage:
        timer = StepTimer(warmup=2)
        for _ in range(n):
            state = step(state)
            torch.cuda.synchronize()   # the caller chooses the sync points
            timer.tick(steps=chunk_len)
        print(timer.steps_per_sec())
    """

    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._ticks = 0
        self._steps = 0
        self._t0: float | None = None

    def tick(self, steps: int = 1) -> None:
        self._ticks += 1
        if self._ticks == self.warmup:
            self._t0 = time.perf_counter()
        elif self._ticks > self.warmup:
            self._steps += steps

    def steps_per_sec(self) -> float:
        if self._t0 is None or self._steps == 0:
            return float("nan")
        return self._steps / (time.perf_counter() - self._t0)
