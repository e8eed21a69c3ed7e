"""The port's kernels as ``torch.library`` custom ops, for exported programs.

    vae_connexe::crvae_free_run   K1 (B4), the CRVAE free run
    vae_connexe::errvae_sample    K2 (B5), the ErrorVAE free run
    vae_connexe::gru_forward      B1, the stacked-head GRU forward

Each op calls the wrapper in ``ops/cuda_rollout.py`` or ``ops/cuda_gru.py``,
so its routes, its checks and its launch counts are the wrapper's: on a
CUDA tensor the ctypes launch on the current stream (counted in the
wrapper's ``LAUNCHES``), on a CPU tensor the plain version.  A fake
implementation gives each op's output shape, so ``torch.export`` traces a
program that calls them (``serving.py``'s artifacts) without running a
kernel; a process that loads such a program imports this module, and no
model or trainer code, to run it.  In-process generation calls the
wrappers directly and does not go through the dispatcher.

Both rollout ops take their weights in float32 or all in bfloat16 (the
kernels' bf16 instantiations) and return float32.
"""

from __future__ import annotations

import torch

from vae_connexe_torch.ops import cuda_gru, cuda_rollout
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.utils.layers import Dense

Tensor = torch.Tensor


@torch.library.custom_op("vae_connexe::crvae_free_run", mutates_args=())
def crvae_free_run(w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
                   ro_w: Tensor, ro_b: Tensor, x0: Tensor, h0: Tensor,
                   noise: Tensor, noise_scale: float) -> Tensor:
    """K1: ``cuda_rollout.crvae_free_run_fused`` on the stacked heads
    (p, 3H, p), readout (p, 1, H), x0 (B, p), h0 (B, H) and noise (B, T,
    p).  Returns (B, T, p) float32."""
    return cuda_rollout.crvae_free_run_fused(
        GRUParams(w_ih, w_hh, b_ih, b_hh), Dense(ro_w, ro_b), x0, h0, noise,
        noise_scale)


@crvae_free_run.register_fake
def _(w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, x0, h0, noise, noise_scale):
    return noise.new_empty(noise.shape, dtype=torch.float32)


@torch.library.custom_op("vae_connexe::errvae_sample", mutates_args=())
def errvae_sample(w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
                  ro_w: Tensor, ro_b: Tensor, h0: Tensor, d: int,
                  steps: int) -> Tensor:
    """K2: ``cuda_rollout.errvae_sample_fused`` on the decoder (3H, d),
    readout (d, H) and h0 (B, H), ``steps`` steps from x0 = 0.  Returns
    (B, steps, d) float32."""
    return cuda_rollout.errvae_sample_fused(
        GRUParams(w_ih, w_hh, b_ih, b_hh), Dense(ro_w, ro_b), h0, d, steps)


@errvae_sample.register_fake
def _(w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, h0, d, steps):
    return h0.new_empty((h0.shape[0], steps, d), dtype=torch.float32)


@torch.library.custom_op("vae_connexe::gru_forward", mutates_args=())
def gru_forward(w_ih: Tensor, w_hh: Tensor, b_ih: Tensor, b_hh: Tensor,
                x: Tensor, h0: Tensor) -> Tensor:
    """B1: ``cuda_gru.fused_gru_scan_heads`` of P stacked GRUs (P, 3H, D)
    over x (B, T, D) shared or (P, B, T, D) per head from h0 (P, B, H).
    Returns every step's state, (P, B, T, H)."""
    outs, _ = cuda_gru.fused_gru_scan_heads(
        GRUParams(w_ih, w_hh, b_ih, b_hh), x, h0)
    return outs


@gru_forward.register_fake
def _(w_ih, w_hh, b_ih, b_hh, x, h0):
    return x.new_empty((w_ih.shape[0], x.shape[-3], x.shape[-2],
                        w_hh.shape[-1]))
