"""VRAE training (port of ``vae_connexe_tpu/train/vrae_trainer.py``):
full-batch Adam with a per-epoch teacher-forcing schedule and the beta-VAE
loss.

The schedule is host-side, a float an epoch.  Each epoch draws from the
fit's generator epsilon (N, latent), then the decoder's coins (T,), the
order of ``VRAE.forward``, and takes one ``make_vrae_step``.  The host
reads the metrics once, after the last epoch, and at the logged epochs.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vae_connexe_torch.models.vrae import VRAE, VRAEParams
from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.utils import debug
from vae_connexe_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def make_vrae_step(model: VRAE, data: torch.Tensor, lr: float,
                   beta: float):
    """``step(params, opt_state, tf_ratio, eps, coins)`` -> (params,
    opt_state, {total, rec, kld} as 0-d tensors): the forward over the
    whole of ``data`` on the given draws, the loss and its gradient, one
    Adam step at ``lr``."""

    def step(params: VRAEParams, opt_state: AdamState, tf_ratio: float,
             eps: torch.Tensor, coins: torch.Tensor):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            recon, mu, logvar = model.forward(live, data, None, tf_ratio,
                                              eps=eps, coins=coins)
            total, rec, kld = model.loss(recon, data, mu, logvar, beta)
            debug.check_finite("the loss", total)
            # With a teacher-forcing ratio above 0 the start token is not
            # read: its gradient is zeros, as JAX's.
            grads = torch.autograd.grad(total, tree_leaves(live),
                                        materialize_grads=True)
        with torch.no_grad():
            params, opt_state = adam_update(tree_unflatten(params, grads),
                                            opt_state, params, lr)
        return params, opt_state, {"total": total.detach(),
                                   "rec": rec.detach(), "kld": kld.detach()}

    return step


def fit_vrae(model: VRAE, params: VRAEParams, data: torch.Tensor,
             generator: torch.Generator, epochs: int = 10, lr: float = 1e-3,
             beta: float = 1.0,
             teacher_forcing_schedule: Optional[Callable[[int], float]] = None,
             verbose: bool = False, log_fn=print):
    """Train on an (N, T, D) tensor, the full batch an epoch.  Returns
    (params, the last epoch's metrics as floats, with its ``tf_ratio``)."""
    step = make_vrae_step(model, data, lr, beta)
    opt_state = adam_init(params)
    g = generator
    last, tf_ratio = {}, 1.0
    for epoch in range(epochs):
        tf_ratio = (teacher_forcing_schedule(epoch)
                    if teacher_forcing_schedule else 1.0)
        eps = torch.randn((data.shape[0], model.latent), generator=g,
                          device=g.device)
        coins = torch.rand((data.shape[1],), generator=g, device=g.device)
        with debug.at_step(f"vrae epoch {epoch}"):
            params, opt_state, last = step(params, opt_state, tf_ratio,
                                           eps.to(data.device),
                                           coins.to(data.device))
            debug.check_finite("the metrics and updated parameters", last,
                               params)
        if verbose and epoch % 10 == 0:
            log_fn(f"[vrae epoch={epoch}] " + " ".join(
                f"{k}={v:.4f}" for k, v in _floats(last, tf_ratio).items()))
    return params, _floats(last, tf_ratio) if last else {}


def _floats(metrics: dict, tf_ratio: float) -> dict:
    return {**{k: float(v) for k, v in metrics.items()}, "tf_ratio": tf_ratio}
