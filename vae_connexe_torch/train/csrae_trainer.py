"""MixtureCSRAE training (port of ``vae_connexe_tpu/train/csrae_trainer.py``):
Adam minibatches minimising BCE + lambda_cs * CS over shuffled batches,
the encoder, the decoder and the GMM prior trained together.

An epoch draws from the fit's generator one permutation of the rows (the
remainder dropped) and then one epsilon for every batch, (n_batches, B,
latent), and runs ``make_csrae_step`` over the batches in order.  The
host reads the epoch's mean metrics once an epoch.
"""

from __future__ import annotations

import torch

from vae_connexe_torch.models.csrae import MixtureCSRAE, MixtureCSRAEParams
from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.utils import debug
from vae_connexe_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


def make_csrae_step(model: MixtureCSRAE, lr: float):
    """``step(params, opt_state, batch, eps)`` -> (params, opt_state,
    {total, bce, cs} as 0-d tensors): the loss and its gradient over every
    leaf, the prior's included, then one Adam step at ``lr``."""

    def step(params: MixtureCSRAEParams, opt_state: AdamState,
             batch: torch.Tensor, eps: torch.Tensor):
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            total, bce, cs = model.loss(live, batch, eps)
            debug.check_finite("the loss", total)
            grads = torch.autograd.grad(total, tree_leaves(live))
        with torch.no_grad():
            params, opt_state = adam_update(tree_unflatten(params, grads),
                                            opt_state, params, lr)
        return params, opt_state, {"total": total.detach(),
                                   "bce": bce.detach(), "cs": cs.detach()}

    return step


def fit_csrae(model: MixtureCSRAE, params: MixtureCSRAEParams,
              data: torch.Tensor, generator: torch.Generator,
              epochs: int = 10, batch_size: int = 128, lr: float = 1e-3,
              verbose: bool = False, log_fn=print):
    """Train on (N, input_dim) data on its device.  Returns (params, the
    last epoch's mean metrics as floats)."""
    step = make_csrae_step(model, lr)
    opt_state = adam_init(params)
    n_batches = data.shape[0] // batch_size
    g = generator
    metrics = {}
    for epoch in range(epochs):
        perm = torch.randperm(data.shape[0], generator=g, device=g.device)
        batches = data[perm[:n_batches * batch_size].to(data.device)].reshape(
            n_batches, batch_size, data.shape[-1])
        eps = torch.randn((n_batches, batch_size, model.latent_dim),
                          generator=g, device=g.device).to(data.device)
        sums = None
        for i in range(n_batches):
            with debug.at_step(f"csrae epoch {epoch} batch {i}"):
                params, opt_state, m = step(params, opt_state, batches[i],
                                            eps[i])
                debug.check_finite("the metrics and updated parameters", m,
                                   params)
            sums = m if sums is None else {k: sums[k] + v
                                           for k, v in m.items()}
        means = (torch.stack(list(sums.values())) / n_batches).tolist()
        metrics = dict(zip(sums, means))
        if verbose:
            log_fn(f"[csrae epoch={epoch}] " +
                   " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
    return params, metrics
