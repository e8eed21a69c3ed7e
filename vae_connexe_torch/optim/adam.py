"""Adam, written out as ``optax.adam(lr)`` computes it.

The defaults and the order of operations are optax's (``scale_by_adam``
then ``scale_by_learning_rate``): b1=0.9, b2=0.999, eps=1e-8, eps_root=0,

    m <- (1 - b1) g + b1 m
    v <- (1 - b2) g^2 + b2 v
    count <- count + 1
    p <- p - lr * (m / (1 - b1^count)) / (sqrt(v / (1 - b2^count) + eps_root) + eps)

with the bias corrections computed in float32 from an int32 count, as
optax does.  The state mirrors optax's ``ScaleByAdamState`` (count, mu, nu),
so it goes into a checkpoint and converts from the JAX package's.
``torch.optim.Adam`` is not used: its state lives outside the parameter
tree and it divides in another order.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from vae_connexe_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamState:
    count: torch.Tensor    # 0-d int32
    mu: Any                # first moments, a tree shaped like the params
    nu: Any                # second moments


def adam_init(params) -> AdamState:
    """Zero moments shaped like ``params`` and a zero count, on the params'
    device."""
    dev = tree_leaves(params)[0].device
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params))


def adam_update(grads, state: AdamState, params, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0):
    """One Adam step; ``grads`` is a tree shaped like ``params``.  Returns
    (new params, new state)."""
    mu, nu = [], []
    for gi, m, v in zip(tree_leaves(grads), tree_leaves(state.mu),
                        tree_leaves(state.nu)):
        mu.append((1 - b1) * gi + b1 * m)
        nu.append((1 - b2) * (gi * gi) + b2 * v)
    new = AdamState(count=state.count + 1, mu=tree_unflatten(params, mu),
                    nu=tree_unflatten(params, nu))
    return adam_apply(params, new, lr, b1, b2, eps, eps_root), new


def adam_apply(params, state: AdamState, lr: float, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
    """``params`` moved by Adam's step from ``state``, whose moments and
    count already hold this step's gradient (``adam_update``'s second
    half)."""
    c = state.count.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, c), 1 - torch.pow(b2, c)
    new = [p + (-lr) * ((m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps))
           for p, m, v in zip(tree_leaves(params), tree_leaves(state.mu),
                              tree_leaves(state.nu))]
    return tree_unflatten(params, new)
