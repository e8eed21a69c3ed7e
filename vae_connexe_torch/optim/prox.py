"""Proximal sparsity steps (port of ``vae_connexe_tpu/optim/prox.py``):
the GISTA/ISTA shrinks that make the Granger graph, as pure functions over
weight tensors, and ``proximal_sgd``, SGD fused with a prox.

- ``prox_column_groups``: one group per column of a (3H, D_in) input-weight
  matrix (the author variant):
  W <- W / max(||W||_col, lam*lr) * max(||W||_col - lam*lr, 0).
- ``prox_row_groups``: one group per row of a (D, H) W_in matrix:
  W <- W * max(1 - lam*lr / ||W||_row, 0).
- ``prox_elementwise``: plain L1 soft threshold:
  W <- sign(W) * max(|W| - lam*lr, 0).

Each broadcasts over any leading head and seed axes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from vae_connexe_torch.utils.tree import tree_leaves, tree_map


def prox_column_groups(w: torch.Tensor, lam: float, lr: float) -> torch.Tensor:
    """Group soft-threshold over columns (reduce the second-to-last axis)."""
    norm = torch.linalg.vector_norm(w, dim=-2, keepdim=True)
    # The 1e-30 floor guards lam*lr == 0 (phase 2 runs with lam = 0, where
    # the prox must be the identity, not 0/0).
    denom = torch.clamp(norm, min=max(lam * lr, 1e-30))
    return w * (torch.clamp(norm - lam * lr, min=0.0) / denom)


def prox_row_groups(w: torch.Tensor, lam: float, lr: float) -> torch.Tensor:
    """Group soft-threshold over rows (reduce the last axis)."""
    norm = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    shrink = torch.clamp(1.0 - lam * lr / torch.clamp(norm, min=1e-30),
                         min=0.0)
    return w * shrink


def prox_elementwise(w: torch.Tensor, lam: float, lr: float) -> torch.Tensor:
    """L1 soft threshold per element."""
    return torch.sign(w) * torch.clamp(w.abs() - lam * lr, min=0.0)


PROX_FNS: dict[str, Callable[[torch.Tensor, float, float], torch.Tensor]] = {
    "column": prox_column_groups,
    "row": prox_row_groups,
    "element": prox_elementwise,
}


@dataclasses.dataclass(frozen=True)
class ProximalSGDState:
    count: torch.Tensor    # 0-d int32


@dataclasses.dataclass(frozen=True)
class ProximalSGD:
    """``init(params)`` and ``update(grads, state, params)``, the two
    functions of JAX's optax transform."""

    init: Callable[[Any], ProximalSGDState]
    update: Callable[..., tuple]


def proximal_sgd(lr: float, lam: float, groups: str = "column",
                 prox_mask: Optional[Any] = None) -> ProximalSGD:
    """SGD fused with a proximal step: p <- prox_{lam*lr}(p - lr*g).

    ``update(grads, state, params)`` returns (updates, new state): the
    update of a leaf selected by ``prox_mask`` (a tree of bools shaped
    like the params; None selects every leaf) is ``prox(p - lr*g) - p``,
    of the others ``-lr*g``; add the updates to the params to apply them.
    The prox sees the post-gradient weights, as the reference orders it.
    """
    prox = PROX_FNS[groups]

    def init(params) -> ProximalSGDState:
        dev = tree_leaves(params)[0].device
        return ProximalSGDState(count=torch.zeros((), dtype=torch.int32,
                                                  device=dev))

    def update(grads, state: ProximalSGDState, params=None):
        if params is None:
            raise ValueError("proximal_sgd requires params")

        def leaf(g, p, do_prox):
            stepped = p - lr * g
            if do_prox:
                stepped = prox(stepped, lam, lr)
            return stepped - p

        if prox_mask is None:
            new = tree_map(lambda g, p: leaf(g, p, True), grads, params)
        else:
            new = tree_map(leaf, grads, params, prox_mask)
        return new, ProximalSGDState(count=state.count + 1)

    return ProximalSGD(init=init, update=update)
