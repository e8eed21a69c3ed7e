"""Parameters to and from nested dicts of numpy arrays.

The dicts are keyed by the JAX package's field names (``enc``, ``fc_mu``,
``fc_std``, ``heads``, ``readout``; ``z2h``, ``dec``, ``out``; the W_in
family's ``fc_logsig``, ``w_in`` and ``err``; ``w_ih``, ``w_hh``,
``b_ih``, ``b_hh``; ``w``, ``b``), which is what
``flax.serialization.to_state_dict`` gives for the reference's parameter
pytrees, and every leaf keeps the reference's layout (torch's).  So weights
trained by the reference load into the port, and back.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from vae_connexe_torch._device import resolve_device


def to_numpy(params) -> dict:
    """A parameter dataclass -> nested dict of float32 numpy arrays."""
    return {f.name: (to_numpy(v) if dataclasses.is_dataclass(v)
                     else v.detach().cpu().numpy())
            for f in dataclasses.fields(params)
            for v in [getattr(params, f.name)]}


def from_numpy(cls, tree: dict, device=None):
    """Nested dict of arrays -> parameter dataclass ``cls`` on ``device``
    (default ``cuda``).  Missing or extra keys raise."""
    dev = resolve_device(device)
    hints = typing.get_type_hints(cls)
    names = [f.name for f in dataclasses.fields(cls)]
    if set(tree) != set(names):
        raise KeyError(f"{cls.__name__} expects keys {sorted(names)}, got "
                       f"{sorted(tree)}")
    kwargs = {}
    for name in names:
        kind = hints[name]
        if dataclasses.is_dataclass(kind):
            kwargs[name] = from_numpy(kind, tree[name], dev)
        else:
            kwargs[name] = torch.tensor(np.asarray(tree[name], np.float32),
                                        device=dev)
    return cls(**kwargs)


def phase2_state_from_numpy(crvae_tree: dict, err_tree: dict, opt_tree: dict,
                            device=None) -> dict:
    """The JAX package's phase-2 state pieces, as nested dicts of arrays,
    -> the port's ``Phase2State`` fields on ``device``.

    ``crvae_tree`` and ``err_tree``: ``to_state_dict`` of the CRVAE and
    ErrorVAE params; ``opt_tree``: ``to_state_dict`` of ``optax.adam``'s
    state, the chain ``(ScaleByAdamState, EmptyState)`` as ``{'0':
    {'count', 'mu', 'nu'}, '1': {}}``.  Returns ``{"params",
    "err_params", "err_opt"}``, to which the caller adds the best params
    and loss, a generator and the step.
    """
    from vae_connexe_torch.models.crvae import CRVAEParams
    from vae_connexe_torch.models.error_vae import ErrorVAEParams
    from vae_connexe_torch.optim.adam import AdamState

    dev = resolve_device(device)
    adam = opt_tree["0"]
    count = torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32,
                         device=dev)
    return {"params": from_numpy(CRVAEParams, crvae_tree, dev),
            "err_params": from_numpy(ErrorVAEParams, err_tree, dev),
            "err_opt": AdamState(
                count=count, mu=from_numpy(ErrorVAEParams, adam["mu"], dev),
                nu=from_numpy(ErrorVAEParams, adam["nu"], dev))}


def win_state_from_numpy(params_tree: dict, opt_tree: dict,
                         device=None) -> dict:
    """The JAX package's ``WInTrainState`` pieces, as nested dicts of
    arrays, -> the port's ``WInTrainState`` fields on ``device``.

    ``params_tree``: ``to_state_dict`` of the ``WInCRVAEParams`` (the error
    VAE's ``err`` included); ``opt_tree``: ``to_state_dict`` of the
    trainer's ``optax.multi_transform`` state, whose ``adam`` partition
    holds ``(ScaleByAdamState, EmptyState)`` with an empty ``w_in`` (no
    moments).  Returns ``{"params", "opt_state"}``, to which the caller
    adds a generator and the step.
    """
    from vae_connexe_torch.models.crvae_win import WInCRVAEParams
    from vae_connexe_torch.optim.adam import AdamState
    from vae_connexe_torch.train.win_trainer import AdamLeaves

    dev = resolve_device(device)
    adam = opt_tree["inner_states"]["adam"]["inner_state"]["0"]

    def moments(tree):
        return from_numpy(AdamLeaves, {k: v for k, v in tree.items()
                                       if k != "w_in"}, dev)

    count = torch.tensor(int(np.asarray(adam["count"])), dtype=torch.int32,
                         device=dev)
    return {"params": from_numpy(WInCRVAEParams, params_tree, dev),
            "opt_state": AdamState(count=count, mu=moments(adam["mu"]),
                                   nu=moments(adam["nu"]))}
