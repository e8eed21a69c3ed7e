"""The rule from one integer seed to a run's generators."""

from __future__ import annotations

import torch


def role_generators(seed: int, roles, cpu_roles=(), device="cpu",
                    offset: int = 0) -> dict[str, torch.Generator]:
    """{role: generator}, one a role of ``roles`` in that order.

    A CPU generator seeded with ``seed`` draws one 62-bit seed per role;
    each role's generator is seeded with its draw plus ``offset`` (the
    counterpart of the reference's ``fold_in``), on the CPU for the roles
    in ``cpu_roles`` and on ``device`` for the others.
    """
    master = torch.Generator().manual_seed(int(seed))
    draws = torch.randint(0, 2 ** 62, (len(roles),), generator=master)
    return {role: torch.Generator(
                device="cpu" if role in cpu_roles else device
            ).manual_seed(s + offset)
            for role, s in zip(roles, draws.tolist())}


def seed_stack_generators(seed: int, indices, roles, cpu_roles=(),
                          device="cpu"):
    """(init generators, run generators), one a seed index of
    ``indices``, for the inits of a multi-seed fit (the win family's
    stability seeds).

    ``roles`` holds an ``"init"`` and a ``"run"`` role.  Index 0 is the
    run's own pair (offset 0); index s >= 1 takes the ``init`` role at
    offset s and the ``run`` role at offset 100 + s, the
    counterpart of the reference's ``fold_in(k_init, s)`` and
    ``fold_in(k_run, 100 + s)``.  ``run_experiment`` and ``discover``
    both draw their seeds by this rule.
    """
    inits, runs = [], []
    for s in indices:
        inits.append(
            role_generators(seed, roles, cpu_roles, device, s)["init"])
        runs.append(role_generators(seed, roles, cpu_roles, device,
                                    100 + s if s else 0)["run"])
    return inits, runs
