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
