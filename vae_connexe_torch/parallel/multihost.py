"""Multi-host start (port of ``vae_connexe_tpu/parallel/multihost.py``).

JAX's ``jax.distributed.initialize`` joins the hosts and every device of
every host joins one program.  The port runs one process per device, so
joining a run is ``init_process_group`` over TCP for this process's rank
(``parallel/mesh.py::init_world``: the backend rule, the card binding and
the timeout).  With no arguments the rank comes from ``torchrun``'s
environment (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), as JAX auto-detects a pod's.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from vae_connexe_torch.parallel.mesh import init_world


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None, device=None, *,
                         local_rank: Optional[int] = None,
                         local_world: Optional[int] = None,
                         timeout: Optional[float] = None) -> int:
    """Join a multi-process run as rank ``process_id`` of
    ``num_processes``, the group's store at ``coordinator_address``
    (``host:port``).  Without arguments, ``torchrun``'s environment gives
    all three.  ``device`` (default ``cuda``: card ``local_rank`` of the
    host; ``"cpu"`` names the CPU).  Returns the world's device count, one
    device a rank."""
    env = os.environ
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if "MASTER_ADDR" not in env or "WORLD_SIZE" not in env:
            raise RuntimeError(
                "initialize_multihost() without arguments reads torchrun's "
                "environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); "
                "none is set: pass coordinator_address, num_processes and "
                "process_id")
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("pass coordinator_address, num_processes and "
                             "process_id together, or none of them")
        init_method = f"tcp://{coordinator_address}"
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", 0))
    if local_world is None and "LOCAL_WORLD_SIZE" in env:
        local_world = int(env["LOCAL_WORLD_SIZE"])
    init_world(device, init_method=init_method, world_size=num_processes,
               rank=process_id, local_rank=local_rank,
               local_world=local_world, timeout=timeout)
    return dist.get_world_size()
