"""Run a group of gloo CPU ranks for the port's mesh tests.

``run_ranks(cases, out, world)`` starts ``world`` OS processes, each
``python tests/torch_ranks.py <cases> <out> <world> <port> <rank>``: it
joins a gloo group on the CPU from a torchrun-style environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, read by
``parallel/multihost.py::initialize_multihost()``; one torch thread),
calls ``<cases>`` (``module:function`` of ``tests/``, a module
that imports no JAX) with the output directory, and leaves the group.  The
case function writes what the tests read (rank 0 by convention).  A rank
that fails prints its traceback and exits 1; the others are then stopped
at once, and ``run_ranks`` raises with every rank's log.  Every rank and
every collective has a timeout.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import socket
import subprocess
import sys
import time
import traceback

REPO = pathlib.Path(__file__).resolve().parents[1]
TESTS = pathlib.Path(__file__).resolve().parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cases: str, out, world: int, timeout: float = 120.0) -> list:
    """Start ``world`` ranks running ``cases`` on ``out``; returns their
    logs (in rank order), or raises with them if a rank failed or the group
    outlived ``timeout`` seconds."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO), str(TESTS), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "1"
    env.pop("JAX_PLATFORMS", None)
    port = _free_port()
    logs = [pathlib.Path(out) / f"rank{r}.log" for r in range(world)]
    files = [open(p, "w+") for p in logs]
    procs = [subprocess.Popen(
        [sys.executable, __file__, cases, str(out), str(world), str(port),
         str(r)], env=env, cwd=str(REPO), stdout=f,
        stderr=subprocess.STDOUT) for r, f in enumerate(files)]
    deadline = time.monotonic() + timeout
    failed = []
    while True:
        codes = [p.poll() for p in procs]
        failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if failed or all(c == 0 for c in codes):
            break
        if time.monotonic() > deadline:
            failed = [(r, "timeout") for r, c in enumerate(codes) if c is None]
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
    texts = []
    for f in files:
        f.seek(0)
        texts.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(f"ranks failed: {failed}\n" + "\n".join(
            f"--- rank {r} ---\n{t}" for r, t in enumerate(texts)))
    return texts


_WORLD_OF_ONE = []


def world_of_one():
    """A (1, 1) mesh over a world of one gloo CPU rank: this process
    (started once; later calls reuse the group)."""
    if not _WORLD_OF_ONE:
        from vae_connexe_torch.parallel.mesh import make_mesh

        _WORLD_OF_ONE.append(make_mesh(device="cpu", timeout=60))
    return _WORLD_OF_ONE[0]


def _main(argv) -> None:
    cases, out, world, port, rank = argv
    try:
        import torch

        torch.set_num_threads(1)
        from vae_connexe_torch.parallel.mesh import shutdown
        from vae_connexe_torch.parallel.multihost import initialize_multihost

        os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port,
                          WORLD_SIZE=world, RANK=rank, LOCAL_RANK=rank)
        assert initialize_multihost(device="cpu", timeout=60) == int(world)
        module, fn = cases.split(":")
        getattr(importlib.import_module(module), fn)(pathlib.Path(out))
        shutdown()
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    _main(sys.argv[1:])
