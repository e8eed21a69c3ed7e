"""Mesh-sharded serving: compensated generation with the batch split over
every rank (port of ``vae_connexe_tpu/parallel/serve.py``).

Each rank rolls its slice of independent samples through the rollout
kernels (K2, the ErrorVAE's free run, then K1, the CRVAE's: B5 and B4 on
the card, their plain versions on the CPU), in float32 or bf16, with the
parameters replicated; the slices are gathered so that every rank returns
the whole batch.

The draws: JAX's counter-based key gives the same noise however the
result is sharded.  Torch's generators do not, so every rank draws the
whole batch's h0s from its generator (seeded the same on every rank), in
``generate_with_compensation``'s order, and keeps its slice: the meshed
generator equals the single-process call on the same generator, each
sample computed by the same kernel on the same inputs.
"""

from __future__ import annotations

from vae_connexe_torch.parallel.mesh import Sharding, check_mesh, mesh_size
from vae_connexe_torch.train.crvae_trainer import (
    _generation_draws,
    _serving_groups,
    generate_from_draws,
)


def make_sharded_generator(model, err_model, mesh, batch: int, *,
                           parents=None, dtype=None):
    """Build ``fn(params, err_params, generator) -> (batch, rollout_len,
    p)`` with the sample batch split over every rank of ``mesh`` and the
    parameters replicated (every rank passes the whole params and an
    identically seeded generator; every rank gets the whole batch).

    ``dtype``: optional serving precision (``torch.bfloat16`` or
    ``"bfloat16"``: the kernels' bf16 instantiations); float32 out either
    way.  Raises if ``batch`` does not divide evenly over the mesh.
    """
    check_mesh(mesh)
    n = mesh_size(mesh)
    if batch % n:
        raise ValueError(
            f"serving batch {batch} not divisible by the {n}-device mesh; "
            f"pad the batch to a multiple of {n} (each device rolls "
            f"batch/{n} independent samples)")
    shard = Sharding(mesh, "all")

    def gen(params, err_params, generator):
        groups = _serving_groups(params, err_params, parents, dtype)
        h0_err, h0 = _generation_draws(model, err_model, generator, batch)
        out = generate_from_draws(model, err_model, *groups,
                                  shard.local(h0_err), shard.local(h0))
        return shard.gather(out)

    return gen
