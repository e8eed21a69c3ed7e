"""Scale-out (port of ``vae_connexe_tpu/parallel``): the multi-seed sweep,
its seeds folded into the recurrence kernels' heads.  Meshes, sharding and
multi-process runs are not ported yet (ROADMAP A7)."""

from vae_connexe_torch.parallel.seed_sweep import (
    SweepState,
    make_sweep_fn,
    make_sweep_step,
    seed_generators,
    sweep_phase1,
)

__all__ = ["SweepState", "make_sweep_fn", "make_sweep_step",
           "seed_generators", "sweep_phase1"]
