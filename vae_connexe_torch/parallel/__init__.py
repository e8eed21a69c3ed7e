"""Scale-out (port of ``vae_connexe_tpu/parallel``): meshes of ranks, one
process a device (``mesh``, ``multihost``, ``multiprocess``), the sharded
training steps (``sharded``), the sequence-parallel recurrence
(``seq_parallel``), sharded serving (``serve``) and the multi-seed sweep,
its seeds folded into the recurrence kernels' heads (``seed_sweep``)."""

from vae_connexe_torch.parallel.mesh import (
    batch_sharding,
    head_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from vae_connexe_torch.parallel.multihost import initialize_multihost
from vae_connexe_torch.parallel.seed_sweep import (
    SweepState,
    make_sweep_fn,
    make_sweep_step,
    seed_generators,
    sweep_phase1,
)
from vae_connexe_torch.parallel.seq_parallel import (
    seq_sharded_gru,
    seq_sharded_gru_heads,
)
from vae_connexe_torch.parallel.serve import make_sharded_generator

__all__ = [
    "batch_sharding",
    "head_sharding",
    "initialize_multihost",
    "make_mesh",
    "make_sharded_generator",
    "replicated",
    "seq_sharded_gru",
    "seq_sharded_gru_heads",
    "shard_batch",
    "make_sweep_fn",
    "sweep_phase1",
    "SweepState",
    "make_sweep_step",
    "seed_generators",
]
