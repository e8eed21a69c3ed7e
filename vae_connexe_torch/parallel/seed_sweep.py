"""Multi-seed phase-1 sweeps (port of ``vae_connexe_tpu/parallel/seed_sweep.py``).

The JAX package trains S seeds as one program, a ``jax.vmap`` over the
phase-1 step.  A kernel launched through ctypes cannot be vmapped, but the
recurrence kernels already stack heads, each with its own weights and its
own input: so the seed axis folds into the head axis.  The encoder runs as
S heads and the decoder as S * p heads, and a sweep step makes the same
two B1 and two B2 launches as one phase-1 step, whatever S is (on a CPU
tensor, their plain versions).  The fc layers and the readouts are batched
products over S.

Every parameter leaf carries a leading seed axis.  ``seed_generators`` is
the one rule from a seed to its generators: a sweep's seed s starts from
the init and trains on the draws that ``discover(seed=s)`` uses with one
seed.  Each step, each seed draws from its own run generator its batch
indices, then its epsilon (B, H), the order of ``make_phase1_step``; with
``cfg.resample_batches`` false every seed trains on the one batch that
``make_phase1_step`` would fix.  The update is phase 1's own
(``train/crvae_trainer.py::_phase1_update``) with ``sweep_forward`` as
its forward: one backward of the sum of the S losses gives each seed its
own gradient (the parameters are disjoint); SGD, the mask projection, the
prox and the best pick act on every seed at once.  The step loop reads
nothing back to the host: results are read once, after the last step.

The kernels sum in another order at S * p heads than at p, so a sweep's
seed agrees with its single fit to rounding, not bitwise; two sweeps of
the same seeds are bitwise equal.

With ``cfg.latent_reg='cs'`` a sweep trains with no prior, on beta *
KL, as the JAX package's does: its ``sweep_phase1`` starts every seed
from ``Phase1State(prior=None, ...)``
(``vae_connexe_tpu/parallel/seed_sweep.py:37``) and its step takes the
KL branch whenever the prior is None.  Only the single fits
(``fit_phase1``, ``fit_phase2``) train against the GMM prior.

On a mesh (``mesh=``, ``parallel/mesh.py``) the seed axis is split over
dp, as the JAX package's sweep shards it: a seed count that dp does not
divide is padded with the last seed, each rank trains its slice of the
seeds (still one B1 and one B2 launch a step, whatever its share) and the
results are gathered over dp and cut back to the seeds asked for.  Seed s
trains from the same generators on every layout, so it is the same model
(to rounding) however the seeds are split.

Not ported: the JAX package's TPU-only ``batched_dispatch`` hint (the
port's dispatch goes by device and shape).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams, masked_heads
from vae_connexe_torch.ops.dispatch import heads_recurrence
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.train.config import Phase1Config, check_latent_reg
from vae_connexe_torch.train.crvae_trainer import (
    _phase1_update,
    _track_best,
    default_fixed_batch,
)
from vae_connexe_torch.utils.layers import dense_stacked
from vae_connexe_torch.utils.seeding import role_generators
from vae_connexe_torch.utils.tree import stack_trees

# The generators of one seed, in this order (the counterpart of the
# reference's ``key(seed) -> k_init, k_run`` and ``fold_in(key, 1) -> k_p2,
# k_e, k_gen``).  The init roles are CPU generators (``CRVAE.init`` draws
# on the CPU), the others lie on the device.
SEED_ROLES = ("init", "run", "p2_init", "err_init", "p2_run", "gen")
_CPU_ROLES = ("init", "p2_init", "err_init")


def seed_generators(seed: int, device=None) -> dict[str, torch.Generator]:
    """{role: generator} of ``seed`` (``SEED_ROLES``, drawn by
    ``utils/seeding.py::role_generators``); ``device`` defaults to
    ``cuda``."""
    return role_generators(seed, SEED_ROLES, _CPU_ROLES,
                           resolve_device(device))


@dataclasses.dataclass
class SweepState:
    params: CRVAEParams        # every leaf (S, ...)
    best_params: CRVAEParams
    best_loss: torch.Tensor    # (S,)
    generators: list           # each seed's run generator
    step: int


def init_sweep_state(model: CRVAE, seeds, device=None) -> SweepState:
    """Each seed's init from its own init generator, stacked; each seed's
    run generator; best loss +inf."""
    dev = resolve_device(device)
    gens = [seed_generators(s, dev) for s in seeds]
    params = stack_trees([model.init(g["init"], dev) for g in gens])
    return SweepState(params=params, best_params=params,
                      best_loss=torch.full((len(gens),), float("inf"),
                                           device=dev),
                      generators=[g["run"] for g in gens], step=0)


def sweep_forward(model: CRVAE, params: CRVAEParams, batch: torch.Tensor,
                  eps: torch.Tensor, parents: torch.Tensor):
    """``CRVAE.forward`` for S seeds at once.

    batch: (B, T, p) shared by every seed or (S, B, T, p); eps (S, B, H).
    Returns (pred (S, B, T - enc_len, p), mu (S, B, H), logvar (S, B, H)).
    The encoder is one S-head recurrence, the decoder one S * p-head
    recurrence whose heads s * p ... s * p + p - 1 are seed s's, each with
    seed s's teacher-forced input and h0 = seed s's z.  As the forward of
    ``_phase1_update`` it makes that update every seed's.  The kernels take one
    head stride for the input and for h0, so a per-seed input and z are
    repeated over their p heads.
    """
    s, b, hidden = eps.shape
    p, e = model.p, model.enc_len
    if batch.shape[-2] <= e:
        raise ValueError(
            f"window length {batch.shape[-2]} must exceed enc_len={e}")
    h0 = torch.zeros((1, b, hidden), device=batch.device, dtype=batch.dtype)
    _, h_e = heads_recurrence(params.enc, batch[..., :e, :], h0)
    mu = dense_stacked(params.fc_mu, h_e)
    logvar = dense_stacked(params.fc_std, h_e)
    z = mu + torch.exp(0.5 * logvar) * eps
    heads = masked_heads(params.heads, parents)
    flat = GRUParams(*(leaf.reshape(s * p, *leaf.shape[2:]) for leaf in
                       (heads.w_ih, heads.w_hh, heads.b_ih, heads.b_hh)))
    # [0, x_enc_len .. x_{T-2}] along the time axis.
    x_dec = torch.cat([torch.zeros_like(batch[..., :1, :]),
                       batch[..., e:-1, :]], dim=-2)
    td = x_dec.shape[-2]
    if x_dec.ndim == 4:
        x_dec = x_dec[:, None].expand(s, p, b, td, p).reshape(s * p, b, td, p)
    h0_dec = z[:, None].expand(s, p, b, hidden).reshape(s * p, b, hidden)
    outs, _ = heads_recurrence(flat, x_dec, h0_dec)
    outs = outs.view(s, p, b, td, hidden)
    pred = (torch.einsum("spbth,spoh->spbto", outs, params.readout.w)
            + params.readout.b[:, :, None, None, :])
    return pred[..., 0].permute(0, 2, 3, 1), mu, logvar


def make_sweep_step(model: CRVAE, cfg: Phase1Config, windows: torch.Tensor,
                    parents: torch.Tensor):
    """Build the sweep step: ``step(state, batch=None, eps=None)`` -> (new
    SweepState, metrics of (S,) tensors).

    Unless given, each seed draws from its run generator its batch indices
    (unless the batch is fixed) and then its epsilon.  ``batch`` may be the
    (S, B) indices into ``windows``, the (S, B, T, p) windows or one
    (B, T, p) batch for every seed; ``eps`` (S, B, H).  Every
    ``latent_reg`` trains on beta * KL, with no prior (module doc); a name
    other than 'kl' and 'cs' raises.
    """
    check_latent_reg(cfg)
    n = windows.shape[0]
    forward = functools.partial(sweep_forward, model)
    fixed_batch = (None if cfg.resample_batches
                   else default_fixed_batch(windows, cfg.batch_size))

    def step(state: SweepState, batch: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None):
        gens = state.generators
        if batch is None:
            batch = fixed_batch
            if batch is None:
                batch = torch.stack([
                    torch.randint(0, n, (cfg.batch_size,), generator=g,
                                  device=g.device) for g in gens])
        if not batch.is_floating_point():
            batch = windows[batch.to(windows.device)]
        if eps is None:
            eps = torch.stack([
                torch.randn((batch.shape[-3], model.hidden), generator=g,
                            device=g.device) for g in gens])
        # No prior, whatever cfg.latent_reg says: the JAX package's sweep
        # (vae_connexe_tpu/parallel/seed_sweep.py:37).
        params, _, metrics = _phase1_update(model, cfg, state.params, None,
                                            parents, batch,
                                            eps.to(batch.device),
                                            forward=forward)
        best_params, best_loss = _track_best(state, state.params,
                                             metrics["mean_loss"])
        return SweepState(params=params, best_params=best_params,
                          best_loss=best_loss, generators=gens,
                          step=state.step + 1), metrics

    return step


def make_sweep_fn(model: CRVAE, windows: torch.Tensor, parents: torch.Tensor,
                  cfg: Phase1Config, mesh=None):
    """Build the multi-seed sweep once.

    Returns ``run(seeds) -> {"gc_scores" (S, p, p), "mean_loss" (S,),
    "best_loss" (S,)}``: each seed's scores at its best params, its last
    step's ``mean_loss`` and its best loss, as tensors on ``windows``'
    device.  ``seeds`` is a sequence of integers.  ``mesh``: the seed axis
    over dp (module doc); every rank gets every seed's results.
    """
    if mesh is not None:
        from vae_connexe_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    step = make_sweep_step(model, cfg, windows, parents)

    def train(seeds) -> dict:
        state = init_sweep_state(model, seeds, windows.device)
        metrics = {}
        for _ in range(cfg.max_iter):
            state, metrics = step(state)
        # CRVAE.gc reduces the gate axis, so it scores every seed at once.
        return {"gc_scores": model.gc(state.best_params, parents,
                                      threshold=False),
                "mean_loss": metrics["mean_loss"],
                "best_loss": state.best_loss}

    def run(seeds) -> dict:
        seeds = [int(s) for s in seeds]
        if mesh is None:
            return train(seeds)
        return _meshed_seeds(mesh, seeds, train)

    return run


def _meshed_seeds(mesh, seeds: list, train) -> dict:
    """``train`` on this rank's dp slice of ``seeds`` (padded to a dp
    multiple with the last seed), the results gathered over dp and cut to
    ``len(seeds)`` seeds."""
    from vae_connexe_torch.parallel.collectives import cat_gather
    from vae_connexe_torch.parallel.mesh import (
        axis_group,
        axis_index,
        axis_size,
    )

    n_dp = axis_size(mesh, "dp")
    padded = seeds + seeds[-1:] * ((-len(seeds)) % n_dp)
    k = len(padded) // n_dp
    d = axis_index(mesh, "dp")
    out = train(padded[d * k:(d + 1) * k])
    group = axis_group(mesh, "dp")
    return {name: cat_gather(v, group)[:len(seeds)]
            for name, v in out.items()}


def sweep_phase1(model: CRVAE, windows: torch.Tensor, parents: torch.Tensor,
                 cfg: Phase1Config, seeds, mesh=None) -> dict:
    """Train one phase-1 model per seed, all at once: ``make_sweep_fn``
    called once (build the callable for repeated sweeps).

    windows (N, ctx, p) on the device the sweep runs on; seeds a sequence
    of integers.
    """
    return make_sweep_fn(model, windows, parents, cfg, mesh)(seeds)
