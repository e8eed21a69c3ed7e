"""Two-phase CRVAE training and compensated generation (port of
``vae_connexe_tpu/train/crvae_trainer.py``).

Phase 1, structure learning: each step computes the loss (sum of the
per-variable MSEs + ridge + the latent regulariser) and its gradient at
the incoming parameters, takes a manual SGD step, projects the head input
weights onto the parents mask and group-soft-thresholds their columns;
the surviving columns are the learned Granger graph.  The latent
regulariser is beta * KL, or with ``latent_reg='cs'`` ``lambda_cs`` times
the mean CS divergence against a learnable GMM prior, which the state
carries (``prior``) and each step moves by plain SGD at ``cfg.lr``.
Phase 2, generation: the same step with lam = 0 on the pruned CRVAE under
the binary GC mask, plus the error VAE trained by Adam on the detached
residuals.  The best model is the one with the lowest ``mean_loss``,
snapshotted at the parameters that achieved it.

PyTorch runs eagerly, so each fit is a Python loop over steps in chunks of
``check_every`` (``_run_chunked``, shared by both fits); the host reads the
metrics once per chunk.  On the card every recurrence of a step runs
through the B1/B2 kernels (``ops/dispatch.py``): 2 + 2 launches a phase-1
step, 4 + 4 a phase-2 step (the ErrorVAE's encoder and decoder are
one-head launches).  The whole phase-1 step in one kernel family (B3) is
the separate entry point ``ops.cuda_step.fused_phase1_step``, as in the
JAX package, where ``fit_phase1`` does not call it either.

Random draws come from the ``torch.Generator`` a fit is given: with
``latent_reg='cs'`` a fit first draws the prior's means, then a phase-1
step draws its batch indices first and its reparameterisation epsilon
second (with a fixed batch, only epsilon); a phase-2 step draws the
indices, epsilon (B, H), then the error VAE's epsilon (B, Z), the order of
the reference's ``k_batch, k_z, k_e`` split.  Each can be passed to a step
as a tensor instead.  The JAX package's threefry keys give other numbers,
so results match it draw for draw only when the draws are passed in.

Checkpoints (``checkpoint_dir``) hold the whole phase state, the
generator's state included, so a killed and resumed fit equals the
uninterrupted one bitwise.

On a mesh (``mesh=``, ``parallel/mesh.py``; one process a device) each
step runs on this rank's part, its dp slice of the batch and its ep share
of the heads, and sums gradients and terms over the mesh in rank order
(``parallel/sharded.py``); every rank draws the whole batch and epsilon
from its generator and keeps its slice, so the draws are the unmeshed
fit's, and a mesh of one rank is the unmeshed fit bit for bit.

Compensated generation: draw an error sequence from the error VAE and
inject it, scaled by ``model.noise_scale``, into the CRVAE's free run.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch.losses.cs_divergence import cs_divergence_gmm
from vae_connexe_torch.losses.kl import kl_gaussian
from vae_connexe_torch.losses.penalties import ridge_value
from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams, masked_heads
from vae_connexe_torch.models.error_vae import ErrorVAE, ErrorVAEParams
from vae_connexe_torch.models.gmm_prior import GMMPrior, init_gmm_prior
from vae_connexe_torch.ops.cuda_rollout import (
    cast_weights,
    crvae_free_run_fused,
    errvae_sample_fused,
    serve_dtype,
)
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.optim.prox import prox_column_groups
from vae_connexe_torch.train.config import (
    Phase1Config,
    Phase2Config,
    check_latent_reg,
)
from vae_connexe_torch.utils import debug
from vae_connexe_torch.utils.checkpoint import TrainCheckpointer
from vae_connexe_torch.utils.layers import Dense
from vae_connexe_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

KERNELS = ("lax", "fused", "auto")


@dataclasses.dataclass
class Phase1State:
    params: CRVAEParams
    prior: Optional[GMMPrior]      # present when latent_reg == 'cs'
    best_params: CRVAEParams
    best_loss: torch.Tensor        # 0-d
    generator: torch.Generator
    step: int


@dataclasses.dataclass
class Phase2State:
    params: CRVAEParams
    err_params: ErrorVAEParams
    err_opt: AdamState
    prior: Optional[GMMPrior]
    best_params: CRVAEParams
    best_loss: torch.Tensor        # 0-d
    generator: torch.Generator
    step: int


def _crvae_loss(model: CRVAE, cfg, params: CRVAEParams,
                prior: Optional[GMMPrior], batch: torch.Tensor,
                eps: torch.Tensor, parents: torch.Tensor, beta: float,
                recurrences=None, forward=None, layout=None):
    """Smooth loss: sum over variables of each variable's MSE + ridge +
    the latent regulariser, beta * KL without a prior and
    ``cfg.lambda_cs`` * mean D_CS(q || GMM) with one.  Returns (loss, aux).

    ``forward(params, batch, eps, parents)`` stands in for
    ``model.forward``: a seed-stacked one (``parallel/seed_sweep.py``,
    which has no prior) gives a leading seed axis to its outputs and to
    every term here, one loss a seed.

    ``layout`` (``parallel/sharded.py::RankLayout``, meshed steps): the
    params hold this rank's heads and the batch its dp slice; every term
    is this rank's share of the global one (the means over the batch
    scaled by its share, the ridge and the latent term counted on one rank
    of their lines), so that the terms summed over the mesh are the
    unmeshed step's.
    """
    if forward is None:
        pred, mu, logvar = model.forward(params, batch, eps, parents,
                                         recurrences=recurrences)
    else:
        pred, mu, logvar = forward(params, batch, eps, parents)
    keep = pred.ndim - 3
    target = batch[..., model.enc_len:, :]
    share = 1.0
    if layout is not None:
        target = target[..., layout.cols]
        share = layout.batch_scale
    recon = torch.mean((pred - target) ** 2, dim=(-3, -2))
    if share != 1.0:
        recon = recon * share
    recon = recon.sum(dim=-1)
    if layout is None or layout.count_heads:
        ridge = ridge_value(params.readout.w, params.heads.w_hh,
                            cfg.lam_ridge, keep=keep)
    else:
        ridge = torch.zeros((), device=pred.device)
    if layout is not None and not layout.count_latent:
        reg = torch.zeros((), device=pred.device)
    elif prior is None:
        reg = beta * kl_gaussian(mu, logvar, keep=keep)
    else:
        reg = cfg.lambda_cs * cs_divergence_gmm(
            mu, torch.exp(logvar), prior.mu, prior.var,
            variant=cfg.cs_variant).mean()
    if share != 1.0 and layout.count_latent:
        reg = reg * share
    loss = recon + ridge + reg
    aux = {"recon": recon, "ridge": ridge, "latent_reg": reg,
           "mean_loss": (recon + ridge) / model.p, "pred": pred}
    return loss, aux


def _project_and_prox(params: CRVAEParams, parents: torch.Tensor,
                      lam: float, lr: float) -> CRVAEParams:
    """Mask-project the head input weights onto the parent support, then
    group-soft-threshold their columns (the GISTA step).  With lam = 0 the
    prox is the identity and only the projection remains."""
    w = params.heads.w_ih * parents[:, None, :].to(params.heads.w_ih)
    w = prox_column_groups(w, lam, lr)
    return dataclasses.replace(params,
                               heads=dataclasses.replace(params.heads, w_ih=w))


def _chunk_lengths(max_iter: int, check_every: int) -> list[int]:
    """Full chunks of ``check_every`` plus one remainder chunk, so exactly
    ``max_iter`` steps run."""
    full, rem = divmod(max_iter, check_every)
    return [check_every] * full + ([rem] if rem else [])


def _init_prior(cfg, model: CRVAE, generator: torch.Generator,
                device) -> Optional[GMMPrior]:
    """The GMM prior of a ``latent_reg='cs'`` fit (latent width
    ``model.hidden``), drawn from ``generator``; None for 'kl'."""
    if cfg.latent_reg != "cs":
        return None
    return init_gmm_prior(generator, cfg.gmm_components, model.hidden,
                          device=device)


def _make_checkpointer(checkpoint_dir, checkpoint_every, mesh=None,
                       state_sharding=None):
    """The fit's checkpointer: None without a directory; on a mesh, one
    that saves the gathered state from rank 0 and restores it on every
    rank (``parallel/sharded.py::MeshCheckpointer``)."""
    if checkpoint_dir is None:
        return None
    if mesh is not None:
        from vae_connexe_torch.parallel.sharded import MeshCheckpointer

        return MeshCheckpointer(checkpoint_dir, checkpoint_every, mesh,
                                state_sharding)
    return TrainCheckpointer(checkpoint_dir, checkpoint_every)


def _sp_context(mesh):
    """The sequence-parallel mode of a fit whose mesh has an sp axis of
    more than one rank: the decoder recurrence runs through the sp
    pipeline (``ops/dispatch.py::seq_parallel``), the batch staying split
    over dp."""
    from contextlib import nullcontext

    if mesh is not None:
        from vae_connexe_torch.parallel.mesh import axis_size

        if axis_size(mesh, "sp") > 1:
            from vae_connexe_torch.ops.dispatch import seq_parallel

            return seq_parallel(mesh)
    return nullcontext()


def _mesh_checks(mesh, model: CRVAE, cfg, window_len: int):
    """JAX's checks of a meshed fit; returns its batch sharding (None
    without a mesh)."""
    if mesh is None:
        return None
    from vae_connexe_torch.parallel.mesh import batch_sharding, check_mesh
    from vae_connexe_torch.parallel.sharded import (
        check_mesh_divisibility,
        check_sp_compat,
    )

    check_mesh(mesh)
    check_mesh_divisibility(mesh, model.p, cfg.batch_size)
    check_sp_compat(mesh, window_len - model.enc_len)
    return batch_sharding(mesh)


def _shard_state(state, mesh):
    """(this rank's part of ``state``, the state's sharding); unchanged
    without a mesh."""
    if mesh is None:
        return state, None
    from vae_connexe_torch.parallel import sharded
    from vae_connexe_torch.parallel.mesh import global_device_put

    fn = (sharded.phase1_state_sharding if isinstance(state, Phase1State)
          else sharded.phase2_state_sharding)
    sharding = fn(mesh, state.prior is not None)
    return global_device_put(state, sharding), sharding


def _gathered(params: CRVAEParams, mesh) -> CRVAEParams:
    """The whole CRVAE params from every rank's part (a collective);
    unchanged without a mesh."""
    if mesh is None:
        return params
    from vae_connexe_torch.parallel.mesh import gather_tree
    from vae_connexe_torch.parallel.sharded import crvae_param_sharding

    return gather_tree(params, crvae_param_sharding(mesh))


def _restore_if_resuming(ckpt, state, resume: bool):
    """(state, metrics) from the latest snapshot when resuming and one
    exists, else (state, None)."""
    if ckpt is not None and resume:
        restored = ckpt.restore(state)
        if restored is not None:
            return restored
    return state, None


def _stepper(step, phase: str, batches=None):
    """``run_chunk(state, length)``: ``length`` steps; returns the state
    and the last step's metrics.  ``batches``: an iterator of the steps'
    batches (a streamed fit), else each step finds its own.  Under nan
    debugging each step's metrics and updated parameters are checked
    (``utils/debug.py``)."""
    def run_chunk(state, length):
        last = {}
        for _ in range(length):
            with debug.at_step(f"{phase} step {state.step + 1}"):
                state, last = (step(state) if batches is None
                               else step(state, next(batches)))
                debug.check_finite("the metrics and updated parameters",
                                   last, state.params, state.prior)
        return state, last
    return run_chunk


def _run_chunked(run_chunk, state, cfg, ckpt, resume_metrics, verbose,
                 log_fn, callback, phase: str):
    """The resume-aware chunk loop of both fits.

    ``state.step`` may be non-zero (a restored mid-phase snapshot): chunks
    the uninterrupted run already ran are skipped, and the rest run from
    the exact state the uninterrupted run had at that boundary, so a
    killed and resumed fit is bitwise the uninterrupted one.  Snapshots
    land only on chunk boundaries, so a restored step that is not a prefix
    sum of the chunk lengths means the config changed between runs: that
    raises.
    """
    start = int(state.step)
    metrics = dict(resume_metrics) if resume_metrics else {}
    done = 0
    for length in _chunk_lengths(cfg.max_iter, cfg.check_every):
        end = done + length
        if end <= start:
            done = end
            continue
        if done < start:
            raise ValueError(
                f"resumed step {start} is not a chunk boundary of "
                f"check_every={cfg.check_every} / max_iter={cfg.max_iter}: "
                f"the config changed since the checkpoint was written")
        done = end
        state, last = run_chunk(state, length)
        metrics = {k: float(v) for k, v in last.items()}
        if ckpt is not None:
            ckpt.maybe_save(state, metrics, final=(done == cfg.max_iter))
        if verbose:
            log_fn(f"[{phase} it={int(state.step)}] "
                   + " ".join(f"{k}={v:.5f}" for k, v in metrics.items()))
        if callback is not None:
            callback(int(state.step), state, metrics)
    return state, metrics


def _track_best(state, candidate_params: CRVAEParams,
                mean_loss: torch.Tensor):
    """Snapshot ``candidate_params`` when ``mean_loss`` improves.

    ``mean_loss`` is measured at the pre-update parameters, so callers pass
    those as the candidate.  It is 0-d, or (S,) for parameters with a
    leading seed axis (``parallel/seed_sweep.py``), each seed picked on its
    own.  No host sync: the pick is a ``torch.where``.
    """
    improved = mean_loss < state.best_loss
    best_params = tree_map(
        lambda new, old: torch.where(
            improved.view(-1, *([1] * (new.ndim - 1))), new, old),
        candidate_params, state.best_params)
    return best_params, torch.minimum(mean_loss, state.best_loss)


def _live(tree):
    """A copy of ``tree`` (None stays None) whose leaves require grad."""
    return tree_map(lambda t: t.detach().requires_grad_(True), tree)


def _grads(loss: torch.Tensor, leaves: list, layout) -> list:
    """d loss / d leaves.  On a mesh a rank may not use every leaf (an
    ep rank other than the first leaves the prior out of its loss): its
    gradient is zero there."""
    if layout is None:
        return list(torch.autograd.grad(loss, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g
            for g, x in zip(grads, leaves)]


def _sgd(tree, grads, lr: float):
    """``tree`` - lr * ``grads`` leaf by leaf (None stays None)."""
    return tree_map(lambda p, g: p - lr * g, tree, tree_unflatten(tree, grads))


def _mesh_terms(layout, model: CRVAE, terms: dict) -> dict:
    """The global values of a meshed step's scalar terms (each rank's
    share summed over the mesh) and ``mean_loss`` from them; unmeshed
    steps' terms pass unchanged."""
    if layout is None:
        return terms
    from vae_connexe_torch.parallel.sharded import reduce_scalars

    out = reduce_scalars(layout, terms)
    out["mean_loss"] = (out["recon"] + out["ridge"]) / model.p
    return out


def _phase1_update(model: CRVAE, cfg: Phase1Config, params: CRVAEParams,
                   prior: Optional[GMMPrior], parents: torch.Tensor,
                   batch: torch.Tensor, eps: torch.Tensor, recurrences=None,
                   forward=None, layout=None):
    """One phase-1 update on a given batch and epsilon: the loss and its
    gradient at ``params`` and ``prior``, SGD on every leaf of both, then
    the mask projection and the prox.  Returns (new params, new prior,
    metrics of 0-d tensors).  With a seed-stacked ``forward``
    (``_crvae_loss``) the parameters carry a leading seed axis and there
    is no prior: one backward of the sum of the seeds' losses gives each
    seed its own gradient, since their parameters are disjoint, and the
    metrics are (S,).  With a ``layout`` (a meshed step; ``params``,
    ``parents``' rows and the batch are this rank's) the gradients and the
    terms are summed over the mesh before the update
    (``parallel/sharded.py``)."""
    with torch.enable_grad():
        live, live_prior = _live(params), _live(prior)
        loss, aux = _crvae_loss(model, cfg, live, live_prior, batch, eps,
                                parents, cfg.beta, recurrences, forward,
                                layout)
        debug.check_finite("the loss", loss)
        leaves = tree_leaves(live)
        grads = _grads(loss.sum(), leaves + tree_leaves(live_prior), layout)
    with torch.no_grad():
        terms = {"loss": loss.detach(), "recon": aux["recon"].detach(),
                 "latent_reg": aux["latent_reg"].detach(),
                 "ridge": aux["ridge"].detach(),
                 "mean_loss": aux["mean_loss"].detach()}
        if layout is not None:
            from vae_connexe_torch.parallel.sharded import reduce_crvae_grads

            grads = reduce_crvae_grads(layout, params, grads)
            terms = _mesh_terms(layout, model, terms)
        new = _sgd(params, grads[:len(leaves)], cfg.lr)
        new_prior = _sgd(prior, grads[len(leaves):], cfg.lr)
        new = _project_and_prox(new, parents, cfg.lam, cfg.lr)
        usage = (torch.linalg.vector_norm(new.heads.w_ih, dim=-2) > 0
                 ).float().mean(dim=(-2, -1))
        if layout is not None:
            from vae_connexe_torch.parallel.sharded import reduce_scalars

            if layout.n_ep > 1:
                usage = usage * (1.0 / layout.n_ep)
            usage = reduce_scalars(layout, {"u": usage}, "ep")["u"]
    metrics = {"loss": terms["loss"], "recon": terms["recon"],
               "latent_reg": terms["latent_reg"],
               "mean_loss": terms["mean_loss"], "variable_usage": usage}
    return new, new_prior, metrics


def default_fixed_batch(windows: torch.Tensor,
                        batch_size: int) -> torch.Tensor:
    """The one batch a phase-1 step without resampling trains on when it is
    given none: a random gather drawn from a generator seeded 0."""
    g0 = torch.Generator(device=windows.device).manual_seed(0)
    idx = torch.randint(0, windows.shape[0], (batch_size,), generator=g0,
                        device=windows.device)
    return windows[idx]


def _window_count(windows, n_windows) -> int:
    """The window count a step draws its indices over: ``n_windows`` if
    given, else ``windows``'s."""
    if n_windows is None and windows is None:
        raise ValueError("the step draws its indices over n_windows: pass "
                         "n_windows or windows")
    return windows.shape[0] if n_windows is None else n_windows


def _layout_of(batch_sharding, model: CRVAE, batch_size: int):
    """The ``RankLayout`` of a meshed step (None without a mesh)."""
    if batch_sharding is None:
        return None
    from vae_connexe_torch.parallel.sharded import RankLayout

    return RankLayout(batch_sharding.mesh, model.p, batch_size)


def _draw_batch(layout, g: torch.Generator, n: int, batch_size: int,
                windows: Optional[torch.Tensor]):
    """One step's batch indices over ``n`` windows, drawn whole from ``g``
    (every rank draws the same), and the batch this rank trains on: the
    gathered windows of its dp slice of the indices (None when
    ``windows`` is)."""
    idx = torch.randint(0, n, (batch_size,), generator=g, device=g.device)
    if layout is not None:
        idx = layout.local(idx)
    if windows is None:
        return None
    return windows[idx.to(windows.device)]


def _draw_eps(layout, g: torch.Generator, shape) -> torch.Tensor:
    """A (B, ...) normal draw, whole from ``g``; this rank's dp slice."""
    eps = torch.randn(shape, generator=g, device=g.device)
    return eps if layout is None else layout.local(eps)


def make_phase1_step(model: CRVAE, cfg: Phase1Config, windows: torch.Tensor,
                     parents: torch.Tensor,
                     fixed_batch: Optional[torch.Tensor] = None,
                     batch_sharding=None, stream: bool = False, *,
                     n_windows: Optional[int] = None):
    """Build the phase-1 step: ``step(state, batch=None, eps=None)`` ->
    (new Phase1State, metrics).

    Each call draws from ``state.generator`` the batch indices (unless a
    fixed batch is set or ``batch`` is given), then epsilon (B, H) (unless
    ``eps`` is given).  Without a ``fixed_batch`` and with
    ``cfg.resample_batches`` false, the fixed batch is one random gather
    drawn here from a generator seeded 0.  The latent regulariser follows
    ``state.prior`` (KL without one), as the JAX package's step does.  The
    best-model pick sees the pre-update parameters; ``variable_usage`` is
    read after the update.

    ``stream=True`` builds the out-of-core step (``train/streaming.py``):
    each call takes its ``batch`` from the caller, and still draws its
    indices over ``n_windows`` (default ``windows.shape[0]``; ``windows``
    may then be None) and discards them, so the generator's draws stay the
    in-memory step's and a caller that replays them gathers the same
    batches.

    ``batch_sharding`` (``parallel/mesh.py::batch_sharding(mesh)``, meshed
    fits): the step runs on this rank's part, its dp slice of every batch
    and its ep share of the heads (the state holds this rank's params;
    ``parents`` is the whole mask), and sums gradients and terms over the
    mesh (``parallel/sharded.py``).  It draws every batch's indices and
    epsilon whole, as the unmeshed step does, and keeps its slice, so the
    generator's draws are the unmeshed step's; a ``batch``, ``eps`` or
    ``fixed_batch`` given may be whole or this rank's slice.
    """
    check_latent_reg(cfg)
    n = _window_count(windows, n_windows)
    if fixed_batch is None and not cfg.resample_batches and not stream:
        fixed_batch = default_fixed_batch(windows, cfg.batch_size)
    layout = _layout_of(batch_sharding, model, cfg.batch_size)
    if layout is not None:
        parents = layout.heads_of(parents)
        fixed_batch = layout.local(fixed_batch)

    def step(state: Phase1State, batch: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None):
        g = state.generator
        if stream:
            if batch is None:
                raise ValueError("a streamed step takes its batch")
            _draw_batch(layout, g, n, cfg.batch_size, None)
        elif batch is None:
            if fixed_batch is not None:
                batch = fixed_batch
            else:
                batch = _draw_batch(layout, g, n, cfg.batch_size, windows)
        if layout is not None:
            batch = layout.local(batch)
        if eps is None:
            b = cfg.batch_size if layout is not None else batch.shape[0]
            eps = _draw_eps(layout, g, (b, model.hidden))
        elif layout is not None:
            eps = layout.local(eps)
        params, prior, metrics = _phase1_update(
            model, cfg, state.params, state.prior, parents, batch,
            eps.to(batch.device), layout=layout)
        best_params, best_loss = _track_best(state, state.params,
                                             metrics["mean_loss"])
        return Phase1State(params=params, prior=prior,
                           best_params=best_params, best_loss=best_loss,
                           generator=g, step=state.step + 1), metrics

    return step


def fit_phase1(model: CRVAE, params: CRVAEParams, windows: torch.Tensor,
               parents: torch.Tensor, cfg: Phase1Config,
               generator: torch.Generator, verbose: bool = False,
               log_fn=print, callback=None, mesh=None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, resume: bool = False):
    """Run phase 1 for exactly ``cfg.max_iter`` steps; returns (the params
    of the lowest ``mean_loss``, the final state, the last metrics as
    floats).

    ``windows`` (N, T, p) lie on the device the fit runs on.  With
    ``cfg.latent_reg='cs'`` the GMM prior (``cfg.gmm_components``
    components of width ``model.hidden``) is drawn from ``generator``
    first; with ``cfg.resample_batches`` false, the one fixed batch is
    drawn from it next, before the first step.  The host reads the metrics once
    per chunk of ``cfg.check_every`` steps; ``callback(step, state,
    metrics)`` fires then.

    ``checkpoint_dir`` snapshots the whole state every ``checkpoint_every``
    steps (at chunk boundaries) and at the final step; ``resume=True``
    restores the latest snapshot, if there is one, into ``generator`` and
    the state and runs only the remaining chunks, bitwise equal to the
    uninterrupted fit.  A resumed finished phase is a pure restore.

    ``mesh`` (``parallel/mesh.py::make_mesh``; this process is one rank of
    it) runs the same loop sharded: every rank passes the same whole
    ``params``, ``windows`` and an identically seeded ``generator``, draws
    every batch whole and trains on its dp slice of it and its ep share of
    the heads, the gradients summed over the mesh
    (``parallel/sharded.py``); with an sp axis the decoder recurrence runs
    through the sp pipeline.  The returned params are gathered whole and
    the metrics are global, the same on every rank; the state holds this
    rank's part.  Checkpoints are written by rank 0 from the gathered
    state and restored on every rank.  A mesh of one rank is bit for bit
    the unmeshed fit.
    """
    check_latent_reg(cfg)
    bs = _mesh_checks(mesh, model, cfg, windows.shape[1])
    prior = _init_prior(cfg, model, generator, windows.device)
    fixed_batch = None
    if not cfg.resample_batches:
        idx = torch.randint(0, windows.shape[0], (cfg.batch_size,),
                            generator=generator, device=generator.device)
        fixed_batch = windows[idx.to(windows.device)]
    step = make_phase1_step(model, cfg, windows, parents, fixed_batch,
                            batch_sharding=bs)
    state = Phase1State(params=params, prior=prior, best_params=params,
                        best_loss=torch.tensor(float("inf"),
                                               device=windows.device),
                        generator=generator, step=0)
    state, sharding = _shard_state(state, mesh)
    ckpt = _make_checkpointer(checkpoint_dir, checkpoint_every, mesh,
                              sharding)
    state, resume_metrics = _restore_if_resuming(ckpt, state, resume)
    with _sp_context(mesh):
        state, metrics = _run_chunked(_stepper(step, "phase1"), state, cfg,
                                      ckpt, resume_metrics, verbose, log_fn,
                                      callback, "phase1")
    return _gathered(state.best_params, mesh), state, metrics


def _phase2_update(model: CRVAE, err_model: ErrorVAE, cfg: Phase2Config,
                   state: Phase2State, parents: torch.Tensor,
                   batch: torch.Tensor, eps: torch.Tensor,
                   eps_err: torch.Tensor, layout=None, err_opt=None):
    """One phase-2 update on a given batch and draws: one backward of the
    CRVAE loss plus the error VAE's loss over the leaves of both models
    and of the prior, SGD and the mask projection on the CRVAE, SGD on the
    prior, Adam on the error VAE (or ``err_opt(grads, opt_state, params)
    -> (params, opt_state)``).  Returns (params, prior, err_params,
    err_opt, metrics of 0-d tensors).  With a ``layout`` (a meshed step)
    the residuals' columns are gathered over ep, the error VAE's terms
    are this rank's share of the batch, and the gradients and terms are
    summed over the mesh (``parallel/sharded.py``): the error VAE's over
    dp, as every rank of an ep line computes the same."""
    with torch.enable_grad():
        live, live_prior = _live(state.params), _live(state.prior)
        err_live = _live(state.err_params)
        main_loss, aux = _crvae_loss(model, cfg, live, live_prior, batch, eps,
                                     parents, cfg.beta, layout=layout)
        pred = aux["pred"]
        if layout is not None and layout.n_ep > 1:
            from vae_connexe_torch.parallel.collectives import cat_gather

            pred = cat_gather(pred.detach(), layout.group("ep"), dim=-1)
        # The gradient firewall: the error VAE trains on the residuals as
        # data, so its loss sends no gradient into the CRVAE.
        error = (batch[:, model.enc_len:, :] - pred).detach()
        recon_e, mu_e, logvar_e = err_model.forward(err_live, error, eps_err)
        loss_e = torch.mean((recon_e - error) ** 2)
        kl_e = kl_gaussian(mu_e, logvar_e)
        if layout is not None and layout.batch_scale != 1.0:
            loss_e = loss_e * layout.batch_scale
            kl_e = kl_e * layout.batch_scale
        smooth_e = loss_e + cfg.beta_error * kl_e
        debug.check_finite("the loss", main_loss, smooth_e)
        leaves, err_leaves = tree_leaves(live), tree_leaves(err_live)
        prior_leaves = tree_leaves(live_prior)
        # The two losses are gradient-disjoint, so one backward of their
        # sum serves both optimisers.
        grads = _grads(main_loss + smooth_e,
                       leaves + prior_leaves + err_leaves, layout)
    with torch.no_grad():
        n, m = len(leaves), len(leaves) + len(prior_leaves)
        terms = {"recon": aux["recon"].detach(),
                 "latent_reg": aux["latent_reg"].detach(),
                 "ridge": aux["ridge"].detach(),
                 "mean_loss": aux["mean_loss"].detach(),
                 "loss_e": smooth_e.detach(), "kl_e": kl_e.detach()}
        if layout is not None:
            from vae_connexe_torch.parallel.collectives import (
                ordered_sum_flat,
            )
            from vae_connexe_torch.parallel.sharded import reduce_crvae_grads

            grads = (reduce_crvae_grads(layout, state.params, grads[:m])
                     + ordered_sum_flat(grads[m:], layout.group("dp")))
            if not layout.count_latent:
                # Every rank of an ep line computes the same error-VAE
                # terms: one of them counts.
                terms["loss_e"] = torch.zeros_like(terms["loss_e"])
                terms["kl_e"] = torch.zeros_like(terms["kl_e"])
            terms = _mesh_terms(layout, model, terms)
        params = _sgd(state.params, grads[:n], cfg.lr)
        params = _project_and_prox(params, parents, 0.0, cfg.lr)
        prior = _sgd(state.prior, grads[n:m], cfg.lr)
        g_err = tree_unflatten(state.err_params, grads[m:])
        if err_opt is None:
            err_params, err_state = adam_update(g_err, state.err_opt,
                                                state.err_params,
                                                cfg.lr_error)
        else:
            err_params, err_state = err_opt(g_err, state.err_opt,
                                            state.err_params)
    metrics = {k: terms[k] for k in ("recon", "latent_reg", "mean_loss",
                                     "loss_e", "kl_e")}
    return params, prior, err_params, err_state, metrics


def make_phase2_step(model: CRVAE, err_model: ErrorVAE, cfg: Phase2Config,
                     windows: torch.Tensor, parents: torch.Tensor,
                     batch_sharding=None, stream: bool = False, *,
                     n_windows: Optional[int] = None):
    """Build the phase-2 step: ``step(state, batch=None, eps=None,
    eps_err=None)`` -> (new Phase2State, metrics).

    Each call draws from ``state.generator`` the batch indices (unless
    ``batch`` is given), then epsilon (B, H) (unless ``eps``), then the
    error VAE's epsilon (B, Z) (unless ``eps_err``).  The loss is the CRVAE
    loss (its latent regulariser beta * KL at ``cfg.beta``, or the CS
    divergence against ``state.prior`` when there is one) plus the error
    VAE's ``mean((recon - error)^2) + beta_error * KL`` on the detached
    residuals; SGD with the mask projection (lam = 0) updates the CRVAE,
    SGD the prior, Adam at ``cfg.lr_error`` the error VAE.  The best-model
    pick sees the pre-update CRVAE params.  ``batch_sharding``,
    ``stream`` and ``n_windows`` as in ``make_phase1_step``.
    """
    check_latent_reg(cfg)
    n = _window_count(windows, n_windows)
    layout = _layout_of(batch_sharding, model, cfg.batch_size)
    if layout is not None:
        parents = layout.heads_of(parents)

    def step(state: Phase2State, batch: Optional[torch.Tensor] = None,
             eps: Optional[torch.Tensor] = None,
             eps_err: Optional[torch.Tensor] = None):
        g = state.generator
        if stream:
            if batch is None:
                raise ValueError("a streamed step takes its batch")
            _draw_batch(layout, g, n, cfg.batch_size, None)
        elif batch is None:
            batch = _draw_batch(layout, g, n, cfg.batch_size, windows)
        b = batch.shape[0]
        if layout is not None:
            batch, b = layout.local(batch), cfg.batch_size
        eps = (_draw_eps(layout, g, (b, model.hidden)) if eps is None
               else eps if layout is None else layout.local(eps))
        eps_err = (_draw_eps(layout, g, (b, err_model.latent))
                   if eps_err is None
                   else eps_err if layout is None else layout.local(eps_err))
        params, prior, err_params, err_opt, metrics = _phase2_update(
            model, err_model, cfg, state, parents, batch,
            eps.to(batch.device), eps_err.to(batch.device), layout=layout)
        best_params, best_loss = _track_best(state, state.params,
                                             metrics["mean_loss"])
        return Phase2State(params=params, err_params=err_params,
                           err_opt=err_opt, prior=prior,
                           best_params=best_params, best_loss=best_loss,
                           generator=g, step=state.step + 1), metrics

    return step


def fit_phase2(model: CRVAE, err_model: ErrorVAE, params: CRVAEParams,
               err_params: ErrorVAEParams, windows: torch.Tensor,
               parents: torch.Tensor, cfg: Phase2Config,
               generator: torch.Generator, verbose: bool = False,
               log_fn=print, callback=None, mesh=None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 0, resume: bool = False):
    """Run phase 2 for exactly ``cfg.max_iter`` steps; returns (the CRVAE
    params of the lowest ``mean_loss``, the final error-VAE params, the
    final state, the last metrics as floats).

    ``parents`` is the binary GC mask from phase 1, held fixed.  With
    ``cfg.latent_reg='cs'`` a fresh GMM prior is drawn from ``generator``
    first, as in ``fit_phase1``.  Every step resamples its batch from
    ``generator``.  ``callback``, checkpoints and ``resume`` as in
    ``fit_phase1``; a snapshot carries both models, Adam's state, the
    prior, the best params and loss, the generator's state and the step.
    ``mesh`` as in ``fit_phase1``: the error VAE and its Adam state are
    replicated, its gradients summed over dp.
    """
    check_latent_reg(cfg)
    bs = _mesh_checks(mesh, model, cfg, windows.shape[1])
    prior = _init_prior(cfg, model, generator, windows.device)
    step = make_phase2_step(model, err_model, cfg, windows, parents,
                            batch_sharding=bs)
    state = Phase2State(params=params, err_params=err_params,
                        err_opt=adam_init(err_params), prior=prior,
                        best_params=params,
                        best_loss=torch.tensor(float("inf"),
                                               device=windows.device),
                        generator=generator, step=0)
    state, sharding = _shard_state(state, mesh)
    ckpt = _make_checkpointer(checkpoint_dir, checkpoint_every, mesh,
                              sharding)
    state, resume_metrics = _restore_if_resuming(ckpt, state, resume)
    with _sp_context(mesh):
        state, metrics = _run_chunked(_stepper(step, "phase2"), state, cfg,
                                      ckpt, resume_metrics, verbose, log_fn,
                                      callback, "phase2")
    return (_gathered(state.best_params, mesh), state.err_params, state,
            metrics)


def generate_from_draws(model: CRVAE, err_model: ErrorVAE, heads: GRUParams,
                        readout: Dense, dec: GRUParams, out: Dense,
                        h0_err: torch.Tensor, h0: torch.Tensor,
                        steps: Optional[int] = None) -> torch.Tensor:
    """Compensated generation from given draws.

    ``heads``/``readout``: the (masked) CRVAE decoder heads and readout;
    ``dec``/``out``: the ErrorVAE decoder and readout; ``h0_err`` (B, H_err)
    the ErrorVAE's initial state, ``h0`` (B, H) the rollout's.  One K2
    launch then one K1 launch, in the weights' storage type (all float32,
    or all bfloat16 for the kernels' bf16 instantiations).  Returns (B,
    steps, p) float32, steps defaulting to ``model.rollout_len``.
    """
    steps = model.rollout_len if steps is None else steps
    b = h0.shape[0]
    dev = heads.w_ih.device
    errs = errvae_sample_fused(dec, out, h0_err.to(dev), err_model.d, steps)
    # ErrorVAE.sample keeps a leading zero step; slice to the rollout
    # length exactly as the reference does.
    noise = torch.cat([torch.zeros((b, 1, err_model.d), device=dev), errs],
                      dim=1)[:, :steps]
    return crvae_free_run_fused(heads, readout,
                                torch.zeros((b, model.p), device=dev),
                                h0.to(dev), noise, model.noise_scale)


def generate_with_compensation(model: CRVAE, err_model: ErrorVAE,
                               params: CRVAEParams, err_params: ErrorVAEParams,
                               generator: torch.Generator, batch: int,
                               parents: Optional[torch.Tensor] = None,
                               dtype=None, kernel: str = "lax") -> torch.Tensor:
    """Phase-2 sampling.  Returns (B, rollout_len, p).

    Draws the ErrorVAE's h0 first and the rollout's h0 second from
    ``generator``, the order of the reference's key split, then runs
    ``generate_from_draws``.

    ``kernel`` keeps the reference's signature; its lax/fused crossover was
    measured on a TPU and does not carry over, so every value runs the
    rollout kernels (on a CUDA tensor) or their plain versions (on a CPU
    tensor).  ``dtype``: the serving precision; with bfloat16 (JAX's
    ``dtype=jnp.bfloat16``) the four weight groups are cast to bf16 and
    both rollouts take the kernels' bf16 instantiations (on the card too:
    JAX's fused path is float32 only, the port's every path is fused).
    """
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    groups = _serving_groups(params, err_params, parents, dtype)
    h0_err, h0 = _generation_draws(model, err_model, generator, batch)
    return generate_from_draws(model, err_model, *groups, h0_err, h0)


def _serving_groups(params: CRVAEParams, err_params: ErrorVAEParams,
                    parents: Optional[torch.Tensor], dtype) -> tuple:
    """(masked heads, readout, ErrorVAE decoder, readout), cast to the
    serving precision ``dtype``."""
    dt = serve_dtype(dtype)
    heads = params.heads if parents is None else masked_heads(params.heads, parents)
    groups = (heads, params.readout, err_params.dec, err_params.out)
    if dt != torch.float32:
        groups = tuple(cast_weights(g, dt) for g in groups)
    return groups


def _generation_draws(model: CRVAE, err_model: ErrorVAE,
                      generator: torch.Generator, batch: int):
    """(h0_err (B, H_err), h0 (B, H)), drawn in that order."""
    h0_err = torch.randn((batch, err_model.hidden), generator=generator,
                         device=generator.device)
    h0 = torch.randn((batch, model.hidden), generator=generator,
                     device=generator.device)
    return h0_err, h0
