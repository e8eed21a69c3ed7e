"""One-call Granger-causal discovery on user-supplied time series (port of
``vae_connexe_tpu/discover.py``, the crvae family).

``discover`` runs the pipeline a user wants on an arbitrary ``(T, p)`` or
``(N, T, p)`` array: phase-1 sparse structure learning, thresholding and,
optionally, phase-2 generator training on the selected graph:

    from vae_connexe_torch import discover
    result = discover(my_series, context=20, max_iter=2000)
    result.gc            # (p, p) binary causal graph (row i <- column j)
    result.scores        # continuous edge strengths
    result.threshold     # the resolved binarisation threshold

With ``seeds > 1`` the selection is stability selection over a multi-seed
sweep (``parallel.sweep_phase1``: the seeds folded into the recurrence
kernels' heads, one S-head encoder and one S * p-head decoder launch a
step).  ``generate > 0`` continues to phase 2: a fresh CRVAE constrained to
the selected graph and the error-compensation VAE, then compensated
samples.  On the card every recurrence is a B1/B2 launch and the
generation one B5 and one B4 launch.

``family="win"`` discovers with the explicit per-head W_in matrices
(``models/crvae_win.py``) and the two-stage trainer, row-group or
element-wise sparsity (``prox``); with ``seeds > 1`` every init, seed 0
included, trains in one ``WInTrainer.fit_many`` (the seeds folded into
the kernels' heads), and ``generate`` conditions the W_in rollout on the
series' windows, tiled.

The draws: seed s's generators come from ``parallel.seed_generators(s)``
(init, run; phase 2's inits and run; generation), so a sweep's seed s
trains as ``discover(seed=s)`` does with one seed.  The win family's
seeds follow ``utils/seeding.py::seed_stack_generators`` from ``seed``
(index 0 the run's own init and run generators), its generation the run
role at offset 1.  ``mesh=`` (``parallel/mesh.py``; this process is one
rank) follows the JAX package's rules: for the crvae family it shards the
single fit (batch over dp, heads over ep), the multi-seed sweep (seeds
over dp) and phase 2; for the win family the stability seeds over dp,
and it needs seeds > 1.  Every rank returns the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.data.windows import arrange_input
from vae_connexe_torch.evals.gc_metrics import (
    auto_threshold,
    stability_selection,
    vote_confidence,
)
from vae_connexe_torch.models.crvae import CRVAE
from vae_connexe_torch.models.error_vae import ErrorVAE
from vae_connexe_torch.parallel.seed_sweep import seed_generators, sweep_phase1
from vae_connexe_torch.train.config import Phase1Config, Phase2Config
from vae_connexe_torch.train.crvae_trainer import (
    fit_phase1,
    fit_phase2,
    generate_with_compensation,
)
from vae_connexe_torch.utils.scalers import standardize as _standardize


@dataclasses.dataclass
class DiscoveryResult:
    """Everything the discovery pipeline learned.

    ``scores`` and ``gc`` are oriented row i <- column j ("column j
    Granger-causes row i"), as ``CRVAE.gc``.
    """

    scores: np.ndarray                 # (p, p) continuous edge strengths
    gc: np.ndarray                     # (p, p) binary selected graph
    threshold: float                   # resolved score (or vote) threshold
    votes: Optional[np.ndarray]        # (p, p) vote fractions, seeds > 1
    seed_scores: Optional[np.ndarray]  # (S, p, p) per-seed scores, seeds > 1
    params: object                     # phase-1 CRVAEParams (one seed) or
                                       # phase 2's best (generate > 0)
    model: object                      # the CRVAE
    names: Optional[list]              # variable names (CSV header), if any
    metrics: dict                      # final training metrics
    samples: Optional[np.ndarray] = None   # (B, rollout_len, p), generate > 0
    err_params: object = None          # trained ErrorVAE params, generate > 0
    # Seeds > 1 only: the fraction of candidate edges the seed ensemble
    # rules out (``evals.vote_confidence``); low (< 0.5) means a dense graph
    # the estimator could not discriminate: treat it as exploratory.
    confidence: Optional[float] = None

    def edges(self, min_score: float = 0.0):
        """Selected edges as (cause, effect, score) triples, strongest
        first; names resolve to the CSV header when there is one."""
        out = []
        p = self.gc.shape[0]
        label = (lambda i: self.names[i]) if self.names else (lambda i: i)
        for i in range(p):
            for j in range(p):
                if self.gc[i, j] and self.scores[i, j] >= min_score:
                    out.append((label(j), label(i), float(self.scores[i, j])))
        return sorted(out, key=lambda e: -e[2])


def _pool_windows(series: torch.Tensor, context: int) -> torch.Tensor:
    """Windows of a (T, p) series, or of each series of an (N, T, p) stack,
    pooled in order."""
    if series.ndim == 2:
        return arrange_input(series, context)[0]
    return torch.cat([arrange_input(s, context)[0] for s in series])


def _preprocess(series, context: int, diff: bool, standardize: bool,
                names: Optional[list], device) -> torch.Tensor:
    """The series as float32 on ``device``, in the reference's order: a
    1-D series becomes one column, first differences along time (``diff``),
    the length check, the names check, then each variable z-scored over
    time (``standardize``)."""
    series = torch.tensor(np.asarray(series, np.float32), device=device)
    if series.ndim == 1:
        series = series[:, None]
    if series.ndim not in (2, 3):
        raise ValueError(
            f"series must be (T, p) or (N, T, p), got {tuple(series.shape)}")
    t_axis = 0 if series.ndim == 2 else 1
    if diff:
        series = torch.diff(series, dim=t_axis)
    if series.shape[t_axis] <= context + 1:
        raise ValueError(
            f"series has {series.shape[t_axis]} time steps but context="
            f"{context} — need T > context + 1 to form at least one "
            "training window")
    if names is not None and len(names) != series.shape[-1]:
        raise ValueError(f"{len(names)} names for {series.shape[-1]} "
                         "variables")
    if standardize:
        series = _standardize(series, axis=t_axis)
    return series


def stability_summary(seed_scores: np.ndarray, min_frac):
    """The seeds' vote: (votes, selected graph, resolved vote threshold,
    the seed-median scores), as numpy.  The median averages the two middle
    seeds at an even count, as ``jnp.median`` does."""
    votes, selected, thr = stability_selection(torch.as_tensor(seed_scores),
                                               min_frac=min_frac)
    return (votes.numpy(), selected.numpy(), thr,
            np.median(seed_scores, axis=0))


def discover(series, *, context: int = 20, hidden: int = 64,
             enc_len: Optional[int] = None,
             lam: float = 0.1, lr: Optional[float] = None, beta: float = 0.1,
             max_iter: int = 2000, batch_size: int = 256,
             seeds: int = 1, seed: int = 0,
             threshold: float | str = "auto",
             min_frac: float | str = "auto",
             standardize: bool = True,
             diff: bool = False,
             latent_reg: str = "kl",
             family: str = "crvae",
             prox: Optional[str] = None,
             latent: int = 32,
             generate: int = 0,
             phase2_iters: Optional[int] = None,
             names: Optional[list] = None,
             mesh=None, verbose: bool = False,
             log_fn=print, device=None) -> DiscoveryResult:
    """Granger-causal discovery (and optionally a generator) on a series.

    Args as the JAX package's ``discover``:
      series: (T, p) array, rows are time steps, or an (N, T, p) stack of
        realisations; anything ``np.asarray`` accepts.
      context: lag-window length; enc_len: steps the encoder reads from
        each window (default ``context // 2``); the decoder predicts the
        rest.
      lam: group-lasso strength, larger = sparser; lr default 5e-2.
      seeds: > 1 trains a multi-seed sweep and selects edges by stability
        voting; seed: the first seed.
      threshold: score threshold for one seed, a float or "auto" (largest
        log gap, ``evals.auto_threshold``); min_frac: vote fraction for
        seeds > 1, a float in [0, 1] or "auto" (largest vote gap, clamped
        to [0.5, 0.95]).
      standardize: z-score each variable over time first; diff: first
        differences along time before that.
      generate: > 0 trains phase 2 on the selected graph (``phase2_iters``
        steps, default ``max_iter``) and draws this many samples.
      device: where it runs (default ``cuda``; ``"cpu"`` runs the plain
        versions of the kernels).

    For ``family="win"``, ``max_iter`` counts stage-I epochs (stage II
    runs ``phase2_iters`` or half that), ``enc_len`` is the tau split of
    the 2 tau window, ``prox`` the sparsity groups ("row", the default, or
    "element"), ``latent`` the latent width, ``lr`` defaults to the W_in
    trainer's, and ``generate`` conditions the rollout on the first
    windows of the series.  ``mesh``: a (dp, ep) mesh of the port
    (module doc).
    """
    if family not in ("crvae", "win"):
        raise ValueError(f"family must be 'crvae' or 'win', got {family!r}")
    if prox is not None and family != "win":
        raise ValueError(
            "prox= selects the win family's group convention; the crvae "
            "family is always column-grouped (author_CRVAE.py:314) — pass "
            "family='win' to use row/element groups")
    if mesh is not None:
        from vae_connexe_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    dev = resolve_device(device)
    series = _preprocess(series, context, diff, standardize, names, dev)
    p = series.shape[-1]
    if enc_len is None:
        enc_len = max(1, context // 2)
    if not 0 < enc_len < context:
        raise ValueError(f"enc_len={enc_len} must be in (0, context={context})")
    if family == "win":
        if mesh is not None and seeds <= 1:
            raise ValueError(
                "mesh= for the win family shards the SEED axis of the "
                "stability sweep over dp (there is no sharded single-fit "
                "path for the win trainer) — pass seeds > 1, or use "
                "family='crvae' whose single fit shards its batch over dp")
        return _discover_win(series, names=names, tau=enc_len, hidden=hidden,
                             latent=latent, lam=lam, lr=lr,
                             prox=prox or "row", max_iter=max_iter,
                             batch_size=batch_size, seeds=seeds, seed=seed,
                             threshold=threshold, min_frac=min_frac,
                             generate=generate, phase2_iters=phase2_iters,
                             mesh=mesh, verbose=verbose, log_fn=log_fn,
                             device=dev)
    if lr is None:
        lr = 5e-2

    windows = _pool_windows(series, context)
    model = CRVAE(p=p, hidden=hidden, enc_len=enc_len)
    full = torch.ones((p, p), device=dev)
    cfg = Phase1Config(lam=lam, lr=lr, beta=beta, max_iter=max_iter,
                       batch_size=batch_size, latent_reg=latent_reg)
    gens = seed_generators(seed, dev)

    votes = seed_scores = best = None
    if seeds > 1:
        # Phase 2 re-initialises from the selected mask alone, so the sweep
        # needs no separate single fit.
        out = sweep_phase1(model, windows, full, cfg,
                           range(seed, seed + seeds), mesh=mesh)
        seed_scores = out["gc_scores"].cpu().numpy()
        votes, gc, thr, scores = stability_summary(seed_scores, min_frac)
        metrics = {"mean_loss": float(out["mean_loss"].mean()),
                   "best_loss": float(out["best_loss"].min())}
    else:
        best, _, metrics = fit_phase1(model, model.init(gens["init"], dev),
                                      windows, full, cfg, gens["run"],
                                      verbose=verbose, log_fn=log_fn,
                                      mesh=mesh)
        scores_t = model.gc(best, threshold=False)
        thr = (float(auto_threshold(scores_t)) if threshold == "auto"
               else float(threshold))
        scores = scores_t.cpu().numpy()
        gc = (scores_t > thr).to(torch.int32).cpu().numpy()

    result = DiscoveryResult(
        scores=np.asarray(scores), gc=gc, threshold=float(thr), votes=votes,
        seed_scores=seed_scores, params=best, model=model, names=names,
        metrics={k: float(v) for k, v in metrics.items()},
        confidence=(vote_confidence(votes) if votes is not None else None))

    if generate > 0:
        mask = torch.as_tensor(gc, dtype=torch.float32, device=dev)
        if not gc.any():
            raise ValueError(
                "phase 2 requested but the selected graph is empty — lower "
                "lam or the threshold (every head would have zero parents)")
        err_model = ErrorVAE(d=p, hidden=hidden)
        cfg2 = Phase2Config(lr=lr, batch_size=batch_size,
                            max_iter=phase2_iters or max_iter,
                            latent_reg=latent_reg)
        p2_best, err_params, _, m2 = fit_phase2(
            model, err_model, model.init(gens["p2_init"], dev),
            err_model.init(gens["err_init"], dev), windows, mask, cfg2,
            gens["p2_run"], verbose=verbose, log_fn=log_fn, mesh=mesh)
        samples = generate_with_compensation(model, err_model, p2_best,
                                             err_params, gens["gen"],
                                             generate, parents=mask)
        result.samples = samples.cpu().numpy()
        result.err_params = err_params
        result.params = p2_best
        result.metrics.update({f"phase2_{k}": float(v) for k, v in m2.items()})

    return result


def _discover_win(series, *, names, tau, hidden, latent, lam, lr, prox,
                  max_iter, batch_size, seeds, seed, threshold, min_frac,
                  generate, phase2_iters, mesh, verbose, log_fn, device):
    """The win-family discovery path: explicit per-head W_in matrices with
    row-group or element-wise proximal sparsity, trained by the two-stage
    ISTA/Adam trainer.  ``max_iter`` counts stage-I epochs; stage II runs
    ``phase2_iters`` epochs, default half of stage I.  With ``seeds > 1``
    every init, seed 0 included, trains in one ``fit_many``."""
    from vae_connexe_torch.data.windows import sliding_windows
    from vae_connexe_torch.models.crvae_win import WInCRVAE
    from vae_connexe_torch.parallel.seed_sweep import SEED_ROLES, _CPU_ROLES
    from vae_connexe_torch.train.config import WInTrainConfig
    from vae_connexe_torch.train.win_trainer import WInTrainer
    from vae_connexe_torch.utils.seeding import (
        role_generators,
        seed_stack_generators,
    )
    from vae_connexe_torch.utils.tree import stack_trees, unstack_tree

    p = series.shape[-1]
    if series.ndim == 2:
        windows = sliding_windows(series, 2 * tau)
    else:
        windows = torch.cat([sliding_windows(s, 2 * tau) for s in series])
    stage2 = phase2_iters if phase2_iters is not None else max(1, max_iter // 2)
    cfg = WInTrainConfig(lam=lam, prox_groups=prox, batch_size=batch_size,
                         stage1_epochs=max_iter, stage2_epochs=stage2,
                         **({} if lr is None else {"lr": lr}))
    model = WInCRVAE(d=p, hidden=hidden, latent=latent, tau=tau)
    trainer = WInTrainer(model, cfg)
    inits, runs = seed_stack_generators(seed, range(max(seeds, 1)),
                                        SEED_ROLES, _CPU_ROLES, device)

    votes = seed_scores = None
    if seeds > 1:
        # Stage II refines the error head on the frozen support and cannot
        # move the W_in scores unless update_w_in_stage2: the sweep skips
        # it unless the generator (seed 0's params) needs it.
        e2 = stage2 if (generate > 0 or cfg.update_w_in_stage2) else 0
        p_stack = stack_trees([model.init(g, device) for g in inits])
        p_stack, m_many = trainer.fit_many(p_stack, windows, runs,
                                           stage2_epochs=e2, mesh=mesh)
        seed_scores = model.granger_matrix(p_stack,
                                           threshold=False).cpu().numpy()
        votes, gc, thr, scores = stability_summary(seed_scores, min_frac)
        params = unstack_tree(p_stack, 0)
        metrics = {k: float(v[0]) for k, v in m_many.items()}
    else:
        params, metrics = trainer.fit(model.init(inits[0], device), windows,
                                      runs[0], verbose=verbose, log_fn=log_fn)
        scores_t = model.granger_matrix(params, threshold=False)
        thr = (float(auto_threshold(scores_t)) if threshold == "auto"
               else float(threshold))
        scores = scores_t.cpu().numpy()
        gc = (scores_t > thr).to(torch.int32).cpu().numpy()

    result = DiscoveryResult(
        scores=np.asarray(scores), gc=gc, threshold=float(thr), votes=votes,
        seed_scores=seed_scores, params=params, model=model, names=names,
        metrics={k: float(v) for k, v in metrics.items()},
        confidence=(vote_confidence(votes) if votes is not None else None))

    if generate > 0:
        # Condition the rollout on real context windows, tiled.
        g_gen = role_generators(seed, SEED_ROLES, _CPU_ROLES, device, 1)["run"]
        reps = -(-generate // windows.shape[0])
        ctx = windows.repeat(reps, 1, 1)[:generate]
        with torch.no_grad():
            result.samples = model.generate(params, ctx, g_gen,
                                            2 * tau).cpu().numpy()
    return result
