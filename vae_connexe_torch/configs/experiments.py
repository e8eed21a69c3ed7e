"""The reference's experiment scripts as data, and the runner (port of
``vae_connexe_tpu/configs/experiments.py``).

``EXPERIMENTS`` is the JAX package's table, copied field for field (the
comments cite each entry's source).  ``run_experiment`` runs every family
of it: crvae (phase 1, the GC scores and metrics, phase 2 under the
binary mask, compensated and conditioned generation; with
``latent_reg='cs'`` both phases against a GMM prior), win (the two-stage
W_in trainer, prediction MSE, the GC rows, stability selection over seeds
folded into the kernels' heads, conditioned generation), csrae (the
MixtureCSRAE on binarised windows) and vrae (the plain VRAE on random
sequences), on the ``lorenz96``, ``henon``, ``coupled_henon``, ``var``
and ``random`` datasets, with the reference's ``.npy``, checkpoint, log,
metrics and figure files; with ``out_of_core`` (crvae family) both phases
stream their batches from the native window loader; with ``mesh`` (crvae
family) both phases train sharded over a mesh of ranks
(``parallel/mesh.py``), rank 0 writing the files.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, Optional

import numpy as np
import torch

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.utils.seeding import role_generators
from vae_connexe_torch.train.config import (
    CSRAETrainConfig,
    Phase1Config,
    Phase2Config,
    WInTrainConfig,
)


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str
    model_family: str              # 'crvae' | 'win' | 'vrae' | 'csrae'
    dataset: str                   # 'lorenz96' | 'henon' | 'coupled_henon' | 'var' | 'random'
    p: int = 10
    t: int = 2048
    context: int = 20
    hidden: int = 64
    latent: int = 32
    tau: int = 10                  # W_in-variant past/current split
    gc_threshold: float = 0.0
    phase1: Phase1Config = Phase1Config()
    phase2: Phase2Config = Phase2Config()
    win: WInTrainConfig = WInTrainConfig()
    csrae: CSRAETrainConfig = CSRAETrainConfig()
    stability_seeds: int = 0
    notes: str = ""


EXPERIMENTS: dict[str, Experiment] = {
    # CRVAE_lorenz96.py:737-743 (p=10, T=2048), :772-774 (λ=.1, lr=5e-2,
    # 5000 it), :458 (batch 256), :792-794 (phase 2, 10000 it).
    "lorenz96_crvae": Experiment(
        name="lorenz96_crvae", model_family="crvae", dataset="lorenz96",
        p=10, t=2048, context=20, hidden=64,
        phase1=Phase1Config(lam=0.1, lr=5e-2, max_iter=5000, batch_size=256),
        phase2=Phase2Config(lr=5e-2, max_iter=10000, batch_size=256),
        notes="canonical reference workload"),
    # Same workload with λ=0.2: a measured improvement over the reference
    # literal (binary F1 0.95 vs 0.87 at unchanged AUROC 1.0 — RESULTS.md
    # λ-sweep).  lorenz96_crvae stays at the reference λ=0.1 for parity;
    # this is the recommended config for actual use.
    "lorenz96_crvae_tuned": Experiment(
        name="lorenz96_crvae_tuned", model_family="crvae", dataset="lorenz96",
        p=10, t=2048, context=20, hidden=64,
        phase1=Phase1Config(lam=0.2, lr=5e-2, max_iter=5000, batch_size=256),
        phase2=Phase2Config(lr=5e-2, max_iter=10000, batch_size=256),
        notes="recommended: tuned group-lasso weight"),
    # author_CRVAE.py:728 (1000-step 2-D Hénon), :751-753 (λ=.1, 1000 it).
    "henon_author": Experiment(
        name="henon_author", model_family="crvae", dataset="henon",
        p=2, t=1000, context=20, hidden=64,
        phase1=Phase1Config(lam=0.1, lr=5e-2, max_iter=1000, batch_size=256),
        phase2=Phase2Config(lr=5e-2, max_iter=10000, batch_size=256)),
    # CRVAE.py:205 (T=3000 D=6), :242-243 (H=64 Z=32 τ=10, λ=.03 lr=2e-3),
    # :247,261 (2000 + 1000 epochs, bs=256).
    "henon6d_win": Experiment(
        name="henon6d_win", model_family="win", dataset="coupled_henon",
        p=6, t=3000, context=20, hidden=64, latent=32, tau=10,
        gc_threshold=1e-6,
        win=WInTrainConfig(lr=2e-3, lam=0.03, prox_groups="row",
                           batch_size=256, stage1_epochs=2000,
                           stage2_epochs=1000),
        stability_seeds=8),
    # CR-VAE.py:360-364 (D=5 H=64 Z=16 τ=10), :397 (500 seqs), :422
    # (λ=.02, lr_prox=.01, 100 epochs), element-wise prox (:126-128).
    "var_crvae": Experiment(
        name="var_crvae", model_family="win", dataset="var",
        p=5, t=30, context=20, hidden=64, latent=16, tau=10,
        gc_threshold=0.1,
        # The reference's CR-VAE.py excludes W_in from Adam AND its
        # "proximal" step is shrink-only (``CR-VAE.py:122-128,264-272``
        # never applies W_in's gradient) — a notebook artifact under which
        # W_in can only decay.  This build normalizes to a true ISTA
        # (gradient step + shrink, SURVEY.md §7); at the reference's
        # lr_prox=1e-2 that over-prunes, so the prox rides the Adam lr here
        # (lr_prox stays available for parity sweeps).
        win=WInTrainConfig(lr=1e-3, lam=0.02, prox_groups="element",
                           batch_size=16, stage1_epochs=100, stage2_epochs=30,
                           update_w_in_stage2=True),
        stability_seeds=8),
    # CR-CS-RAE.py:888 (λ=.5), :898-900 (2000 it), :899 (K=10, λ_cs=.1),
    # :531 (batch 2048), :660 (phase-2 batch 1024), :944-946 (10000 it).
    "lorenz96_crcsrae": Experiment(
        name="lorenz96_crcsrae", model_family="crvae", dataset="lorenz96",
        p=10, t=2048, context=20, hidden=64,
        phase1=Phase1Config(lam=0.5, lr=5e-2, max_iter=2000, batch_size=2048,
                            latent_reg="cs", lambda_cs=0.1, gmm_components=10),
        # Phase 2 keeps the CS regularizer on the main model and standard KL
        # on the error VAE (``CR-CS-RAE.py:698-747``).
        phase2=Phase2Config(lr=5e-2, max_iter=10000, batch_size=1024,
                            latent_reg="cs", lambda_cs=0.1,
                            gmm_components=10)),
    # VRAE.py:189-199: random (32, 20, 10) data, tanh head, β=0.5,
    # exponential teacher-forcing decay 0.02, 100 epochs.
    "vrae_demo": Experiment(
        name="vrae_demo", model_family="vrae", dataset="random",
        p=10, t=20, hidden=64, latent=32),
    # BASELINE.json configs[4]: scaled long-horizon Lorenz-96 (p=40/128).
    "lorenz96_scaled": Experiment(
        name="lorenz96_scaled", model_family="crvae", dataset="lorenz96",
        p=40, t=4096, context=40, hidden=128,
        phase1=Phase1Config(lam=0.1, lr=5e-2, max_iter=5000, batch_size=512),
        phase2=Phase2Config(lr=5e-2, max_iter=5000, batch_size=512),
        notes="long-horizon scale-out config"),
    # Long-horizon windows: T_dec = 118 > UNROLL_MAX_T exercises the fused
    # Pallas recurrence inside training (SURVEY.md §5 "long-context").
    "lorenz96_longhorizon": Experiment(
        name="lorenz96_longhorizon", model_family="crvae", dataset="lorenz96",
        p=10, t=4096, context=128, hidden=64,
        phase1=Phase1Config(lam=0.1, lr=5e-2, max_iter=2000, batch_size=128),
        phase2=Phase2Config(lr=5e-2, max_iter=2000, batch_size=128),
        notes="long-horizon windows (fused-kernel decode path)"),
    # CS-RAE.py:115-155 model + loss contract (MLP 400, latent 20, K=10);
    # the reference ships no script for it, so the dataset is this build's:
    # binarized Lorenz-96 windows flattened to (N, ctx·p) Bernoulli vectors
    # — structured enough for the GMM prior to have something to learn.
    "csrae_binarized": Experiment(
        name="csrae_binarized", model_family="csrae", dataset="lorenz96",
        p=10, t=2048, context=20,
        csrae=CSRAETrainConfig(hidden_dims=(400,), latent_dim=20, k=10,
                               lambda_cs=1.0, epochs=30, batch_size=128,
                               lr=1e-3),
        notes="MixtureCSRAE on binarized Lorenz-96 windows"),
    "lorenz96_xl": Experiment(
        name="lorenz96_xl", model_family="crvae", dataset="lorenz96",
        p=128, t=8192, context=40, hidden=128,
        # Smaller batch: the decoder's saved activations scale with
        # p * B * T_dec * 3H (~400MB at B=64) and the backward doubles it.
        phase1=Phase1Config(lam=0.1, lr=5e-2, max_iter=3000, batch_size=64),
        phase2=Phase2Config(lr=5e-2, max_iter=3000, batch_size=64),
        notes="extreme-scale config (p=128)"),
}


# The generators of one run, in this fixed order, each seeded from one draw
# of a CPU generator seeded with the run's seed (the counterpart of the
# reference's ``k_data, k_init, k_run, k_p2, k_gen`` split).
ROLES = ("data", "init", "run", "p2", "gen")


def get_experiment(name: str) -> Experiment:
    if name not in EXPERIMENTS:
        raise KeyError(f"unknown experiment {name!r}; "
                       f"available: {sorted(EXPERIMENTS)}")
    return EXPERIMENTS[name]


def _sweep(truth, scores) -> dict[str, dict[str, float]]:
    """Accuracy and sparsity of the binarised estimate across the
    reference's threshold grid."""
    from vae_connexe_torch.evals import threshold_sweep

    thrs = torch.tensor([0.0, 0.01, 0.05, 0.1, 0.2, 0.5], device=scores.device)
    acc, sparsity = threshold_sweep(truth, scores, thrs)
    return {f"{float(t):g}": {"accuracy": float(a), "sparsity": float(s)}
            for t, a, s in zip(thrs, acc, sparsity)}


def _make_dataset(exp: Experiment, generator: torch.Generator, device=None):
    """(series on ``device``, truth (p, p) int32 or None) of the
    experiment, the series' draws from ``generator``: (t, p), or (500, t,
    p) independent sequences for ``var``, or (32, t, p) standard normals
    with no truth for ``random``."""
    from vae_connexe_torch import data as D

    dev = resolve_device(device)
    if exp.dataset == "lorenz96":
        return (D.lorenz96(generator, p=exp.p, t=exp.t, device=dev),
                D.lorenz96_truth(exp.p, dev))
    if exp.dataset == "henon":
        return D.henon_chain(t=exp.t, device=dev), D.henon_truth(exp.p, dev)
    if exp.dataset == "coupled_henon":
        return (D.coupled_henon(generator, t=exp.t, d=exp.p, device=dev),
                D.coupled_henon_truth(exp.p, device=dev))
    if exp.dataset == "var":
        a = D.var_truth(exp.p, dev)
        return (D.var_process(generator, a, n=500, t=exp.t),
                (a > 0).to(torch.int32))
    if exp.dataset == "random":
        return torch.randn((32, exp.t, exp.p), generator=generator,
                           device=generator.device).to(dev), None
    raise ValueError(f"unknown dataset {exp.dataset!r}")


def make_csrae_inputs(exp: Experiment, series: torch.Tensor):
    """Binarised flattened windows and the configured MixtureCSRAE.

    Shared by ``run_experiment`` and ``cli eval``, so the model at eval
    time is built as the checkpoint's was: windows of ``exp.context``
    flattened to (N, context * p) and binarised at 0 (the series is
    standardised per variable, so the split is balanced), Bernoulli data
    for the BCE-with-logits decoder.
    """
    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.models import MixtureCSRAE

    windows, _ = arrange_input(series, exp.context)
    x = (windows.reshape(windows.shape[0], -1) > 0).to(torch.float32)
    cfgc = exp.csrae
    model = MixtureCSRAE(input_dim=x.shape[-1], hidden_dims=cfgc.hidden_dims,
                         latent_dim=cfgc.latent_dim, k=cfgc.k,
                         lambda_cs=cfgc.lambda_cs, cs_variant=cfgc.cs_variant)
    return x, model


def csrae_eval_metrics(model, params, x: torch.Tensor,
                       generator: torch.Generator) -> dict:
    """Reconstruction accuracy and the loss's parts on the first 512 rows,
    the forward and the loss on one epsilon drawn from ``generator``."""
    rows = x[:512]
    eps = torch.randn((rows.shape[0], model.latent_dim), generator=generator,
                      device=generator.device).to(x.device)
    with torch.no_grad():
        logits, _, _ = model.forward(params, rows, eps)
        total, bce, cs = model.loss(params, rows, eps)
    return {
        "recon_accuracy": float(((logits > 0).to(torch.float32) == rows)
                                .to(torch.float32).mean()),
        "loss": {"total": float(total), "bce": float(bce), "cs": float(cs)},
    }


def _floats(d: dict) -> dict[str, float]:
    return {k: float(v) for k, v in d.items()}


def _gap(mm: dict) -> dict[str, float]:
    return {"mean_abs_gap": float(mm["mean_abs_gap"].mean()),
            "std_abs_gap": float(mm["std_abs_gap"].mean())}


def run_experiment(name: str, seed: int = 0, out_dir: str | None = None,
                   overrides: Optional[dict[str, Any]] = None,
                   run_phase2: bool = True, verbose: bool = True,
                   save_checkpoints: bool = False,
                   artifacts_every: int | None = None,
                   mesh=None,
                   out_of_core: bool = False,
                   checkpoint_every: int | None = None,
                   resume: bool = False,
                   log_fn=print, device=None) -> dict[str, Any]:
    """Run a named experiment end to end on ``device`` (default ``cuda``);
    returns the metrics dict, with the reference's keys.

    ``save_checkpoints=True`` (requires ``out_dir``) writes, for the crvae
    family, ``ckpt_phase1`` with the binary GC matrix beside it
    (``ckpt_phase1.gc.npy``, the two-phase handoff) and ``ckpt_phase2``
    (``{"crvae", "error_vae"}``); for the win family ``ckpt_win`` with its
    ``.gc.npy``.  ``checkpoint_every=N`` (crvae family; requires
    ``out_dir``) snapshots the running phase's whole state every N steps
    under ``out_dir/ckpt_mid_phase{1,2}``; ``resume=True`` restores the
    latest snapshot and continues, bitwise equal to the uninterrupted run
    (a finished phase is a pure restore).  ``artifacts_every=N`` (crvae
    family; requires ``out_dir``) draws a compensated sample at the first
    phase-2 chunk at or after each period and saves
    ``syn_<name>_it<step>.npy`` with its PCA and trajectory figures.

    ``mesh`` (a port mesh, ``parallel/mesh.py::make_mesh``; crvae family;
    this process is one rank of it) trains both phases sharded: batch over
    dp, decoder heads over ep, the time axis over sp when the mesh has it
    (``fit_phase1``/``fit_phase2``); every rank runs the same experiment
    from the same seed and returns the same metrics, rank 0 writes the
    files.  Composes with ``out_of_core``, ``checkpoint_every`` and
    ``resume``.

    With ``out_dir`` the run writes the reference's files: for the crvae
    family ``GC_<name>.npy``, ``GC_scores_<name>.npy``, ``syn_<name>.npy``,
    ``syn_cond_<name>.npy``, ``train_log_<name>.jsonl`` (one record a
    chunk, both phases) and the figures ``gc_heatmap_``,
    ``gc_heatmap_auto_``, ``pca_``, ``tsne_``, ``traj_``, ``pca_cond_``,
    ``tsne_cond_``; for the win family ``GC_scores_<name>.npy``,
    ``syn_<name>.npy`` and the figures ``w_in_``, ``w_in_norms_``,
    ``gc_heatmap_``; for the csrae family ``syn_<name>.npy`` and the
    figures ``pca_``, ``tsne_`` (with ``save_checkpoints``,
    ``ckpt_csrae``); for the vrae family ``syn_<name>.npy`` (and
    ``ckpt_vrae``); and ``metrics_<name>.json``.  Where matplotlib or
    scikit-learn cannot be imported the figures are skipped and named on
    one stderr line (``evals/viz.py::FigureWriter``).

    ``out_of_core=True`` (crvae family) writes the series to a raw float32
    file (``series_<name>.f32`` under ``out_dir``), memory-maps it with the
    native window loader and trains both phases through the streaming fits
    (``train/streaming.py``), bit for bit the in-memory run; the eval
    surfaces read the first ``min(4096, n)`` windows.  It composes with
    ``checkpoint_every`` and ``resume``.

    The draws (``utils/seeding.py::role_generators``): one CPU generator
    seeded with ``seed`` draws one seed per role of ``ROLES`` in that
    order.  ``data`` (on the device) makes the series; ``init`` (CPU) the
    first model, seed + 1 the phase-2 CRVAE and seed + 2 the ErrorVAE (the
    reference's ``fold_in(k_init, 1)`` and ``fold_in(k_init, 2)``); ``run``
    and ``p2`` (on the device) are the fits' generators; ``gen`` (on the
    device) draws the generations (the crvae family's conditioned one
    from seed + 1, its periodic samples from seed + step).  The win
    family's stability seed s >= 1 trains from ``init`` at offset s and
    ``run`` at offset 100 + s (``utils/seeding.py::seed_stack_generators``)
    and its prediction MSE draws from ``run`` at offset 1.  The csrae
    family draws its initial loss's epsilon and then its fit from
    ``run``, and its eval metrics' epsilon and then its samples from
    ``gen``; the vrae family its fit from ``run`` and its samples from
    ``gen``.  A rerun with
    the same seed rebuilds the same generators, which is what resume
    relies on.
    """
    exp = get_experiment(name)
    if mesh is not None and exp.model_family != "crvae":
        raise ValueError(
            f"--mesh supports the crvae family (two-phase trainer); "
            f"{name!r} is {exp.model_family!r}")
    if mesh is not None:
        from vae_connexe_torch.parallel.mesh import check_mesh

        check_mesh(mesh)
    if out_of_core and exp.model_family != "crvae":
        raise ValueError(
            f"--out-of-core supports the crvae family (streaming trainers); "
            f"{name!r} is {exp.model_family!r}")
    if (checkpoint_every or resume) and exp.model_family != "crvae":
        raise ValueError(
            f"--checkpoint-every/--resume support the crvae family "
            f"(two-phase trainer); {name!r} is {exp.model_family!r}")
    if (checkpoint_every or resume) and not out_dir:
        raise ValueError("--checkpoint-every/--resume require --out-dir "
                         "(checkpoints live under it)")
    if overrides:
        exp = dataclasses.replace(exp, **overrides)
    runners = {"crvae": _run_crvae, "win": _run_win, "csrae": _run_csrae,
               "vrae": _run_vrae}
    if exp.model_family not in runners:
        raise ValueError(f"unknown model family {exp.model_family!r}")
    dev = resolve_device(device)

    def gens(offset=0):
        return role_generators(seed, ROLES, ("init",), dev, offset)

    series, truth = _make_dataset(exp, gens()["data"], dev)
    out = pathlib.Path(out_dir) if out_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    results: dict[str, Any] = {"experiment": name, "seed": seed}
    from vae_connexe_torch.evals.viz import FigureWriter

    figs = FigureWriter()
    runners[exp.model_family](
        exp, name, seed, series, truth, gens, dev, out, figs, results,
        run_phase2=run_phase2, verbose=verbose,
        save_checkpoints=save_checkpoints, artifacts_every=artifacts_every,
        checkpoint_every=checkpoint_every, resume=resume, log_fn=log_fn,
        **({"out_of_core": True} if out_of_core else {}),
        **({"mesh": mesh} if mesh is not None else {}))
    figs.report()
    from vae_connexe_torch.parallel.mesh import is_writer

    if out and is_writer(mesh):
        (out / f"metrics_{name}.json").write_text(json.dumps(results,
                                                             indent=2))
    return results


def gc_dynamics_rows(scores: torch.Tensor) -> dict[str, dict]:
    """``henon_author``'s corrected rows: the reference's 2-D Henon truth
    mislabels its own generator (``data/henon.py::henon_dynamics_truth``),
    so the scores are also held against the map's own graph, at the
    default threshold (``gc_dynamics``) and at the best accuracy on a
    64-point grid from 0 to the largest score
    (``gc_dynamics_best_threshold``)."""
    from vae_connexe_torch.data import henon_dynamics_truth
    from vae_connexe_torch.evals import gc_metrics

    dyn = henon_dynamics_truth(scores.device)
    grid = np.linspace(0.0, float(scores.max()), 64, dtype=np.float32)
    accs = [float(gc_metrics(dyn, scores, float(t))["accuracy"])
            for t in grid]
    best = float(grid[int(np.argmax(accs))])
    return {"gc_dynamics": _floats(gc_metrics(dyn, scores)),
            "gc_dynamics_best_threshold": {
                "threshold": best, **_floats(gc_metrics(dyn, scores, best))}}


def _run_crvae(exp, name, seed, series, truth, gens, dev, out, figs,
               results, *, out_of_core=False, mesh=None, **kw):
    """The crvae family's run (``run_experiment``), results into
    ``results``.  ``out_of_core``: the series is written to a raw float32
    file (``series_<name>.f32`` under ``out``, else in a temporary
    directory), memory-mapped by the native loader, and both phases stream
    their batches from it (``train/streaming.py``), bit for bit the
    in-memory run; the eval and figure surfaces read the first
    ``min(4096, n)`` windows (at the committed configs all of them)."""
    import contextlib
    import tempfile

    from vae_connexe_torch.data.native_loader import NativeWindowLoader

    with contextlib.ExitStack() as stack:
        loader = None
        if out_of_core:
            tmp = stack.enter_context(tempfile.TemporaryDirectory())
            from vae_connexe_torch.parallel.mesh import is_writer

            # On a mesh rank 0 writes under ``out``, the others their own
            # copy in a temporary directory.
            here = out if out and is_writer(mesh) else pathlib.Path(tmp)
            path = here / f"series_{name}.f32"
            series_np = np.ascontiguousarray(series.cpu().numpy(), np.float32)
            series_np.tofile(path)
            loader = stack.enter_context(NativeWindowLoader.from_file(
                str(path), *series_np.shape))
        _run_crvae_on(exp, name, seed, series, truth, gens, dev, out, figs,
                      results, loader, mesh=mesh, **kw)


def _run_crvae_on(exp, name, seed, series, truth, gens, dev, out, figs,
                  results, loader, *, run_phase2, verbose, save_checkpoints,
                  artifacts_every, checkpoint_every, resume, log_fn,
                  mesh=None):
    """``_run_crvae`` with the windows in memory (``loader`` None) or
    streamed from ``loader``.  On a ``mesh`` both phases train sharded;
    rank 0 writes the files (``writer``), every rank reads checkpoints
    under ``out``."""
    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.evals import auto_threshold, gc_metrics, moment_match
    from vae_connexe_torch.evals.viz import (
        gc_heatmaps,
        pca_comparison,
        trajectory_overlay,
        tsne_comparison,
    )
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.train import (
        fit_phase1,
        fit_phase1_streaming,
        fit_phase2,
        fit_phase2_streaming,
        generate_with_compensation,
    )
    from vae_connexe_torch.parallel.mesh import is_writer
    from vae_connexe_torch.train.crvae_trainer import _gathered
    from vae_connexe_torch.utils import JsonlWriter, save_checkpoint

    writer = out if is_writer(mesh) else None
    g = gens()
    model = CRVAE(p=exp.p, hidden=exp.hidden)
    params = model.init(g["init"], dev)
    full = torch.ones((exp.p, exp.p), device=dev)
    log_writer = (JsonlWriter(str(writer / f"train_log_{name}.jsonl"))
                  if writer else None)

    def log_phase(phase):
        if log_writer is None:
            return None
        return lambda step, state, metrics: log_writer.write(
            step, {"phase": phase, **metrics})

    def ckpt_kw(phase):
        if not (checkpoint_every or resume):
            return {}
        return {"checkpoint_dir": str(out / f"ckpt_mid_{phase}"),
                "checkpoint_every": checkpoint_every or 0, "resume": resume}

    if loader is None:
        windows, _ = arrange_input(series, exp.context)
        best, _, m1 = fit_phase1(model, params, windows, full, exp.phase1,
                                 g["run"], verbose=verbose, log_fn=log_fn,
                                 callback=log_phase("phase1"), mesh=mesh,
                                 **ckpt_kw("phase1"))
    else:
        best, _, m1 = fit_phase1_streaming(
            model, params, loader, exp.context, full, exp.phase1, g["run"],
            verbose=verbose, log_fn=log_fn, callback=log_phase("phase1"),
            mesh=mesh, **ckpt_kw("phase1"))
        n_eval = min(4096, loader.t - exp.context)
        windows = torch.from_numpy(loader.gather(
            np.arange(n_eval, dtype=np.int64), exp.context)).to(dev)
    scores = model.gc(best, threshold=False)
    gc_est = model.gc(best, threshold=True)
    results["phase1"] = m1
    results["gc"] = _floats(gc_metrics(truth, scores, exp.gc_threshold))
    thr_auto = float(auto_threshold(scores))
    results["gc_auto"] = {"threshold": thr_auto,
                          **_floats(gc_metrics(truth, scores, thr_auto))}
    results["threshold_sweep"] = _sweep(truth, scores)
    if exp.dataset == "henon" and exp.p == 2:
        results.update(gc_dynamics_rows(scores))
    if writer:
        np.save(writer / f"GC_{name}.npy", gc_est.cpu().numpy())
        np.save(writer / f"GC_scores_{name}.npy",
                scores.detach().cpu().numpy())
        truth_np = truth.cpu().numpy()
        figs.draw(gc_heatmaps, truth_np, gc_est.cpu().numpy(),
                  path=str(writer / f"gc_heatmap_{name}.png"))
        figs.draw(gc_heatmaps, truth_np, scores.cpu().numpy() > thr_auto,
                  path=str(writer / f"gc_heatmap_auto_{name}.png"))
    if save_checkpoints and writer:
        save_checkpoint(str(writer / "ckpt_phase1"), best, gc_matrix=gc_est)

    if run_phase2:
        mask = gc_est.to(torch.float32)
        p2_params = model.init(gens(1)["init"], dev)
        err_model = ErrorVAE(d=exp.p, hidden=exp.hidden)
        err_params = err_model.init(gens(2)["init"], dev)
        # Real and generated segments share T for the figures: the rollout
        # is rollout_len steps, windows give T - enc_len.
        t_cmp = min(model.rollout_len, windows.shape[1] - model.enc_len)
        ori = (windows[:256, model.enc_len:model.enc_len + t_cmp].cpu()
               .numpy() if out else None)
        callbacks = [log_phase("phase2")]
        if artifacts_every and out:
            fired = {"last": 0}

            def artifacts(step, state, metrics):
                # Once a chunk; fire on the first chunk at or after each
                # period, so artifacts_every need not divide check_every.
                if step - fired["last"] < artifacts_every:
                    return
                fired["last"] = step
                gen = generate_with_compensation(
                    model, err_model, _gathered(state.params, mesh),
                    state.err_params, gens(step)["gen"], 256, parents=mask)
                if writer is None:
                    return
                syn = gen[:, :t_cmp].cpu().numpy()
                np.save(writer / f"syn_{name}_it{step}.npy", syn)
                figs.draw(pca_comparison, ori, syn,
                          path=str(writer / f"pca_{name}_it{step}.png"))
                figs.draw(trajectory_overlay, ori, syn,
                          path=str(writer / f"traj_{name}_it{step}.png"))

            callbacks.append(artifacts)
        callbacks = [c for c in callbacks if c]
        p2_cb = ((lambda step, state, metrics: [c(step, state, metrics)
                                                for c in callbacks])
                 if callbacks else None)
        if loader is None:
            best2, err2, _, m2 = fit_phase2(model, err_model, p2_params,
                                            err_params, windows, mask,
                                            exp.phase2, g["p2"],
                                            verbose=verbose, log_fn=log_fn,
                                            callback=p2_cb, mesh=mesh,
                                            **ckpt_kw("phase2"))
        else:
            best2, err2, _, m2 = fit_phase2_streaming(
                model, err_model, p2_params, err_params, loader,
                exp.context, mask, exp.phase2, g["p2"], verbose=verbose,
                log_fn=log_fn, callback=p2_cb, mesh=mesh,
                **ckpt_kw("phase2"))
        results["phase2"] = m2
        gen = generate_with_compensation(model, err_model, best2, err2,
                                         g["gen"], 256, parents=mask)
        results["generated_shape"] = list(gen.shape)
        results["generation_moment_gap"] = _gap(moment_match(windows, gen))
        # Conditioned generation beside the cold start: encode real
        # contexts, continue with error compensation.  ErrorVAE.sample
        # keeps its leading zero step; slice to rollout_len as
        # generate_with_compensation does.
        g_cond = gens(1)["gen"]
        ctxs = windows[:256, : model.enc_len, :]
        noise_c = err_model.sample(err2, g_cond, ctxs.shape[0],
                                   model.rollout_len)
        cond = model.conditioned_rollout(
            best2, ctxs, g_cond, noise=noise_c[:, : model.rollout_len],
            parents=mask)
        results["generation_moment_gap_conditioned"] = _gap(
            moment_match(windows, cond))
        if writer:
            np.save(writer / f"syn_{name}.npy", gen.cpu().numpy())
            np.save(writer / f"syn_cond_{name}.npy", cond.cpu().numpy())
            syn_np = gen[:, :t_cmp].cpu().numpy()
            cond_np = cond[:, :t_cmp].cpu().numpy()
            for fn, syn, stem in ((pca_comparison, syn_np, "pca"),
                                  (tsne_comparison, syn_np, "tsne"),
                                  (trajectory_overlay, syn_np, "traj"),
                                  (pca_comparison, cond_np, "pca_cond"),
                                  (tsne_comparison, cond_np, "tsne_cond")):
                figs.draw(fn, ori, syn,
                          path=str(writer / f"{stem}_{name}.png"))
        if save_checkpoints and writer:
            save_checkpoint(str(writer / "ckpt_phase2"),
                            {"crvae": best2, "error_vae": err2})
    if log_writer is not None:
        log_writer.close()


def win_windows(series: torch.Tensor, tau: int) -> torch.Tensor:
    """The win family's (N, 2 tau, p) training windows: every window of a
    (t, p) series, or each (N, t, p) sequence clipped to 2 tau."""
    from vae_connexe_torch.data import sliding_windows

    if series.ndim == 2:
        return sliding_windows(series, 2 * tau)
    return series[:, : 2 * tau, :]


def _run_win(exp, name, seed, series, truth, gens, dev, out, figs, results, *,
             verbose, save_checkpoints, log_fn, **_):
    """The win family's run (``run_experiment``), results into
    ``results``."""
    from vae_connexe_torch.evals import (
        auto_threshold,
        gc_metrics,
        prediction_mse,
        stability_selection,
    )
    from vae_connexe_torch.evals.viz import (
        gc_heatmaps,
        w_in_heatmaps,
        w_in_row_norms,
    )
    from vae_connexe_torch.models import WInCRVAE
    from vae_connexe_torch.train import WInTrainer
    from vae_connexe_torch.utils import save_checkpoint
    from vae_connexe_torch.utils.seeding import seed_stack_generators
    from vae_connexe_torch.utils.tree import stack_trees

    g = gens()
    windows = win_windows(series, exp.tau)
    model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                     tau=exp.tau)
    trainer = WInTrainer(model, exp.win)
    params, m, stage1_params = trainer.fit(
        model.init(g["init"], dev), windows, g["run"], verbose=verbose,
        log_fn=log_fn, return_stage1=True)
    scores = model.granger_matrix(params, threshold=False)
    results["train"] = m
    # Prediction performance of the final model: its clean decode against
    # its decode with error compensation, and the pre-prune stage-I params
    # through the clean decode, all on the same draws.
    x_past = windows[:, : exp.tau, :]
    x_cur = windows[:, exp.tau: 2 * exp.tau, :]
    g_mse = gens(1)["run"]
    eps_z = torch.randn((x_past.shape[0], model.latent), generator=g_mse,
                        device=g_mse.device)
    eps_e = torch.randn((x_past.shape[0], model.err_vae.latent),
                        generator=g_mse, device=g_mse.device)
    with torch.no_grad():
        pred_clean = model.forward(params, x_past, x_cur, eps_z)[0]
        pred_comp = model.forward(params, x_past, x_cur, eps_z, 2, eps_e)[0]
        pred_s1 = model.forward(stage1_params, x_past, x_cur, eps_z)[0]
    mse1 = float(prediction_mse(pred_clean, x_cur))
    mse2 = float(prediction_mse(pred_comp, x_cur))
    results["prediction_mse"] = {
        "phase1_forward": mse1,
        "phase2_forward_with_compensation": mse2,
        "improvement_pct": round((1 - mse2 / mse1) * 100, 1),
        "stage1_params_phase1_forward": float(prediction_mse(pred_s1, x_cur)),
    }
    results["gc"] = _floats(gc_metrics(truth, scores, exp.gc_threshold))
    results["threshold_sweep"] = _sweep(truth, scores)
    thr_auto = float(auto_threshold(scores))
    results["gc_auto"] = {"threshold": thr_auto,
                          **_floats(gc_metrics(truth, scores, thr_auto))}
    # Off the diagonal: the coupled-Henon and VAR truths omit self-loops the
    # dynamics contain, so the coupling the W_in norms encode is the
    # off-diagonal ranking.
    offmask = ~torch.eye(exp.p, dtype=torch.bool, device=dev)
    s_off, t_off = scores.detach()[offmask], truth[offmask]
    thr_off = float(auto_threshold(s_off))
    results["gc_offdiag_auto"] = {
        "threshold": thr_off,
        **{k: float(v) for k, v in gc_metrics(t_off, s_off, thr_off).items()
           if k != "auroc_offdiag"}}
    # The best off-diagonal point on a dense grid, oracle-supervised (marked
    # as such): the ranking's potential.
    grid = np.linspace(0.0, float(s_off.max()), 128, dtype=np.float32)
    f1s = [float(gc_metrics(t_off, s_off, float(t))["f1"]) for t in grid]
    best_i = int(np.argmax(f1s))
    results["gc_offdiag_best_threshold"] = {
        "threshold": float(grid[best_i]), "oracle": True,
        **_floats(gc_metrics(t_off, s_off, float(grid[best_i])))}
    if exp.stability_seeds > 1:
        # Unsupervised stability selection: per-seed selections voted
        # across inits.  The extra seeds train at once (fit_many, their
        # seeds folded into the kernels' heads); stage II leaves W_in
        # untouched unless update_w_in_stage2, so they skip it otherwise.
        e2 = exp.win.stage2_epochs if exp.win.update_w_in_stage2 else 0
        inits, runs = seed_stack_generators(
            seed, range(1, exp.stability_seeds), ROLES, ("init",), dev)
        p_stack = stack_trees([model.init(gi, dev) for gi in inits])
        p_stack, _ = trainer.fit_many(p_stack, windows, runs,
                                      stage2_epochs=e2)
        stack = torch.cat([scores.detach()[None],
                           model.granger_matrix(p_stack, threshold=False)])
        votes, _, min_frac = stability_selection(stack, min_frac="auto",
                                                 exclude_diagonal=True)
        v_off = votes[offmask]
        results["gc_stability"] = {
            "seeds": exp.stability_seeds, "min_frac": min_frac,
            "votes_offdiag": [round(float(v), 3) for v in v_off],
            **{k: float(v) for k, v in
               gc_metrics(t_off, v_off, min_frac - 1e-6).items()
               if k != "auroc_offdiag"}}
    gen = model.generate(params, windows[:8], gens()["gen"], 20)
    results["generated_shape"] = list(gen.shape)
    if out:
        np.save(out / f"GC_scores_{name}.npy", scores.detach().cpu().numpy())
        np.save(out / f"syn_{name}.npy", gen.cpu().numpy())
        w_in = params.w_in.cpu().numpy()
        figs.draw(w_in_heatmaps, w_in, path=str(out / f"w_in_{name}.png"))
        figs.draw(w_in_row_norms, w_in, path=str(out / f"w_in_norms_{name}.png"),
                  threshold=exp.win.prune_threshold)
        figs.draw(gc_heatmaps, truth.cpu().numpy(),
                  scores.detach().cpu().numpy() > thr_auto,
                  path=str(out / f"gc_heatmap_{name}.png"))
    if save_checkpoints and out:
        gc_bin = model.granger_matrix(params, thr=exp.win.prune_threshold)
        save_checkpoint(str(out / "ckpt_win"), params, gc_matrix=gc_bin)


def _run_csrae(exp, name, seed, series, truth, gens, dev, out, figs,
               results, *, verbose, save_checkpoints, log_fn, **_):
    """The csrae family's run (``run_experiment``): the MixtureCSRAE on
    binarised windows, results into ``results``."""
    from vae_connexe_torch.evals.viz import pca_comparison, tsne_comparison
    from vae_connexe_torch.train import fit_csrae
    from vae_connexe_torch.utils import save_checkpoint

    g = gens()
    x, model = make_csrae_inputs(exp, series)
    cfgc = exp.csrae
    params = model.init(g["init"], dev)
    with torch.no_grad():
        init_total, init_bce, init_cs = model.loss(params, x[:512],
                                                   generator=g["run"])
    params, m = fit_csrae(model, params, x, g["run"], epochs=cfgc.epochs,
                          batch_size=cfgc.batch_size, lr=cfgc.lr,
                          verbose=verbose, log_fn=log_fn)
    results["train"] = m
    results["initial"] = {"total": float(init_total),
                          "bce": float(init_bce), "cs": float(init_cs)}
    results.update(csrae_eval_metrics(model, params, x, g["gen"]))
    with torch.no_grad():
        samples = model.sample(params, g["gen"], 64)
    results["generated_shape"] = list(samples.shape)
    if out:
        syn = samples.cpu().numpy()
        np.save(out / f"syn_{name}.npy", syn)
        # The reference's PCA and t-SNE comparison on the flattened
        # binarised windows, reshaped back to (N, context, p).
        shape3 = (-1, exp.context, exp.p)
        ori3 = x[:512].cpu().numpy().reshape(shape3)
        syn3 = syn.reshape(shape3)
        figs.draw(pca_comparison, ori3, syn3,
                  path=str(out / f"pca_{name}.png"))
        figs.draw(tsne_comparison, ori3, syn3,
                  path=str(out / f"tsne_{name}.png"))
    if save_checkpoints and out:
        save_checkpoint(str(out / "ckpt_csrae"), params)


def vrae_model(exp: Experiment):
    """The vrae family's VRAE (tanh head), shared by ``run_experiment``
    and ``cli eval``."""
    from vae_connexe_torch.models import VRAE

    return VRAE(input_dim=exp.p, hidden_dim=exp.hidden,
                latent_dim=exp.latent, output_activation="tanh")


def _run_vrae(exp, name, seed, series, truth, gens, dev, out, figs, results,
              *, verbose, save_checkpoints, log_fn, **_):
    """The vrae family's run (``run_experiment``): 100 full-batch epochs
    at beta 0.5 with the exponential teacher-forcing decay of 0.02, then 5
    sampled sequences; results into ``results``."""
    from vae_connexe_torch.models.vrae import exponential_teacher_forcing_schedule
    from vae_connexe_torch.train import fit_vrae
    from vae_connexe_torch.utils import save_checkpoint

    g = gens()
    model = vrae_model(exp)
    params = model.init(g["init"], dev)
    params, m = fit_vrae(
        model, params, series, g["run"], epochs=100, lr=1e-3, beta=0.5,
        teacher_forcing_schedule=lambda e:
            exponential_teacher_forcing_schedule(e, decay_rate=0.02),
        verbose=verbose, log_fn=log_fn)
    results["train"] = m
    with torch.no_grad():
        samples = model.sample(params, g["gen"], 5, exp.t)
    results["generated_shape"] = list(samples.shape)
    if out:
        np.save(out / f"syn_{name}.npy", samples.cpu().numpy())
    if save_checkpoints and out:
        save_checkpoint(str(out / "ckpt_vrae"), params)
