"""The reference's experiment scripts as data, and the runner (port of
``vae_connexe_tpu/configs/experiments.py``).

``EXPERIMENTS`` is the JAX package's table, copied field for field (the
comments cite each entry's source).  ``run_experiment`` runs the crvae
family on the port: phase 1, the GC scores and metrics, phase 2 under the
binary mask, compensated and conditioned generation, with the same ``.npy``,
checkpoint, log and metrics files as the reference.  Only the ``lorenz96``
dataset is ported.  Not ported yet, and raising where asked for: the other
families and datasets (ROADMAP A4), ``artifacts_every`` and the PNG
figures of ``evals/viz.py`` (A3), ``out_of_core`` (A6) and ``mesh`` (A7).
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


def _unported_dataset(exp: Experiment):
    if exp.dataset != "lorenz96":
        raise NotImplementedError(
            f"dataset {exp.dataset!r} is not ported yet (ROADMAP A4); the "
            "port makes lorenz96 only")


def _make_dataset(exp: Experiment, generator: torch.Generator, device=None):
    """(series (t, p) on ``device``, truth (p, p)) of the experiment, the
    series' draws from ``generator``."""
    from vae_connexe_torch.data import lorenz96, lorenz96_truth

    _unported_dataset(exp)
    dev = resolve_device(device)
    series = lorenz96(generator, p=exp.p, t=exp.t, device=dev)
    return series, lorenz96_truth(exp.p, dev)


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
    """Run a named crvae-family experiment end to end on ``device``
    (default ``cuda``); returns the metrics dict, with the reference's
    keys.

    ``save_checkpoints=True`` (requires ``out_dir``) writes ``ckpt_phase1``
    with the binary GC matrix beside it (``ckpt_phase1.gc.npy``, the
    two-phase handoff) and ``ckpt_phase2`` (``{"crvae", "error_vae"}``).
    ``checkpoint_every=N`` (requires ``out_dir``) snapshots the running
    phase's whole state every N steps under ``out_dir/ckpt_mid_phase{1,2}``;
    ``resume=True`` restores the latest snapshot and continues, bitwise
    equal to the uninterrupted run (a finished phase is a pure restore).
    With ``out_dir`` the run also writes ``GC_<name>.npy``,
    ``GC_scores_<name>.npy``, ``syn_<name>.npy``, ``syn_cond_<name>.npy``,
    ``train_log_<name>.jsonl`` (one record a chunk, both phases) and
    ``metrics_<name>.json``; the reference's PNG figures are not written
    (``evals/viz.py``, ROADMAP A3).

    The draws (``utils/seeding.py::role_generators``): one CPU generator
    seeded with ``seed`` draws one seed per role of ``ROLES`` in that
    order.  ``data`` (on the device) makes the
    series; ``init`` (CPU) the phase-1 CRVAE, seed + 1 the phase-2 CRVAE
    and seed + 2 the ErrorVAE (the reference's ``fold_in(k_init, 1)`` and
    ``fold_in(k_init, 2)``); ``run`` and ``p2`` (on the device) are the
    two fits' generators; ``gen`` (on the device) draws the compensated
    generation and seed + 1 the conditioned one (the ErrorVAE's h0, then
    the latent epsilon).  A rerun with the same seed rebuilds the same
    generators, which is what resume relies on.
    """
    exp = get_experiment(name)
    if exp.model_family != "crvae":
        raise NotImplementedError(
            f"the {exp.model_family!r} family ({name!r}) is not ported yet "
            "(ROADMAP A4); the port runs the crvae family")
    if mesh is not None:
        raise NotImplementedError("meshed runs are not ported yet "
                                  "(ROADMAP A7)")
    if out_of_core:
        raise NotImplementedError("out-of-core runs are not ported yet "
                                  "(ROADMAP A6)")
    if artifacts_every:
        raise NotImplementedError(
            "artifacts_every (periodic samples and PCA/trajectory figures, "
            "evals/viz.py) is not ported yet (ROADMAP A3)")
    if (checkpoint_every or resume) and not out_dir:
        raise ValueError("--checkpoint-every/--resume require --out-dir "
                         "(checkpoints live under it)")
    if overrides:
        exp = dataclasses.replace(exp, **overrides)
    _unported_dataset(exp)
    dev = resolve_device(device)

    def gens(offset=0):
        return role_generators(seed, ROLES, ("init",), dev, offset)

    g = gens()

    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.evals import auto_threshold, gc_metrics, moment_match
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.train import (
        fit_phase1,
        fit_phase2,
        generate_with_compensation,
    )
    from vae_connexe_torch.utils import JsonlWriter, save_checkpoint

    series, truth = _make_dataset(exp, g["data"], dev)
    out = pathlib.Path(out_dir) if out_dir else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    results: dict[str, Any] = {"experiment": name, "seed": seed}

    model = CRVAE(p=exp.p, hidden=exp.hidden)
    params = model.init(g["init"], dev)
    full = torch.ones((exp.p, exp.p), device=dev)
    log_writer = (JsonlWriter(str(out / f"train_log_{name}.jsonl"))
                  if out else None)

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

    windows, _ = arrange_input(series, exp.context)
    best, _, m1 = fit_phase1(model, params, windows, full, exp.phase1,
                             g["run"], verbose=verbose, log_fn=log_fn,
                             callback=log_phase("phase1"), **ckpt_kw("phase1"))
    scores = model.gc(best, threshold=False)
    gc_est = model.gc(best, threshold=True)
    results["phase1"] = m1
    results["gc"] = _floats(gc_metrics(truth, scores, exp.gc_threshold))
    thr_auto = float(auto_threshold(scores))
    results["gc_auto"] = {"threshold": thr_auto,
                          **_floats(gc_metrics(truth, scores, thr_auto))}
    results["threshold_sweep"] = _sweep(truth, scores)
    if out:
        np.save(out / f"GC_{name}.npy", gc_est.cpu().numpy())
        np.save(out / f"GC_scores_{name}.npy", scores.detach().cpu().numpy())
    if save_checkpoints and out:
        save_checkpoint(str(out / "ckpt_phase1"), best, gc_matrix=gc_est)

    if run_phase2:
        mask = gc_est.to(torch.float32)
        p2_params = model.init(gens(1)["init"], dev)
        err_model = ErrorVAE(d=exp.p, hidden=exp.hidden)
        err_params = err_model.init(gens(2)["init"], dev)
        best2, err2, _, m2 = fit_phase2(model, err_model, p2_params,
                                        err_params, windows, mask,
                                        exp.phase2, g["p2"],
                                        verbose=verbose, log_fn=log_fn,
                                        callback=log_phase("phase2"),
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
        noise_c = err_model.sample(err2, ctxs.shape[0], generator=g_cond,
                                   length=model.rollout_len)
        cond = model.conditioned_rollout(
            best2, ctxs, generator=g_cond,
            noise=noise_c[:, : model.rollout_len], parents=mask)
        results["generation_moment_gap_conditioned"] = _gap(
            moment_match(windows, cond))
        if out:
            np.save(out / f"syn_{name}.npy", gen.cpu().numpy())
            np.save(out / f"syn_cond_{name}.npy", cond.cpu().numpy())
        if save_checkpoints and out:
            save_checkpoint(str(out / "ckpt_phase2"),
                            {"crvae": best2, "error_vae": err2})
    if log_writer is not None:
        log_writer.close()
    if out:
        (out / f"metrics_{name}.json").write_text(json.dumps(results,
                                                             indent=2))
    return results
