"""Graph recovery of the JAX package on the Hénon and VAR experiments, the
reference for the port's.

    JAX_PLATFORMS=cpu python tools/jax_win_auroc.py [--seed S] [--only NAME]

Runs, through the JAX package's ``run_experiment``, the three experiments
at exactly the epoch and step counts that ``chip_smoke.py`` gives the
port's ``cli run``:

- ``henon6d_win``: stage I / stage II cut from 2000 + 1000 epochs to
  200 + 100, its 8 stability seeds kept;
- ``var_crvae``: its own 100 + 30 epochs and 8 seeds (nothing cut);
- ``henon_author``: phase 1 at its own 1000 steps, phase 2 cut from 10000
  to 1000 steps.

Prints one JSON line a run with the AUROC that ``chip_smoke.py`` gates on
(``gc_offdiag_auto.auroc`` for the win family, ``gc_dynamics.auroc`` for
``henon_author``), the stability row and the wall time.

On the 2-D Hénon map the graph's ranking depends on the seed in both
packages (x's own lags carry y, so the x <- y and y <- y scores trade
places from one init to another, and a 2 x 2 AUROC moves in steps of
1/3), so for ``henon_author`` the script also trains phase 1 at seeds 0
to AUTHOR_SEEDS - 1 at once (``parallel/seed_sweep.py::sweep_phase1``,
the same 1000 steps) and prints each seed's ``gc_dynamics.auroc``, the
share of seeds that read 1.0 (which ``chip_smoke.py``'s gate holds the
port's share against), their mean and standard deviation.

``discover_win`` is ``chip_smoke.py``'s ``cli discover --family win
--prox row --seeds 8`` run: the JAX package's ``discover`` on a coupled
Hénon series (d=6, T=3000) at DISCOVER_EPOCHS stage-I epochs and lam
0.03, its seed-median scores' AUROC against ``coupled_henon_truth`` off
the diagonal.

The lines it printed on a CPU, which ``chip_smoke.py``'s gates read, are
kept in ``tools/jax_win_auroc.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vae_connexe_tpu.configs.experiments import (  # noqa: E402
    get_experiment,
    run_experiment,
)

# (experiment, stage-I epochs, stage-II epochs) or (experiment, phase-1
# steps, phase-2 steps): chip_smoke.py's WIN_RUNS and AUTHOR_RUN.
RUNS = {"henon6d_win": (200, 100), "var_crvae": (100, 30),
        "henon_author": (1000, 1000)}
# chip_smoke.py's AUTHOR_SEEDS, WIN_DISCOVER_EPOCHS and SWEEP_SEEDS.
AUTHOR_SEEDS, DISCOVER_EPOCHS, DISCOVER_SEEDS = 64, 200, 8


def overrides(name: str) -> dict:
    exp = get_experiment(name)
    a, b = RUNS[name]
    if exp.model_family == "win":
        return {"win": dataclasses.replace(exp.win, stage1_epochs=a,
                                           stage2_epochs=b)}
    return {"phase1": dataclasses.replace(exp.phase1, max_iter=a),
            "phase2": dataclasses.replace(exp.phase2, max_iter=b)}


def author_sweep(seed: int) -> dict:
    """``henon_author``'s phase 1 at AUTHOR_SEEDS seeds from ``seed``, in
    one ``sweep_phase1``; each seed's ``gc_dynamics.auroc``."""
    import jax.numpy as jnp
    import numpy as np

    from vae_connexe_tpu.data import (
        arrange_input,
        henon_chain,
        henon_dynamics_truth,
    )
    from vae_connexe_tpu.evals import gc_metrics
    from vae_connexe_tpu.models import CRVAE
    from vae_connexe_tpu.parallel.seed_sweep import sweep_phase1

    exp = get_experiment("henon_author")
    cfg = overrides("henon_author")["phase1"]
    windows, _ = arrange_input(henon_chain(t=exp.t), exp.context)
    seeds = list(range(seed, seed + AUTHOR_SEEDS))
    out = sweep_phase1(CRVAE(p=exp.p, hidden=exp.hidden), windows,
                       jnp.ones((exp.p, exp.p)), cfg, jnp.asarray(seeds))
    dyn = henon_dynamics_truth()
    aurocs = [float(gc_metrics(dyn, s)["auroc"]) for s in out["gc_scores"]]
    return {"experiment": "henon_author", "phase1_steps": cfg.max_iter,
            "seeds": [seeds[0], seeds[-1]], "gc_dynamics.auroc": aurocs,
            "share_1.0": float(np.mean(np.isclose(aurocs, 1.0))),
            "mean": float(np.mean(aurocs)),
            "sd": float(np.std(aurocs, ddof=1))}


def discover_win(seed: int) -> dict:
    """The win family's ``discover`` on a coupled Hénon series made from
    ``seed``; the scores' off-diagonal AUROC against the truth."""
    import jax
    import numpy as np

    from vae_connexe_tpu.data import coupled_henon, coupled_henon_truth
    from vae_connexe_tpu.discover import discover
    from vae_connexe_tpu.evals import auroc

    d = 6
    series = np.asarray(coupled_henon(jax.random.key(seed), t=3000, d=d))
    res = discover(series, family="win", prox="row", seeds=DISCOVER_SEEDS,
                   max_iter=DISCOVER_EPOCHS, lam=0.03, seed=seed)
    off = ~np.eye(d, dtype=bool)
    truth = np.asarray(coupled_henon_truth(d))
    return {"experiment": "discover_win", "epochs": DISCOVER_EPOCHS,
            "seeds": DISCOVER_SEEDS, "gate": "scores off-diagonal auroc",
            "auroc": float(auroc(truth[off], np.asarray(res.scores)[off])),
            "confidence": float(res.confidence)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    choices=sorted([*RUNS, "author_sweep", "discover_win"]))
    args = ap.parse_args()
    import jax

    names = [args.only] if args.only else [*RUNS, "author_sweep",
                                           "discover_win"]
    for name in names:
        t0 = time.perf_counter()
        if name in RUNS:
            res = run_experiment(name, seed=args.seed,
                                 overrides=overrides(name), verbose=False)
            row = ("gc_dynamics" if name == "henon_author"
                   else "gc_offdiag_auto")
            line = {"experiment": name, "counts": RUNS[name],
                    "seed": args.seed, "gate": f"{row}.auroc",
                    "auroc": res[row]["auroc"],
                    "gc_stability": res.get("gc_stability")}
        else:
            line = {"author_sweep": author_sweep,
                    "discover_win": discover_win}[name](args.seed)
        print(json.dumps({**line, "seconds": time.perf_counter() - t0,
                          "device": str(jax.devices()[0])}), flush=True)


if __name__ == "__main__":
    main()
