"""Phase-1 graph recovery of the JAX package, the reference for the port's.

    JAX_PLATFORMS=cpu python tools/jax_phase1_auroc.py [--steps N] [--seed S]

Runs the ``lorenz96_crvae`` experiment's phase 1 (p=10, T=2048, context 20,
H=64, batch 256, lam=0.1, lr=5e-2; ``configs/experiments.py``) for N steps
on a Lorenz-96 series made from seed S, and prints one JSON line with the
GC AUROC of the best parameters against the circulant truth and the run's
wall time.  ``chip_smoke.py`` runs the port's phase 1 at the same
configuration and step count and holds its AUROC to this one minus a
stated margin.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vae_connexe_tpu.configs.experiments import EXPERIMENTS  # noqa: E402
from vae_connexe_tpu.data import arrange_input, lorenz96, lorenz96_truth  # noqa: E402
from vae_connexe_tpu.evals import gc_metrics  # noqa: E402
from vae_connexe_tpu.models import CRVAE  # noqa: E402
from vae_connexe_tpu.train import fit_phase1  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    exp = EXPERIMENTS["lorenz96_crvae"]
    cfg = exp.phase1.__class__(**{**exp.phase1.__dict__,
                                  "max_iter": args.steps, "check_every": 500})
    k_data, k_init, k_fit = jax.random.split(jax.random.key(args.seed), 3)
    windows, _ = arrange_input(lorenz96(k_data, p=exp.p, t=exp.t), exp.context)
    model = CRVAE(p=exp.p, hidden=exp.hidden)
    t0 = time.perf_counter()
    best, _, metrics = fit_phase1(model, model.init(k_init), windows,
                                  jnp.ones((exp.p, exp.p)), cfg, k_fit)
    scores = model.gc(best, threshold=False)
    gc = gc_metrics(lorenz96_truth(exp.p), scores)
    print(json.dumps({
        "experiment": exp.name, "steps": args.steps, "seed": args.seed,
        "auroc": float(gc["auroc"]), "auroc_offdiag": float(gc["auroc_offdiag"]),
        "recall": float(gc["recall"]), "mean_loss": metrics["mean_loss"],
        "seconds": time.perf_counter() - t0, "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
