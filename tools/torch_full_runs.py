"""Whole-run parity of the port on the card at full configurations.

    python3 tools/torch_full_runs.py [--only NAME ...] [--out-dir DIR]

Runs ``henon6d_win`` (2000 + 1000 epochs, 8 stability seeds),
``var_crvae`` (100 + 30 epochs, 8 seeds), ``lorenz96_crcsrae`` (2000 +
10000 steps, the CS divergence against a GMM prior), ``lorenz96_crvae``
(5000 + 10000 steps, streamed from its series file with
``--out-of-core``), ``lorenz96_crvae_tuned`` (5000 + 10000 steps),
``lorenz96_longhorizon`` (2000 + 2000 steps, ctx 128), ``lorenz96_scaled``
(5000 + 5000 steps, p=40, H=128) and ``lorenz96_xl`` (3000 + 3000 steps,
p=128, H=128) through the port's ``cli run`` on the card at their own
configurations (nothing cut), and holds each run's gated numbers (the
W_in runs' ``gc_offdiag_auto.auroc`` and ``gc_stability.f1``, the crvae
runs' ``gc.auroc``) to the JAX package's committed full-config numbers
(``results/<name>/metrics_<name>.json``) minus 0.05, and reports others
beside JAX's (the crvae runs' F1, phase-2 metrics and generation moment
gaps).  ``discover_narma`` runs ``cli discover`` on the committed NARMA
series as the JAX package's demo did (``--seeds 8 --generate 256``) and
holds its scores AUROC against ``truth_narma.npy`` to JAX's (0.994, in
``results/discover_demo/grade_narma.json``) minus 0.05, reporting the
votes AUROC, the selected graph's F1 and the confidence beside JAX's
(confidence 0.76: ``docs/causal-discovery.md``).  Prints the card's name
and power limit, one JSON line a run (each number beside JAX's, the wall
time) and exits non-zero when a run misses its gate.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MARGIN = 0.05
# The crvae runs' reported numbers.
_CRVAE_REPORTED = (
    ("gc", "f1"), ("phase1", "recon"), ("phase2", "recon"),
    ("phase2", "latent_reg"), ("phase2", "loss_e"), ("phase2", "kl_e"),
    ("phase2", "mean_loss"), ("generation_moment_gap", "mean_abs_gap"),
    ("generation_moment_gap", "std_abs_gap"),
    ("generation_moment_gap_conditioned", "mean_abs_gap"),
    ("generation_moment_gap_conditioned", "std_abs_gap"))
# The flags a run adds to ``cli run``.
FLAGS = {"lorenz96_crvae": ["--out-of-core"]}
# Each run's (gated, reported) numbers, as paths into its metrics.
RUNS = {
    "henon6d_win": ((("gc_offdiag_auto", "auroc"), ("gc_stability", "f1")),
                    (("gc_stability", "min_frac"),)),
    "var_crvae": ((("gc_offdiag_auto", "auroc"), ("gc_stability", "f1")),
                  (("gc_stability", "min_frac"),)),
    "lorenz96_crcsrae": (
        (("gc", "auroc"),),
        (("gc", "f1"), ("phase1", "recon"), ("phase1", "latent_reg"),
         ("phase2", "recon"), ("phase2", "latent_reg"), ("phase2", "loss_e"),
         ("generation_moment_gap", "mean_abs_gap"),
         ("generation_moment_gap", "std_abs_gap"),
         ("generation_moment_gap_conditioned", "mean_abs_gap"),
         ("generation_moment_gap_conditioned", "std_abs_gap"))),
    "lorenz96_crvae": ((("gc", "auroc"),), _CRVAE_REPORTED),
    "lorenz96_crvae_tuned": ((("gc", "auroc"),), _CRVAE_REPORTED),
    "lorenz96_longhorizon": ((("gc", "auroc"),), _CRVAE_REPORTED),
    "lorenz96_scaled": ((("gc", "auroc"),), _CRVAE_REPORTED),
    "lorenz96_xl": ((("gc", "auroc"),), _CRVAE_REPORTED),
}
# Foreign-data discovery: the committed demo series and the JAX package's
# grade of it.
DEMO = os.path.join("results", "discover_demo")
DISCOVER = {"discover_narma": ("narma", ["--seeds", "8", "--generate",
                                         "256"])}
JAX_CONFIDENCE = {"narma": 0.76}


def discover_row(name: str, out_dir: str, card: str) -> tuple[dict, bool]:
    """``cli discover`` on a demo series, graded against its truth as the
    JAX package's demo was: (the JSON row, whether the gate held)."""
    import numpy as np
    import torch

    from vae_connexe_torch import cli
    from vae_connexe_torch.evals import auroc, gc_metrics

    system, flags = DISCOVER[name]
    csv = os.path.join(ROOT, DEMO, f"{system}.csv")
    truth = torch.from_numpy(np.load(os.path.join(ROOT, DEMO,
                                                  f"truth_{system}.npy")))
    ref = json.load(open(os.path.join(ROOT, DEMO, f"grade_{system}.json")))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["discover", csv, *flags, "--out-dir", out_dir, "--quiet"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    summary = json.loads(buf.getvalue())

    def arr(kind):
        return torch.from_numpy(np.load(os.path.join(
            out_dir, f"{kind}_{system}.npy"))).float()

    scores_auroc = float(auroc(truth, arr("GC_scores")))
    gate = ref["scores_auroc"] - MARGIN
    row = {"experiment": name, "flags": flags, "seconds": secs, "card": card,
           "scores_auroc": {"port": scores_auroc,
                            "jax": ref["scores_auroc"], "gate": gate,
                            "ok": scores_auroc >= gate},
           "votes_auroc": {"port": float(auroc(truth, arr("GC_votes"))),
                           "jax": ref["votes_auroc"]},
           "selected_f1": {"port": float(gc_metrics(truth, arr("GC"))["f1"]),
                           "jax": ref["selected"]["f1"]},
           "n_edges": {"port": summary["n_edges"],
                       "jax": ref["n_edges_selected"]},
           "confidence": {"port": summary["confidence"],
                          "jax": JAX_CONFIDENCE[system]}}
    return row, scores_auroc >= gate


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=[*RUNS, *DISCOVER], nargs="+",
                    default=None)
    ap.add_argument("--out-dir", default=None,
                    help="keep each run's files under DIR/<name>")
    args = ap.parse_args()
    import torch

    from vae_connexe_torch import cli

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    ok = True
    with tempfile.TemporaryDirectory() as tmp:
        base = args.out_dir or tmp
        for name in (args.only or [*RUNS, *DISCOVER]):
            out_dir = os.path.join(base, name)
            if name in DISCOVER:
                row, passed = discover_row(name, out_dir, card)
                ok &= passed
                print(json.dumps(row), flush=True)
                continue
            ref = json.load(open(os.path.join(
                ROOT, "results", name, f"metrics_{name}.json")))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["run", name, "--out-dir", out_dir, "--quiet",
                          *FLAGS.get(name, [])])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            res = json.load(open(os.path.join(out_dir,
                                              f"metrics_{name}.json")))
            row = {"experiment": name, "flags": FLAGS.get(name, []),
                   "seconds": secs, "card": card}
            gated, reported = RUNS[name]
            for key, metric in gated:
                got, want = res[key][metric], ref[key][metric]
                passed = got >= want - MARGIN
                ok &= passed
                row[f"{key}.{metric}"] = {"port": got, "jax": want,
                                          "gate": want - MARGIN,
                                          "ok": passed}
            for key, metric in reported:
                row[f"{key}.{metric}"] = {"port": res[key][metric],
                                          "jax": ref[key][metric]}
            if "prediction_mse" in res:
                row["prediction_mse"] = res["prediction_mse"]
            print(json.dumps(row), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
