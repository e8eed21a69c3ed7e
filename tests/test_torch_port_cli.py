"""The port's experiments table and command line against the JAX package's:
the table field for field, ``list``, ``run`` -> ``export`` -> ``generate``
and ``eval`` on the CPU at four steps a phase, resume, and the reference's
flags that the port does not have yet."""

import dataclasses
import json
import pathlib
import re

import numpy as np
import pytest
import torch

import vae_connexe_tpu.configs.experiments as jexp
from vae_connexe_torch import cli
from vae_connexe_torch.configs import EXPERIMENTS, get_experiment, run_experiment
from vae_connexe_torch.models import CRVAE, ErrorVAE
from vae_connexe_torch.utils import load_gc, restore_checkpoint


@pytest.mark.parametrize("name", sorted(jexp.EXPERIMENTS))
def test_experiments_table_matches_jax(name):
    """Each entry, with every nested config, equals the JAX package's."""
    assert sorted(EXPERIMENTS) == sorted(jexp.EXPERIMENTS)
    got = dataclasses.asdict(get_experiment(name))
    assert got == dataclasses.asdict(jexp.get_experiment(name))
    assert [f.name for f in dataclasses.fields(EXPERIMENTS[name])] == [
        f.name for f in dataclasses.fields(jexp.Experiment)]


def _jax_crvae_result_keys() -> set[str]:
    """The keys the JAX package's ``run_experiment`` puts in the results of
    the crvae family on a dataset other than the 2-D Henon system (whose
    ``gc_dynamics`` rows are not ported), read from its source."""
    src = pathlib.Path(jexp.__file__).read_text()
    body = src[src.index('if exp.model_family == "crvae":'):
               src.index('elif exp.model_family == "win":')]
    keys = set(re.findall(r'results\["(\w+)"\]\s*=', body))
    return {"experiment", "seed"} | {k for k in keys
                                     if not k.startswith("gc_dynamics")}


def test_cli_list(capsys):
    cli.main(["list"])
    out = capsys.readouterr().out
    assert all(name in out for name in EXPERIMENTS)
    assert "lorenz96_crvae       family=crvae" in out


def _run(tmp_path, capsys, *extra):
    out_dir = tmp_path / "run"
    cli.main(["run", "lorenz96_crvae", "--iters", "4", "--device", "cpu",
              "--out-dir", str(out_dir), "--quiet", *extra])
    return out_dir, json.loads(capsys.readouterr().out)


def test_cli_run_export_generate_eval(tmp_path, capsys):
    """``run`` writes the reference's files and returns its keys; the
    phase-2 checkpoint exports, the artifact samples, and the phase-1
    checkpoint rescores to the run's own GC metrics."""
    out, res = _run(tmp_path, capsys, "--save-checkpoints")
    assert set(res) == _jax_crvae_result_keys()
    assert res["generated_shape"] == [256, 21, 10]
    assert res["phase2"].keys() == {"recon", "latent_reg", "mean_loss",
                                    "loss_e", "kl_e"}
    name = "lorenz96_crvae"
    for f in (f"GC_{name}.npy", f"GC_scores_{name}.npy", f"syn_{name}.npy",
              f"syn_cond_{name}.npy", f"metrics_{name}.json",
              f"train_log_{name}.jsonl", "ckpt_phase1", "ckpt_phase1.gc.npy",
              "ckpt_phase2"):
        assert (out / f).exists(), f
    assert json.loads((out / f"metrics_{name}.json").read_text()) == res
    log = [json.loads(line) for line in
           (out / f"train_log_{name}.jsonl").read_text().splitlines()]
    assert [(r["phase"], r["step"]) for r in log] == [("phase1", 4),
                                                      ("phase2", 4)]
    # Phase 2's best params keep every head input column off the mask at 0.
    gc = load_gc(str(out / "ckpt_phase1"))
    np.testing.assert_array_equal(gc, np.load(out / f"GC_{name}.npy"))
    g = torch.Generator().manual_seed(0)
    ck = restore_checkpoint(str(out / "ckpt_phase2"),
                            {"crvae": CRVAE(10).init(g, "cpu"),
                             "error_vae": ErrorVAE(10, 64).init(g, "cpu")})
    w_ih = ck["crvae"].heads.w_ih.permute(0, 2, 1)
    assert (w_ih[torch.tensor(gc) == 0] == 0).all()

    art = str(tmp_path / "g.vcxt")
    cli.main(["export", name, str(out / "ckpt_phase2"), "--out", art,
              "--batch", "8", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["batch"] == 8
    samples = str(tmp_path / "s.npy")
    cli.main(["generate", art, "--seed", "3", "--out", samples, "--device",
              "cpu"])
    assert json.loads(capsys.readouterr().out)["shape"] == [8, 21, 10]
    assert np.isfinite(np.load(samples)).all()

    cli.main(["eval", name, str(out / "ckpt_phase1"), "--generate", "4",
              "--device", "cpu"])
    ev = json.loads(capsys.readouterr().out)
    assert ev["gc"] == pytest.approx(res["gc"])
    assert ev["threshold_sweep"] == res["threshold_sweep"]
    assert ev["generated_shape"] == [4, 21, 10]


def test_cli_run_resume_after_finish_is_pure_restore(tmp_path, capsys):
    """A run with snapshots, rerun with --resume in the same directory,
    restores both finished phases and gives the same results."""
    _, first = _run(tmp_path, capsys, "--checkpoint-every", "2")
    _, again = _run(tmp_path, capsys, "--checkpoint-every", "2", "--resume")
    assert again == first


def test_run_experiment_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="A4"):
        run_experiment("vrae_demo", device="cpu")
    with pytest.raises(NotImplementedError, match="A4"):
        run_experiment("henon_author", device="cpu")
    with pytest.raises(NotImplementedError, match="A7"):
        run_experiment("lorenz96_crvae", mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        run_experiment("lorenz96_crvae", out_of_core=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A3"):
        run_experiment("lorenz96_crvae", artifacts_every=10, device="cpu")
    with pytest.raises(ValueError, match="out-dir"):
        run_experiment("lorenz96_crvae", resume=True, device="cpu")


@pytest.mark.parametrize("argv,item", [
    (["run", "lorenz96_crvae", "--mesh"], "A7"),
    (["run", "lorenz96_crvae", "--ep", "2"], "A7"),
    (["run", "lorenz96_crvae", "--sp", "2"], "A7"),
    (["run", "lorenz96_crvae", "--processes", "2"], "A7"),
    (["run", "lorenz96_crvae", "--out-of-core"], "A6"),
    (["run", "lorenz96_crvae", "--artifacts-every", "5"], "A3"),
    (["run", "lorenz96_crvae", "--debug-nans"], "A4"),
    (["export", "lorenz96_crvae", "ck", "--out", "g", "--serve-dtype",
      "bfloat16"], "A5"),
    (["export", "lorenz96_crvae", "ck", "--out", "g", "--platforms", "cpu"],
     "A5"),
    (["export", "henon6d_win", "ck", "--out", "g", "--device", "cpu"], "A4"),
    (["eval", "vrae_demo", "ck", "--device", "cpu"], "A4"),
    (["discover", "s.csv", "--mesh"], "A7"),
    (["discover", "s.csv", "--ep", "2"], "A7"),
    (["discover", "s.csv", "--family", "win"], "A4"),
    (["discover", "s.csv", "--prox", "row"], "A4"),
    (["sweep", "--mesh"], "A7"),
], ids=["mesh", "ep", "sp", "processes", "out-of-core", "artifacts-every",
        "debug-nans", "bf16", "platforms", "export-win", "eval-vrae",
        "discover-mesh", "discover-ep", "discover-win", "discover-prox",
        "sweep-mesh"])
def test_unported_flags_exit(argv, item):
    """The reference's flags the port does not have exit with the ROADMAP
    item that brings them; none is silently ignored."""
    with pytest.raises(SystemExit, match=f"ROADMAP {item}"):
        cli.main(argv)
