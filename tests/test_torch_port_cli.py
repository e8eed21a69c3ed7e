"""The port's experiments table and command line against the JAX package's:
the table field for field, ``list``, ``run`` -> ``export`` -> ``generate``
and ``eval`` on the CPU at four steps a phase, resume, ``run`` -> ``eval``
of the cs, csrae and vrae experiments, ``run --debug-nans``, and the
reference's flags that the port does not have yet."""

import dataclasses
import json
import pathlib
import re
import sys
import unittest.mock

import numpy as np
import pytest
import torch

import vae_connexe_tpu.configs.experiments as jexp
from vae_connexe_torch import cli
from vae_connexe_torch.configs import EXPERIMENTS, get_experiment, run_experiment
from vae_connexe_torch.models import CRVAE, ErrorVAE
from vae_connexe_torch.utils import (
    enable_nan_debugging,
    load_gc,
    restore_checkpoint,
)
from vae_connexe_torch.utils.debug import nan_debugging_enabled
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(jexp.EXPERIMENTS))
def test_experiments_table_matches_jax(name):
    """Each entry, with every nested config, equals the JAX package's."""
    assert sorted(EXPERIMENTS) == sorted(jexp.EXPERIMENTS)
    got = dataclasses.asdict(get_experiment(name))
    assert got == dataclasses.asdict(jexp.get_experiment(name))
    assert [f.name for f in dataclasses.fields(EXPERIMENTS[name])] == [
        f.name for f in dataclasses.fields(jexp.Experiment)]


_BRANCHES = {"crvae": ('if exp.model_family == "crvae":',
                       'elif exp.model_family == "win":'),
             "win": ('elif exp.model_family == "win":',
                     'elif exp.model_family == "csrae":'),
             "csrae": ('elif exp.model_family == "csrae":',
                       'elif exp.model_family == "vrae":'),
             "vrae": ('elif exp.model_family == "vrae":',
                      'raise ValueError(f"unknown model family')}


def _jax_branch(family: str) -> str:
    """The source of the JAX package's ``run_experiment`` branch of
    ``family``."""
    src = pathlib.Path(jexp.__file__).read_text()
    start, end = _BRANCHES[family]
    return src[src.index(start):src.index(end)]


def _jax_crvae_result_keys(henon: bool = False) -> set[str]:
    """The keys the JAX package's ``run_experiment`` puts in the results of
    the crvae family, read from its source; the ``gc_dynamics`` rows only
    on the 2-D Henon system."""
    keys = set(re.findall(r'results\["(\w+)"\]\s*=', _jax_branch("crvae")))
    return {"experiment", "seed"} | {k for k in keys if henon
                                     or not k.startswith("gc_dynamics")}


def _jax_win_result_keys(family: str = "win") -> set[str]:
    """The keys of the JAX package's ``family`` branch (win, csrae, vrae),
    with ``csrae_eval_metrics``'s two for the csrae family."""
    extra = {"recon_accuracy", "loss"} if family == "csrae" else set()
    return {"experiment", "seed"} | extra | set(re.findall(
        r'results\["(\w+)"\]\s*=', _jax_branch(family)))


def _jax_files(family: str, name: str, pngs: bool = True) -> set[str]:
    """The files the JAX package's run of ``family`` writes under
    ``out_dir`` (without ``artifacts_every``, with ``save_checkpoints``),
    read from its source: each ``out / f"<stem>{name}<ext>"`` and each
    checkpoint (with its ``.gc.npy``)."""
    body = _jax_branch(family)
    files = {f"{stem}{name}{ext}" for stem, ext in re.findall(
        r'out / f"(\w+?)\{name\}(\.\w+)"', body)
        if pngs or ext != ".png"}
    for ck, rest in re.findall(
            r'save_checkpoint\(str\(out / "(\w+)"\),([^)]*\)?)', body):
        files |= {ck, f"{ck}.gc.npy"} if "gc_matrix" in rest else {ck}
    return files | {f"metrics_{name}.json"}


def test_cli_list(capsys):
    cli.main(["list"])
    out = capsys.readouterr().out
    assert all(name in out for name in EXPERIMENTS)
    assert "lorenz96_crvae       family=crvae" in out


def _run(tmp_path, capsys, *extra):
    """``cli run lorenz96_crvae`` at four steps a phase.  The figures (PCA
    and t-SNE fits, seconds each) are left out, as on a machine without
    matplotlib: ``test_cli_run_henon_author`` holds them."""
    out_dir = tmp_path / "run"
    with unittest.mock.patch.dict(sys.modules, {"matplotlib": None}):
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
    # A mesh is ported for the crvae family, as JAX's; an object that is
    # no mesh raises a TypeError, another family JAX's ValueError.
    from torch_ranks import world_of_one

    with pytest.raises(TypeError, match="make_mesh"):
        run_experiment("lorenz96_crvae", mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="--mesh supports the crvae family"):
        run_experiment("henon6d_win", mesh=world_of_one(), device="cpu")
    # Out of core is ported for the crvae family only, as JAX's.
    with pytest.raises(ValueError, match="crvae family"):
        run_experiment("henon6d_win", out_of_core=True, device="cpu")
    with pytest.raises(ValueError, match="crvae family"):
        run_experiment("henon6d_win", checkpoint_every=10, out_dir="o",
                       device="cpu")
    with pytest.raises(ValueError, match="out-dir"):
        run_experiment("lorenz96_crvae", resume=True, device="cpu")


def _series_csv(tmp_path) -> str:
    """A small (200, 4) series as a CSV with a header."""
    x = np.cumsum(np.random.default_rng(0).standard_normal((200, 4)),
                  axis=0) * 0.1
    path = tmp_path / "s.csv"
    np.savetxt(path, x, delimiter=",", header="a,b,c,d", comments="")
    return str(path)


def _cli_json(capsys, argv) -> dict:
    cli.main(argv)
    return json.loads(capsys.readouterr().out)


_DISCOVER = ["--context", "10", "--iters", "3", "--batch", "32",
             "--device", "cpu", "--quiet"]
_SWEEP = ["sweep", "--p", "4", "--t", "300", "--seeds", "2", "--iters", "4",
          "--batch", "32", "--device", "cpu"]


@pytest.mark.parametrize("case", [
    "mesh", "ep", "sp", "processes", "export-csrae", "discover-mesh",
    "discover-ep", "discover-win", "discover-prox", "sweep-mesh"])
def test_unported_flags_exit(case, crvae_run, tmp_path, capsys):
    """The reference's mesh flags, once left out, now work with JAX's
    composition rules, and an export of a family without a generator
    artifact exits with the JAX package's message.  In this process
    ``--mesh`` is a world of one rank (bit for bit the unmeshed command);
    ``--processes 2 --ep 2`` starts two gloo CPU ranks (within the JAX
    package's tolerances of the single-process run)."""
    if case == "mesh":
        assert _run(tmp_path, capsys, "--mesh")[1] == crvae_run[1]
    elif case == "ep":
        got = _cli_json(capsys, [
            "run", "lorenz96_crvae", "--processes", "2", "--ep", "2",
            "--iters", "4", "--device", "cpu", "--out-dir",
            str(tmp_path / "mp")])
        want = crvae_run[1]
        assert got["mesh"] == {"dp": 1, "ep": 2} and got["ranks"] == 2
        for phase in ("phase1", "phase2"):
            assert got[phase].keys() == want[phase].keys()
            for k in got[phase]:
                assert np.isclose(got[phase][k], want[phase][k], rtol=1e-3,
                                  atol=1e-5), (phase, k)
        for k in got["gc"]:
            assert np.isclose(got["gc"][k], want["gc"][k], atol=1e-6), k
    elif case == "sp":
        with pytest.raises(SystemExit, match="--sp not supported "
                                             "multi-process"):
            cli.main(["run", "lorenz96_crvae", "--processes", "2", "--sp",
                      "2"])
    elif case == "processes":
        with pytest.raises(SystemExit, match="--save-checkpoints not "
                                             "supported multi-process"):
            cli.main(["run", "lorenz96_crvae", "--processes", "2",
                      "--save-checkpoints"])
        with pytest.raises(SystemExit, match="require --out-dir"):
            cli.main(["run", "lorenz96_crvae", "--processes", "2",
                      "--resume"])
    elif case == "export-csrae":
        with pytest.raises(SystemExit,
                           match="export supports the crvae and win "
                                 "families; 'csrae_binarized' is 'csrae'"):
            cli.main(["export", "csrae_binarized", "ck", "--out", "g",
                      "--device", "cpu"])
    elif case in ("discover-mesh", "discover-prox"):
        extra = (["--family", "win", "--prox", "row", "--seeds", "2"]
                 if case == "discover-prox" else [])
        argv = ["discover", _series_csv(tmp_path), *_DISCOVER, *extra]
        assert (_cli_json(capsys, argv + ["--mesh"])
                == _cli_json(capsys, argv))
    elif case == "discover-ep":
        with pytest.raises(ValueError, match="cannot infer n_dp"):
            cli.main(["discover", _series_csv(tmp_path), *_DISCOVER,
                      "--mesh", "--ep", "2"])
    elif case == "discover-win":
        with pytest.raises(ValueError, match="SEED axis"):
            cli.main(["discover", _series_csv(tmp_path), *_DISCOVER,
                      "--family", "win", "--mesh"])
    else:
        assert (_cli_json(capsys, _SWEEP + ["--mesh"])
                == _cli_json(capsys, _SWEEP))


@pytest.fixture(scope="module")
def crvae_run(tmp_path_factory):
    """One in-memory ``cli run lorenz96_crvae`` at four steps a phase with
    its checkpoints: (out dir, results), the flags' yardstick."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("mem") / "run"
    buf = io.StringIO()
    with unittest.mock.patch.dict(sys.modules, {"matplotlib": None}), \
            contextlib.redirect_stdout(buf):
        cli.main(["run", "lorenz96_crvae", "--iters", "4", "--device", "cpu",
                  "--out-dir", str(out), "--quiet", "--save-checkpoints"])
    return out, json.loads(buf.getvalue())


@pytest.mark.parametrize("case", ["out-of-core", "artifacts-every", "bf16",
                                  "platforms", "export-win"])
def test_ported_flags_work(case, crvae_run, tmp_path, capsys):
    """The flags ROADMAP A5 and A6 brought: ``run --out-of-core`` (also with
    ``--artifacts-every``) gives the in-memory run's results; ``export
    --serve-dtype bfloat16`` (crvae and win) and ``--platforms`` write
    artifacts that say so and sample."""
    mem_out, mem_res = crvae_run
    name = "lorenz96_crvae"
    if case in ("out-of-core", "artifacts-every"):
        extra = ["--artifacts-every", "2"] if case == "artifacts-every" else []
        out, res = _run(tmp_path, capsys, "--out-of-core", *extra)
        assert res == mem_res
        exp = get_experiment(name)
        assert (out / f"series_{name}.f32").stat().st_size == \
            exp.t * exp.p * 4
        # One chunk of 4 steps: the callback fires once, at step 4.
        assert (out / f"syn_{name}_it4.npy").exists() == bool(extra)
        return
    art = str(tmp_path / "g.vcxt")
    if case == "export-win":
        from vae_connexe_torch.models import WInCRVAE
        from vae_connexe_torch.utils import save_checkpoint

        exp = get_experiment("henon6d_win")
        model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                         tau=exp.tau)
        ckpt = str(tmp_path / "ckpt_win")
        save_checkpoint(ckpt, model.init(torch.Generator().manual_seed(1),
                                         "cpu"))
        cli.main(["export", "henon6d_win", ckpt, "--out", art, "--batch",
                  "2", "--serve-dtype", "bfloat16", "--device", "cpu"])
    else:
        flags = (["--serve-dtype", "bfloat16"] if case == "bf16"
                 else ["--platforms", "cpu", "cuda"])
        cli.main(["export", name, str(mem_out / "ckpt_phase2"), "--out", art,
                  "--batch", "4", "--device", "cpu", *flags])
    made = json.loads(capsys.readouterr().out)
    assert made["serve_dtype"] == ("float32" if case == "platforms"
                                   else "bfloat16")
    assert made["platforms"] == (["cpu", "cuda"] if case == "platforms"
                                 else ["cpu"])
    if case == "export-win":
        ctx = tmp_path / "ctx.npy"
        np.save(ctx, np.zeros((2, exp.tau, exp.p), np.float32))
        cli.main(["generate", art, "--context", str(ctx), "--device", "cpu"])
    else:
        cli.main(["generate", art, "--device", "cpu"])
    got = json.loads(capsys.readouterr().out)
    assert got["meta"]["serve_dtype"] == made["serve_dtype"]
    assert got["meta"]["platforms"] == made["platforms"]


# Each A4 run cut where a CPU run would take long (the keys and files do
# not depend on the cuts): lorenz96_crcsrae to 4 steps a phase at batch
# 256 (from 2048 and 1024), csrae_binarized's 30 epochs to 2; vrae_demo
# runs its own 100 epochs.
_A4_RUNS = {
    "lorenz96_crcsrae": ("crvae", ["--iters", "4"], lambda exp: {
        "phase1": dataclasses.replace(exp.phase1, batch_size=256),
        "phase2": dataclasses.replace(exp.phase2, batch_size=256)}),
    "csrae_binarized": ("csrae", [], lambda exp: {
        "csrae": dataclasses.replace(exp.csrae, epochs=2)}),
    "vrae_demo": ("vrae", [], lambda exp: {}),
}


@pytest.mark.parametrize("name", sorted(_A4_RUNS))
def test_cli_run_eval_a4_experiments(tmp_path, capsys, monkeypatch, name):
    """``run`` of the cs, csrae and vrae experiments returns the JAX
    package's keys and writes its files (figures aside: matplotlib made
    unimportable, as on the card's machine); ``eval`` of the checkpoint it
    saved rescores it and samples."""
    family, argv, cut = _A4_RUNS[name]
    exp = get_experiment(name)
    monkeypatch.setitem(EXPERIMENTS, name,
                        dataclasses.replace(exp, **cut(exp)))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "run"
    cli.main(["run", name, *argv, "--device", "cpu", "--out-dir", str(out),
              "--save-checkpoints", "--quiet"])
    res = json.loads(capsys.readouterr().out)
    want = (_jax_crvae_result_keys() if family == "crvae"
            else _jax_win_result_keys(family))
    assert set(res) == want
    assert {p.name for p in out.iterdir()} == _jax_files(family, name,
                                                         pngs=False)
    assert json.loads((out / f"metrics_{name}.json").read_text()) == res

    ckpt = {"crvae": "ckpt_phase1", "csrae": "ckpt_csrae",
            "vrae": "ckpt_vrae"}[family]
    cli.main(["eval", name, str(out / ckpt), "--generate", "3", "--device",
              "cpu"])
    ev = json.loads(capsys.readouterr().out)
    if family == "crvae":
        assert res["generated_shape"] == [256, 21, 10]
        assert res["phase1"]["latent_reg"] >= 0
        assert EXPERIMENTS[name].phase2.latent_reg == "cs"
        assert ev["gc"] == pytest.approx(res["gc"], nan_ok=True)
        assert ev["generated_shape"] == [3, 21, 10]
    elif family == "csrae":
        assert res["generated_shape"] == [64, 200]
        assert res["train"].keys() == res["initial"].keys() == {
            "total", "bce", "cs"}
        assert res["loss"]["total"] < res["initial"]["total"]
        assert set(ev) == {"experiment", "checkpoint", "recon_accuracy",
                           "loss", "generated_shape"}
        assert 0.5 < ev["recon_accuracy"] <= 1 and ev["generated_shape"] == [
            3, 200]
    else:
        assert res["generated_shape"] == [5, 20, 10]
        assert res["train"].keys() == {"total", "rec", "kld", "tf_ratio"}
        assert res["train"]["tf_ratio"] == pytest.approx(0.98 ** 99)
        assert ev == {"experiment": name, "checkpoint": str(out / ckpt),
                      "generated_shape": [3, 20, 10]}


def test_cli_run_debug_nans(capsys, monkeypatch):
    """``run --debug-nans`` turns nan debugging on for the run (the loops'
    checks, autograd's anomaly mode) and the run completes."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    try:
        cli.main(["run", "lorenz96_crvae", "--iters", "2", "--no-phase2",
                  "--device", "cpu", "--quiet", "--debug-nans"])
        assert nan_debugging_enabled() and torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    res = json.loads(capsys.readouterr().out)
    assert np.isfinite(res["phase1"]["loss"]) and "phase2" not in res


# ---------------- the Henon and VAR experiments, the W_in family ----------


# Each win run cut to a few steps an epoch (henon6d_win's series from 3000
# steps to 600; var_crvae's batch from 16 to 128) and 3 stability seeds:
# the keys and the files do not depend on the sizes.
_WIN_CUTS = {"henon6d_win": lambda exp: {"t": 600},
             "var_crvae": lambda exp: {"win": dataclasses.replace(
                 exp.win, batch_size=128)}}


@pytest.mark.parametrize("name", ["henon6d_win", "var_crvae"])
def test_cli_run_win_family(tmp_path, capsys, monkeypatch, name):
    """``run`` of a win experiment (epochs cut by ``--iters 20``, the
    series or batch and the stability seeds by ``_WIN_CUTS``) returns the
    JAX package's keys and writes its files, figures included; ``eval``
    rescores ``ckpt_win`` to the run's GC row; ``export`` -> ``generate
    --context`` samples, and a context of the wrong shape is refused."""
    exp = get_experiment(name)
    exp = dataclasses.replace(exp, stability_seeds=3, **_WIN_CUTS[name](exp))
    monkeypatch.setitem(EXPERIMENTS, name, exp)
    out = tmp_path / "run"
    cli.main(["run", name, "--iters", "20", "--device", "cpu", "--out-dir",
              str(out), "--save-checkpoints", "--quiet"])
    res = json.loads(capsys.readouterr().out)
    assert set(res) == _jax_win_result_keys()
    assert {p.name for p in out.iterdir()} == _jax_files("win", name)
    assert json.loads((out / f"metrics_{name}.json").read_text()) == res
    assert res["generated_shape"] == [8, 20, exp.p]
    assert res["train"].keys() == {"loss", "recon", "kl"}
    stab = res["gc_stability"]
    assert stab["seeds"] == 3 and len(stab["votes_offdiag"]) == exp.p * (exp.p - 1)
    assert res["gc_offdiag_best_threshold"]["oracle"] is True
    assert all(np.isfinite(v) for v in res["prediction_mse"].values())

    cli.main(["eval", name, str(out / "ckpt_win"), "--generate", "3",
              "--device", "cpu"])
    ev = json.loads(capsys.readouterr().out)
    assert ev["gc"] == pytest.approx(res["gc"], nan_ok=True)
    assert ev["generated_shape"] == [3, 20, exp.p]

    art, ctx = str(tmp_path / "w.vcxt"), tmp_path / "ctx.npy"
    cli.main(["export", name, str(out / "ckpt_win"), "--out", art, "--batch",
              "2", "--length", "5", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["batch"] == 2
    np.save(ctx, np.random.default_rng(0).normal(
        size=(2, 2 * exp.tau + 1, exp.p)).astype(np.float32))   # > tau
    cli.main(["generate", art, "--seed", "2", "--context", str(ctx),
              "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["shape"] == [2, 5, exp.p]
    with pytest.raises(SystemExit, match="context-conditioned"):
        cli.main(["generate", art, "--device", "cpu"])
    np.save(ctx, np.zeros((3, exp.tau, exp.p), np.float32))
    with pytest.raises(ValueError, match="context shape"):
        cli.main(["generate", art, "--context", str(ctx), "--device", "cpu"])
    with pytest.raises(SystemExit, match="serve-kernel"):
        cli.main(["export", name, str(out / "ckpt_win"), "--out", art,
                  "--serve-kernel", "fused", "--device", "cpu"])


def test_cli_run_henon_author(tmp_path, capsys):
    """The crvae family on the 2-D Henon map: the JAX package's keys with
    its ``gc_dynamics`` rows, its files and figures, and with
    ``--artifacts-every`` the periodic sample and its two figures at the
    first phase-2 chunk at or after each period."""
    name, out = "henon_author", tmp_path / "run"
    cli.main(["run", name, "--iters", "4", "--artifacts-every", "3",
              "--device", "cpu", "--out-dir", str(out), "--save-checkpoints",
              "--quiet"])
    res = json.loads(capsys.readouterr().out)
    assert set(res) == _jax_crvae_result_keys(henon=True)
    periodic = {f"syn_{name}_it4.npy", f"pca_{name}_it4.png",
                f"traj_{name}_it4.png"}
    assert {p.name for p in out.iterdir()} == (_jax_files("crvae", name)
                                               | periodic)
    assert np.load(out / f"syn_{name}_it4.npy").shape == (256, 10, 2)
    assert res["gc_dynamics_best_threshold"]["accuracy"] >= \
        res["gc_dynamics"]["accuracy"] - 1e-6
    cli.main(["eval", name, str(out / "ckpt_phase1"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["gc"] == pytest.approx(
        res["gc"], nan_ok=True)


def test_run_without_matplotlib_names_the_figures_it_skips(tmp_path, capsys,
                                                            monkeypatch):
    """Where matplotlib cannot be imported the run writes every array and
    metric, and one stderr line names the figures it did not write."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    name, out = "henon_author", tmp_path / "run"
    cli.main(["run", name, "--iters", "2", "--device", "cpu", "--out-dir",
              str(out), "--quiet"])
    cap = capsys.readouterr()
    assert set(json.loads(cap.out)) == _jax_crvae_result_keys(henon=True)
    pngs = sorted(f for f in _jax_files("crvae", name) if f.endswith(".png"))
    line, = [ln for ln in cap.err.splitlines() if "figures not written" in ln]
    assert line == (f"figures not written (matplotlib cannot be imported): "
                    f"{', '.join(sorted(pngs, key=line.index))}")
    assert {p.name for p in out.iterdir()} == {
        f for f in _jax_files("crvae", name) if not f.endswith(".png")
        and not f.startswith("ckpt")}


def test_cli_discover_win_element(tmp_path, capsys):
    """``discover --family win --prox element`` on a CSV, 3 seeds folded
    into one fit, with generation and the output files."""
    import jax

    from vae_connexe_tpu.data import var_process, var_truth

    series = np.asarray(var_process(jax.random.key(1), var_truth(4), n=1,
                                    t=240))[0]
    csv = tmp_path / "v.csv"
    np.savetxt(csv, series, delimiter=",", header="a,b,c,d", comments="")
    out = tmp_path / "d"
    cli.main(["discover", str(csv), "--family", "win", "--prox", "element",
              "--context", "8", "--iters", "3", "--batch", "64", "--seeds",
              "3", "--generate", "4", "--out-dir", str(out), "--device",
              "cpu", "--quiet"])
    res = json.loads(capsys.readouterr().out)
    assert res["family"] == "win" and res["seeds"] == 3
    assert res["variables"] == ["a", "b", "c", "d"]
    assert np.load(out / "generated_v.npy").shape == (4, 8, 4)
    assert np.load(out / "GC_votes_v.npy").shape == (4, 4)
    assert (out / "discovery_v.png").exists()
