"""The port's discovery path against the JAX package's: stability selection
and its vote helpers, ``load_series``, ``discover`` (preprocessing, window
pooling, the seeds' vote, phase 2 and generation, validation) and ``cli
discover`` / ``cli sweep``.

Inputs are made with numpy (or by the JAX package's ``var_process``) and go
through both packages; on the CPU every recurrence runs its plain version.
Tolerances: votes 1e-7, preprocessing 5e-7 (``standardize`` in float32),
everything else equal.
"""

import inspect
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_connexe_tpu.cli as jcli
from vae_connexe_torch import cli
from vae_connexe_torch import discover as discover_fn
from vae_connexe_torch.data.io import load_series
from vae_connexe_torch.evals import (
    auto_vote_threshold,
    stability_selection,
    vote_confidence,
)
from vae_connexe_tpu.data import var_process, var_truth
from vae_connexe_tpu.data.io import load_series as jax_load_series
from vae_connexe_tpu.evals import stability_selection as jax_stability_selection
from vae_connexe_tpu.evals import vote_confidence as jax_vote_confidence
from vae_connexe_tpu.evals.gc_metrics import (
    auto_vote_threshold as jax_auto_vote_threshold,
)
from vae_connexe_tpu.utils.scalers import standardize as jax_standardize
from torch_threads import one_torch_thread  # noqa: F401

disc = sys.modules["vae_connexe_torch.discover"]
jdisc = sys.modules["vae_connexe_tpu.discover"]
SMALL = dict(context=10, hidden=12, batch_size=32, device="cpu")


@pytest.fixture(scope="module")
def var_series():
    a = var_truth(4)
    return np.asarray(var_process(jax.random.key(0), a, n=1, t=300))[0]


def _score_stack(kind: str) -> np.ndarray:
    rng = np.random.default_rng(3)
    if kind == "tied":
        one = rng.lognormal(size=(6, 6)).astype(np.float32)
        return np.stack([one] * 4)
    return rng.lognormal(sigma=2.0, size=(5, 6, 6)).astype(np.float32)


@pytest.mark.parametrize("kind,min_frac,diag", [
    ("spread", 0.5, False), ("spread", 0.7, True), ("spread", "auto", False),
    ("spread", "auto", True), ("tied", "auto", False)],
    ids=["fixed", "fixed-diag", "auto", "auto-diag", "tied"])
def test_stability_selection_matches_jax(kind, min_frac, diag):
    """Votes within 1e-7, the same selection and resolved threshold, and
    the vote helpers equal on those votes."""
    stack = _score_stack(kind)
    votes, sel, thr = stability_selection(torch.tensor(stack), min_frac, diag)
    jv, jsel, jthr = jax_stability_selection(jnp.asarray(stack), min_frac,
                                             diag)
    np.testing.assert_allclose(votes.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert sel.dtype == torch.int32 and thr == jthr
    assert auto_vote_threshold(votes, diag) == jax_auto_vote_threshold(jv, diag)
    for excl in (True, False):
        assert vote_confidence(votes, excl) == jax_vote_confidence(jv, excl)


def test_vote_confidence_on_the_committed_demos():
    """NARMA reads high, Rossler low (results/discover_demo), as in JAX."""
    import pathlib

    demo = pathlib.Path(__file__).parent.parent / "results" / "discover_demo"
    narma = np.load(demo / "GC_votes_narma.npy")
    rossler = np.load(demo / "GC_votes_rossler.npy")
    assert vote_confidence(narma) >= 0.7
    assert vote_confidence(rossler) <= 0.3
    assert vote_confidence(torch.tensor(narma)) == jax_vote_confidence(narma)


def _write(kind, d, series):
    """(path, kwargs) of one load_series case."""
    p = series.shape[1]
    if kind == "npy":
        np.save(d / "s.npy", series)
        return d / "s.npy", {}
    if kind == "npz":
        np.savez(d / "s.npz", other=np.zeros(3), series=series)
        return d / "s.npz", {}
    if kind == "npz_first":
        np.savez(d / "s.npz", a=series)
        return d / "s.npz", {}
    if kind == "csv_header":
        np.savetxt(d / "s.csv", series, delimiter=",", comments="",
                   header=",".join(f"var{i}" for i in range(p)))
        return d / "s.csv", {}
    if kind == "csv":
        np.savetxt(d / "s.csv", series, delimiter=",")
        return d / "s.csv", {}
    if kind == "tsv":
        np.savetxt(d / "s.tsv", series, delimiter="\t")
        return d / "s.tsv", {}
    if kind == "txt":
        np.savetxt(d / "s.txt", series)
        return d / "s.txt", {}
    if kind == "delimiter":
        np.savetxt(d / "s.csv", series, delimiter=";")
        return d / "s.csv", {"delimiter": ";"}
    if kind in ("raw", "raw_no_shape", "raw_wrong_size"):
        series.astype(np.float32).tofile(d / "s.f32")
        shape = {"raw": series.shape, "raw_no_shape": None,
                 "raw_wrong_size": (7, 7)}[kind]
        return d / "s.f32", {"shape": shape}
    if kind == "one_d":
        np.save(d / "s.npy", np.arange(64, dtype=np.float32))
        return d / "s.npy", {}
    if kind == "stack":
        np.save(d / "s.npy", np.stack([series[:100], series[100:200]]))
        return d / "s.npy", {}
    if kind == "nan":
        np.save(d / "s.npy", np.array([[1.0, np.nan]] * 20))
        return d / "s.npy", {}
    if kind == "four_d":
        np.save(d / "s.npy", np.zeros((2, 2, 2, 2)))
        return d / "s.npy", {}
    if kind == "few_steps":
        np.save(d / "s.npy", np.zeros((3, 4)))
        return d / "s.npy", {}
    if kind == "missing":
        return d / "missing.npy", {}
    if kind == "header_mismatch":
        (d / "s.csv").write_text("a,b,c\n" + "1,2\n" * 20)
        return d / "s.csv", {}
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", [
    "npy", "npz", "npz_first", "csv_header", "csv", "tsv", "txt",
    "delimiter", "raw", "one_d", "stack", "raw_no_shape", "raw_wrong_size",
    "nan", "four_d", "few_steps", "missing", "header_mismatch"])
def test_load_series_matches_jax(kind, tmp_path, var_series):
    """Every format and every error of the JAX package's loader: the same
    array and names, or the same exception and message."""
    path, kw = _write(kind, tmp_path, var_series)
    try:
        want = jax_load_series(str(path), **kw)
    except (ValueError, FileNotFoundError) as e:
        with pytest.raises(type(e)) as got:
            load_series(str(path), **kw)
        assert str(got.value) == str(e)
        return
    series, names = load_series(str(path), **kw)
    assert series.dtype == np.float32 and names == want[1]
    np.testing.assert_array_equal(series, want[0])


@pytest.mark.parametrize("diff", [False, True])
@pytest.mark.parametrize("stack", [False, True], ids=["series", "stack"])
def test_preprocessing_and_windows_match_jax(var_series, diff, stack):
    """``diff`` then ``standardize`` along time, and the pooled windows of a
    (T, p) series or an (N, T, p) stack, as the JAX package's."""
    x = np.stack([var_series[:150], var_series[150:]]) if stack else var_series
    t_axis = x.ndim - 2
    ref = jnp.asarray(x)
    if diff:
        ref = jnp.diff(ref, axis=t_axis)
    ref = jax_standardize(ref, axis=t_axis)
    got = disc._preprocess(x, 10, diff, True, None, "cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=5e-7)
    wins = disc._pool_windows(torch.tensor(np.asarray(ref)), 10)
    np.testing.assert_array_equal(wins.numpy(),
                                  np.asarray(jdisc._pool_windows(ref, 10)))


def test_vote_postprocessing_matches_jax():
    """On one seed_scores stack (an even count of seeds): the same votes,
    graph, threshold, seed-median scores, confidence and edge order as the
    JAX package's post-processing."""
    stack = _score_stack("spread")[:4]
    votes, gc, thr, scores = disc.stability_summary(stack, "auto")
    jv, jsel, jthr = jax_stability_selection(jnp.asarray(stack), "auto")
    jscores = np.asarray(jnp.median(jnp.asarray(stack), axis=0))
    np.testing.assert_allclose(votes, np.asarray(jv), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(gc, np.asarray(jsel))
    np.testing.assert_array_equal(scores, jscores)
    assert thr == jthr
    names = [f"v{i}" for i in range(6)]
    kw = dict(seed_scores=stack, params=None, model=None, names=names,
              metrics={})
    ours = disc.DiscoveryResult(scores=scores, gc=gc, threshold=thr,
                                votes=votes, confidence=vote_confidence(votes),
                                **kw)
    ref = jdisc.DiscoveryResult(scores=jscores, gc=np.asarray(jsel),
                                threshold=jthr, votes=np.asarray(jv),
                                confidence=jax_vote_confidence(jv), **kw)
    assert ours.confidence == ref.confidence
    assert ours.edges() == ref.edges() and ours.edges(1.0) == ref.edges(1.0)


def test_discover_one_seed(var_series):
    res = discover_fn(var_series, max_iter=20, **SMALL)
    assert res.gc.shape == res.scores.shape == (4, 4)
    assert res.gc.dtype == np.int32 and set(np.unique(res.gc)) <= {0, 1}
    assert res.votes is None and res.seed_scores is None
    assert res.confidence is None and res.params is not None
    np.testing.assert_array_equal(res.gc, (res.scores > res.threshold))
    assert set(res.metrics) == {"loss", "recon", "latent_reg", "mean_loss",
                                "variable_usage"}
    fixed = discover_fn(var_series, max_iter=20, threshold=1e9, **SMALL)
    assert fixed.gc.sum() == 0 and fixed.threshold == 1e9


def test_discover_seeds_vote_on_the_seed_median(var_series):
    """seeds=4: the reported scores are the seed median (an even count),
    the vote threshold is clamped, and seed s of the sweep is the
    single-seed discover(seed=s): the one seed-to-generator rule."""
    res = discover_fn(var_series, max_iter=10, seeds=4, seed=3, **SMALL)
    assert res.seed_scores.shape == (4, 4, 4) and res.votes.shape == (4, 4)
    np.testing.assert_array_equal(res.scores,
                                  np.median(res.seed_scores, axis=0))
    assert 0.5 <= res.threshold <= 0.95
    assert 0.0 <= res.confidence <= 1.0 and res.params is None
    assert set(res.metrics) == {"mean_loss", "best_loss"}
    one = discover_fn(var_series, max_iter=10, seed=4, **SMALL)
    np.testing.assert_allclose(res.seed_scores[1], one.scores, rtol=1e-5)


def test_discover_generate(var_series):
    res = discover_fn(var_series, max_iter=20, generate=8, phase2_iters=5,
                      **SMALL)
    assert res.samples.shape == (8, 21, 4) and np.isfinite(res.samples).all()
    assert res.err_params is not None
    assert {k for k in res.metrics if k.startswith("phase2_")} == {
        "phase2_recon", "phase2_latent_reg", "phase2_mean_loss",
        "phase2_loss_e", "phase2_kl_e"}


def test_discover_diff_equals_differenced_input(var_series):
    a = discover_fn(var_series, max_iter=5, diff=True, **SMALL)
    b = discover_fn(np.diff(var_series, axis=0), max_iter=5, **SMALL)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_discover_validation(var_series):
    with pytest.raises(ValueError, match="context"):
        discover_fn(var_series[:8], max_iter=1, **SMALL)
    with pytest.raises(ValueError, match="names"):
        discover_fn(var_series, max_iter=1, names=["only-one"], **SMALL)
    with pytest.raises(ValueError, match="enc_len"):
        discover_fn(var_series, max_iter=1, enc_len=10, **SMALL)
    with pytest.raises(ValueError, match="empty"):
        discover_fn(var_series, max_iter=2, threshold=1e9, generate=4,
                    **SMALL)
    with pytest.raises(ValueError, match="family"):
        discover_fn(var_series, family="mystery", **SMALL)
    with pytest.raises(ValueError, match="win"):
        discover_fn(var_series, prox="row", **SMALL)
    # Meshes, with the JAX package's rules: the win family shards only
    # its seed axis; an object that is no mesh raises a TypeError; a world
    # of one rank discovers what the unmeshed call does.
    from torch_ranks import world_of_one

    mesh = world_of_one()
    with pytest.raises(ValueError, match="SEED axis"):
        discover_fn(var_series, family="win", seeds=1, mesh=mesh, **SMALL)
    with pytest.raises(TypeError, match="make_mesh"):
        discover_fn(var_series, mesh=object(), **SMALL)
    meshed = discover_fn(var_series, max_iter=3, mesh=mesh, **SMALL)
    plain = discover_fn(var_series, max_iter=3, **SMALL)
    np.testing.assert_array_equal(meshed.scores, plain.scores)
    assert meshed.metrics == plain.metrics


def _dict_keys(fn, var: str) -> set[str]:
    """The string keys of the dict literal assigned to or dumped as ``var``
    in ``fn``'s source (the JAX package's command line)."""
    src = inspect.getsource(fn)
    body = src[src.index(var):]
    body = body[:body.index("\n    }")]
    return set(re.findall(r'^\s+"(\w+)":', body, re.M))


def _csv(tmp_path, series):
    path = tmp_path / "mine.csv"
    np.savetxt(path, series, delimiter=",", comments="",
               header=",".join(f"x{i}" for i in range(series.shape[1])))
    return path


@pytest.mark.parametrize("extra", [[], ["--seeds", "2", "--generate", "4",
                                        "--phase2-iters", "3"]],
                         ids=["one-seed", "seeds-generate"])
def test_cli_discover_out_dir(tmp_path, capsys, var_series, extra):
    """The JAX command's JSON keys; with --out-dir its .npy files, the
    heatmap and the JSON summary."""
    pytest.importorskip("matplotlib")
    data, out = _csv(tmp_path, var_series), tmp_path / "out"
    cli.main(["discover", str(data), "--context", "10", "--hidden", "12",
              "--iters", "10", "--batch", "32", "--out-dir", str(out),
              "--quiet", "--device", "cpu", *extra])
    summary = json.loads(capsys.readouterr().out)
    assert set(summary) == _dict_keys(jcli._cmd_discover, "summary = {") | {
        "artifacts"}
    assert summary["variables"] == [f"x{i}" for i in range(4)]
    assert summary["n_edges"] == len(summary["edges"])
    files = {"GC_mine.npy", "GC_scores_mine.npy", "discovery_mine.png",
             "discovery_mine.json"}
    if extra:
        files |= {"GC_votes_mine.npy", "generated_mine.npy"}
        assert np.load(out / "generated_mine.npy").shape == (4, 21, 4)
    assert {f.name for f in out.iterdir()} == files
    saved = json.loads((out / "discovery_mine.json").read_text())
    assert saved == {k: v for k, v in summary.items() if k != "artifacts"}
    assert np.load(out / "GC_mine.npy").shape == (4, 4)


def test_cli_discover_warns_on_low_confidence(tmp_path, capsys, monkeypatch):
    """The JAX command's warning on stderr below 0.5 confidence; the
    confidence in the JSON."""
    fake = disc.DiscoveryResult(
        scores=np.ones((4, 4), np.float32), gc=np.ones((4, 4), np.int32),
        threshold=0.9, votes=np.ones((4, 4), np.float32), seed_scores=None,
        params=None, model=None, names=None, metrics={}, confidence=0.2)
    monkeypatch.setattr(disc, "discover", lambda *a, **k: fake)
    data = tmp_path / "dense.csv"
    np.savetxt(data, np.random.default_rng(0).normal(size=(64, 4)),
               delimiter=",")
    cli.main(["discover", str(data), "--seeds", "4", "--quiet", "--device",
              "cpu"])
    out = capsys.readouterr()
    assert ("WARNING: low discovery confidence (0.20 < 0.5) — the seed "
            "ensemble rules out only 20% of candidate edges (12/12 "
            "off-diagonal edges selected)") in out.err
    assert "--diff" in out.err
    assert json.loads(out.out)["confidence"] == 0.2


def test_cli_sweep(capsys):
    """p=4, t=300, 3 seeds, 20 steps: the JAX command's JSON keys."""
    cli.main(["sweep", "--p", "4", "--t", "300", "--seeds", "3", "--iters",
              "20", "--batch", "32", "--device", "cpu"])
    res = json.loads(capsys.readouterr().out)
    assert set(res) == _dict_keys(jcli._cmd_sweep, "json.dumps({")
    assert res["seeds"] == 3 and len(res["aurocs"]) == 3
    assert len(res["mean_loss"]) == 3 and res["stability_min_frac"] == 0.5
    assert {"accuracy", "precision", "recall", "f1", "auroc",
            "variable_usage", "true_usage",
            "auroc_offdiag"} == set(res["stability_selection"])
