"""The port's data, losses, prox and GC metrics against the JAX package, on
the same numpy-seeded inputs (CPU).

Tolerance 1e-5 throughout (float32), exact equality where the function
only gathers, compares or counts, and 1e-3 for Lorenz-96 over 30 RK4 steps:
the system is chaotic, and two float32 integrations that differ by one
rounding (XLA contracts some products into FMAs) part by ~2e-4 in the
standardised series within 30 steps and by ~1e-2 within 60.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch.data import (
    arrange_input,
    lorenz96,
    lorenz96_truth,
    sample_batch,
    sliding_windows,
)
from vae_connexe_torch.losses import group_lasso_value, kl_gaussian, ridge_value
from vae_connexe_torch.optim import prox_column_groups
from vae_connexe_torch.utils.scalers import standardize
from vae_connexe_tpu import data as jdata
from vae_connexe_tpu.losses import kl as jkl
from vae_connexe_tpu.losses import penalties as jpen
from vae_connexe_tpu.optim import prox as jprox
from vae_connexe_tpu.utils import scalers as jscalers
from torch_threads import one_torch_thread  # noqa: F401

# The modules (each package's ``evals`` re-exports a function of the name).
tgc = importlib.import_module("vae_connexe_torch.evals.gc_metrics")
jgc = importlib.import_module("vae_connexe_tpu.evals.gc_metrics")

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def test_lorenz96_matches_jax_on_injected_draws():
    """The two standard-normal draws JAX takes from its key, handed to the
    port: x0 (p,) and the observation noise (burn_in + t, p)."""
    p, t, burn_in = 6, 20, 10
    key = jax.random.key(3)
    ref = jdata.lorenz96(key, p=p, t=t, burn_in=burn_in)
    k_init, k_noise = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(k_init, (p,)))
    noise = np.asarray(jax.random.normal(k_noise, (burn_in + t, p)))
    got = lorenz96(p=p, t=t, burn_in=burn_in, x0_draw=torch.tensor(x0),
                   noise_draw=torch.tensor(noise), device="cpu")
    assert got.shape == (t, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-3)


def test_lorenz96_draws_from_a_generator():
    a = lorenz96(torch.Generator().manual_seed(0), p=5, t=40, burn_in=5,
                 device="cpu")
    b = lorenz96(torch.Generator().manual_seed(0), p=5, t=40, burn_in=5,
                 device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    _close(a.mean(0), np.zeros(5))
    with pytest.raises(ValueError, match="generator"):
        lorenz96(p=5, t=40, device="cpu")


@pytest.mark.parametrize("p", [4, 10])
def test_lorenz96_truth_matches_jax(p):
    np.testing.assert_array_equal(lorenz96_truth(p, "cpu").numpy(),
                                  np.asarray(jdata.lorenz96_truth(p)))


def test_standardize_is_population_std():
    x = _rng(0).normal(2.0, 3.0, size=(30, 4)).astype(np.float32)
    got = standardize(torch.tensor(x))
    _close(got, jscalers.standardize(jnp.asarray(x)))
    _close(got.std(0, correction=0), np.ones(4))


def test_arrange_input_and_sliding_windows_match_jax():
    s = _rng(1).normal(size=(25, 3)).astype(np.float32)
    got_in, got_tgt = arrange_input(torch.tensor(s), 6)
    ref_in, ref_tgt = jdata.arrange_input(jnp.asarray(s), 6)
    np.testing.assert_array_equal(got_in.numpy(), np.asarray(ref_in))
    np.testing.assert_array_equal(got_tgt.numpy(), np.asarray(ref_tgt))
    np.testing.assert_array_equal(sliding_windows(torch.tensor(s), 6).numpy(),
                                  np.asarray(jdata.sliding_windows(jnp.asarray(s), 6)))


def test_sample_batch_gathers_the_drawn_rows():
    w = torch.tensor(_rng(2).normal(size=(12, 5, 3)).astype(np.float32))
    key = jax.random.key(4)
    ref = jdata.sample_batch(key, jnp.asarray(w.numpy()), 7)
    idx = torch.tensor(np.asarray(jax.random.randint(key, (7,), 0, 12)))
    np.testing.assert_array_equal(sample_batch(None, w, 7, idx=idx).numpy(),
                                  np.asarray(ref))
    drawn = sample_batch(torch.Generator().manual_seed(0), w, 9)
    assert drawn.shape == (9, 5, 3)


def test_kl_and_penalties_match_jax():
    rng = _rng(3)
    mu, lv = rng.normal(size=(8, 5)), rng.normal(size=(8, 5))
    mu, lv = mu.astype(np.float32), lv.astype(np.float32)
    _close(kl_gaussian(torch.tensor(mu), torch.tensor(lv)),
           jkl.kl_gaussian(jnp.asarray(mu), jnp.asarray(lv)))
    ro = rng.normal(size=(4, 1, 6)).astype(np.float32)
    whh = rng.normal(size=(4, 18, 6)).astype(np.float32)
    _close(ridge_value(torch.tensor(ro), torch.tensor(whh), 0.3),
           jpen.ridge_value(jnp.asarray(ro), jnp.asarray(whh), 0.3))
    _close(group_lasso_value(torch.tensor(whh), 0.2),
           jpen.group_lasso_value(jnp.asarray(whh), 0.2))


@pytest.mark.parametrize("lam", [0.5, 0.0], ids=["shrink", "identity"])
def test_prox_column_groups_matches_jax(lam):
    """Column groups with a few columns below the threshold; lam = 0 is the
    identity (the 1e-30 floor keeps it from 0/0)."""
    w = _rng(4).normal(size=(3, 12, 5)).astype(np.float32)
    w[:, :, 1] *= 0.01
    w[0, :, 3] = 0.0
    got = prox_column_groups(torch.tensor(w), lam, 0.2)
    _close(got, jprox.prox_column_groups(jnp.asarray(w), lam, 0.2))
    if lam == 0.0:
        np.testing.assert_array_equal(got.numpy(), w)
    else:
        assert (torch.linalg.vector_norm(got[:, :, 1], dim=-1) == 0).all()


def _graph(seed, p=6, ties=False):
    rng = _rng(seed)
    truth = (rng.random((p, p)) > 0.6).astype(np.int32)
    np.fill_diagonal(truth, 1)
    scores = rng.random((p, p)).astype(np.float32)
    if ties:
        scores = np.round(scores * 3) / 3          # many equal scores
        scores[0, :3] = 0.0
    return truth, scores


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("offdiag", [False, True], ids=["all", "offdiag"])
def test_auroc_matches_jax(ties, offdiag):
    truth, scores = _graph(5, ties=ties)
    got = tgc.auroc(torch.tensor(truth), torch.tensor(scores), offdiag)
    _close(got, jgc.auroc(jnp.asarray(truth), jnp.asarray(scores), offdiag))


def test_auroc_is_nan_for_one_class():
    assert torch.isnan(tgc.auroc(torch.ones((3, 3)), torch.rand((3, 3))))


def test_binary_metrics_match_jax():
    truth, scores = _graph(6)
    est = (scores > 0.5).astype(np.int32)
    t, e = torch.tensor(truth), torch.tensor(est)
    jt, je = jnp.asarray(truth), jnp.asarray(est)
    _close(tgc.gc_accuracy(t, e), jgc.gc_accuracy(jt, je))
    _close(tgc.variable_usage(e), jgc.variable_usage(je))
    for a, r in zip(tgc.precision_recall_f1(t, e),
                    jgc.precision_recall_f1(jt, je)):
        _close(a, r)
    empty = torch.zeros_like(e)
    assert [float(v) for v in tgc.precision_recall_f1(t, empty)] == [0, 0, 0]


def test_threshold_sweep_matches_jax():
    truth, scores = _graph(7)
    thr = np.array([0.0, 0.25, 0.5, 0.9], np.float32)
    got = tgc.threshold_sweep(torch.tensor(truth), torch.tensor(scores),
                              torch.tensor(thr))
    ref = jgc.threshold_sweep(jnp.asarray(truth), jnp.asarray(scores),
                              jnp.asarray(thr))
    for a, r in zip(got, ref):
        _close(a, r)


@pytest.mark.parametrize("kwargs", [{}, {"exclude_diagonal": True},
                                    {"floor": 1e-4}])
def test_auto_threshold_matches_jax(kwargs):
    """Edges of O(1) scores against pruned ones near or at zero."""
    truth, _ = _graph(8)
    rng = _rng(9)
    scores = np.where(truth > 0, rng.uniform(0.5, 2.0, truth.shape),
                      rng.uniform(0, 1e-5, truth.shape)).astype(np.float32)
    scores[1, 2] = 0.0
    _close(tgc.auto_threshold(torch.tensor(scores), **kwargs),
           jgc.auto_threshold(jnp.asarray(scores), **kwargs))


def test_gc_metrics_matches_jax():
    truth, scores = _graph(10)
    got = tgc.gc_metrics(torch.tensor(truth), torch.tensor(scores), 0.4)
    ref = jgc.gc_metrics(jnp.asarray(truth), jnp.asarray(scores), 0.4)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])
