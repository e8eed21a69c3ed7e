"""The Hénon and VAR datasets, the log-sigma KL and the row/element prox
of the port against the JAX package on the same inputs (CPU).

The Hénon recursions are chaotic: a difference of one rounding grows past
1e-5 within some 30 steps, so the port rounds each multiply-add once as
XLA's CPU backend fuses it, and the series are held to 1e-5 over their
first 200 steps (they agree bit for bit throughout).  VAR(1), the KL and
the prox functions: 1e-5 (float32).  The truths: exactly.
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.configs.experiments import gc_dynamics_rows
from vae_connexe_torch.data import (
    coupled_henon,
    coupled_henon_truth,
    henon_chain,
    henon_dynamics_truth,
    henon_truth,
    var_process,
    var_truth,
)
from vae_connexe_torch.losses.kl import kl_gaussian_logsigma
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.optim import (
    PROX_FNS,
    prox_elementwise,
    prox_row_groups,
    proximal_sgd,
)
from vae_connexe_torch.utils.tree import tree_leaves, tree_map
from vae_connexe_tpu import data as jdata
from vae_connexe_tpu.evals import gc_metrics as jgc_metrics
from vae_connexe_tpu.losses import kl as jkl
from vae_connexe_tpu.ops import gru as jgru
from vae_connexe_tpu.optim import prox as jprox
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **TOL)


def test_henon_chain_matches_jax():
    got = henon_chain(1000, device="cpu").numpy()
    ref = np.asarray(jdata.henon_chain(t=1000))
    assert got.shape == (1000, 2) and got.dtype == np.float32
    _close(got[:200], ref[:200])


@pytest.mark.parametrize("seed,d", [(0, 6), (3, 4)])
def test_coupled_henon_matches_jax_on_injected_draws(seed, d):
    """The two (d,) standard normals JAX draws from its key's two halves,
    handed to the port."""
    key = jax.random.key(seed)
    ref = np.asarray(jdata.coupled_henon(key, t=3000, d=d))
    k0, k1 = jax.random.split(key)
    x0 = np.stack([np.asarray(jax.random.normal(k, (d,))) for k in (k0, k1)])
    got = coupled_henon(None, t=3000, d=d, x0_draw=torch.tensor(x0),
                        device="cpu").numpy()
    assert got.shape == (3000, d)
    _close(got[:200], ref[:200])
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_coupled_henon_draws_from_its_generator():
    a = coupled_henon(torch.Generator().manual_seed(1), t=300, d=3,
                      device="cpu")
    b = coupled_henon(torch.Generator().manual_seed(1), t=300, d=3,
                      device="cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="generator"):
        coupled_henon(None, t=10, d=3, device="cpu")


def test_var_process_matches_jax_on_injected_draws():
    key = jax.random.key(4)
    a = jdata.var_truth(5)
    ref = np.asarray(jdata.var_process(key, a, n=50, t=30))
    k0, k1 = jax.random.split(key)
    x0 = np.asarray(jax.random.normal(k0, (50, 5)))
    noise = np.asarray(jax.random.normal(k1, (29, 50, 5)))
    got = var_process(None, var_truth(5, "cpu"), n=50, t=30,
                      x0_draw=torch.tensor(x0), noise_draw=torch.tensor(noise))
    assert got.shape == (50, 30, 5)
    _close(got, ref)


@pytest.mark.parametrize("d", [2, 3, 5, 6])
def test_truths_match_jax_exactly(d):
    np.testing.assert_array_equal(henon_truth(d, "cpu").numpy(),
                                  np.asarray(jdata.henon_truth(d)))
    for self_loops in (False, True):
        np.testing.assert_array_equal(
            coupled_henon_truth(d, self_loops, "cpu").numpy(),
            np.asarray(jdata.coupled_henon_truth(d, self_loops)))
    if d >= 3:
        np.testing.assert_array_equal(var_truth(d, "cpu").numpy(),
                                      np.asarray(jdata.var_truth(d)))
    np.testing.assert_array_equal(henon_dynamics_truth("cpu").numpy(),
                                  np.asarray(jdata.henon_dynamics_truth()))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gc_dynamics_rows_match_jax(seed):
    """``henon_author``'s rows, computed as the JAX package's
    ``run_experiment`` computes them, on the same scores."""
    scores = np.random.default_rng(seed).random((2, 2)).astype(np.float32)
    got = gc_dynamics_rows(torch.tensor(scores))
    dyn, s = jdata.henon_dynamics_truth(), jnp.asarray(scores)
    want = {k: float(v) for k, v in jgc_metrics(dyn, s).items()}
    grid = jnp.linspace(0.0, float(s.max()), 64)
    accs = [float(jgc_metrics(dyn, s, float(t))["accuracy"]) for t in grid]
    thr = float(grid[int(np.argmax(accs))])
    assert got["gc_dynamics"] == pytest.approx(want, nan_ok=True)
    best = got["gc_dynamics_best_threshold"]
    assert best.pop("threshold") == pytest.approx(thr, rel=1e-6)
    assert best == pytest.approx({k: float(v) for k, v in
                                  jgc_metrics(dyn, s, thr).items()},
                                 nan_ok=True)


@pytest.mark.parametrize("reduction", ["mean", "sum_over_batch"])
def test_kl_gaussian_logsigma_matches_jax(reduction):
    rng = np.random.default_rng(5)
    mu = rng.normal(size=(7, 4)).astype(np.float32)
    ls = (0.3 * rng.normal(size=(7, 4))).astype(np.float32)
    got = kl_gaussian_logsigma(torch.tensor(mu), torch.tensor(ls), reduction)
    _close(got, jkl.kl_gaussian_logsigma(jnp.asarray(mu), jnp.asarray(ls),
                                         reduction))
    # A leading seed axis is kept: one value each.
    stack = kl_gaussian_logsigma(torch.tensor(mu[None].repeat(3, 0)),
                                 torch.tensor(ls[None].repeat(3, 0)),
                                 reduction, keep=1)
    _close(stack, np.full(3, float(got)))
    with pytest.raises(ValueError, match="reduction"):
        kl_gaussian_logsigma(torch.tensor(mu), torch.tensor(ls), "median")


@pytest.mark.parametrize("name", ["column", "row", "element"])
@pytest.mark.parametrize("lam_lr", [(0.0, 0.1), (0.5, 0.1), (3.0, 0.5)])
def test_prox_functions_match_jax(name, lam_lr):
    """Each prox on a (seeds, heads, D, H) stack, broadcast over the two
    leading axes; lam * lr = 0 is the identity."""
    w = np.random.default_rng(6).normal(size=(2, 3, 4, 5)).astype(np.float32)
    w[0, 1, 2] = 0.0
    got = PROX_FNS[name](torch.tensor(w), *lam_lr)
    _close(got, jprox.PROX_FNS[name](jnp.asarray(w), *lam_lr))
    assert PROX_FNS["row"] is prox_row_groups
    assert PROX_FNS["element"] is prox_elementwise


@pytest.mark.parametrize("groups", ["row", "element"])
@pytest.mark.parametrize("masked", [False, True])
def test_proximal_sgd_matches_optax(groups, masked):
    """Three updates of ``proximal_sgd`` on a stack of GRU heads against
    JAX's optax transform on the same gradients; the prox mask selects
    the input weights alone when ``masked``."""
    jp = jgru.init_stacked_gru(jax.random.key(0), 3, 4, 5)
    tp = convert.from_numpy(GRUParams, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jp)), "cpu")
    jmask = tmask = None
    if masked:
        jmask = jax.tree.map(lambda _: False, jp).replace(w_ih=True)
        tmask = dataclasses.replace(tree_map(lambda _: False, tp), w_ih=True)
    jopt = jprox.proximal_sgd(0.1, 0.3, groups, prox_mask=jmask)
    opt = proximal_sgd(0.1, 0.3, groups, prox_mask=tmask)
    js, ts = jopt.init(jp), opt.init(tp)
    rng = np.random.default_rng(7)
    for _ in range(3):
        g_np = [rng.normal(size=np.shape(x)).astype(np.float32)
                for x in jax.tree.leaves(jp)]
        jg = jax.tree.unflatten(jax.tree.structure(jp),
                                [jnp.asarray(x) for x in g_np])
        leaves = iter([torch.tensor(x) for x in g_np])
        tg = tree_map(lambda _: next(leaves), tp)
        ju, js = jopt.update(jg, js, jp)
        tu, ts = opt.update(tg, ts, tp)
        jp = optax.apply_updates(jp, ju)
        tp = tree_map(lambda a, b: a + b, tp, tu)
        for a, b in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            _close(a, b)
    assert int(ts.count) == int(js.count) == 3
    with pytest.raises(ValueError, match="params"):
        opt.update(tg, ts)
