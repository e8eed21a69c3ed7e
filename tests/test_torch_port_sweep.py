"""The port's multi-seed sweep (``parallel/seed_sweep.py``): the seeds folded
into the recurrence kernels' heads, against the JAX package's phase-1 step
seed by seed and against the port's own single-seed loop.

JAX-initialised parameters cross over through ``convert``; each seed's
batch and epsilon are made with numpy or computed from the JAX step's key
and handed to both packages.  On the CPU every recurrence runs its plain
version.  Tolerances: one step against JAX rtol 1e-4, atol 1e-6 (the order
of ``tests/test_torch_port_train.py``); the sweep against the single-seed
loops rtol 1e-5.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.data import arrange_input, lorenz96
from vae_connexe_torch.models import CRVAE, CRVAEParams
from vae_connexe_torch.parallel import (
    make_sweep_fn,
    make_sweep_step,
    seed_generators,
    sweep_phase1,
)
from vae_connexe_torch.parallel.seed_sweep import (
    SEED_ROLES,
    init_sweep_state,
    stack_trees,
)
from vae_connexe_torch.train import Phase1Config, Phase1State, make_phase1_step
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.train import Phase1Config as JPhase1Config
from vae_connexe_tpu.train.crvae_trainer import Phase1State as JPhase1State
from vae_connexe_tpu.train.crvae_trainer import make_phase1_step as jax_step
from torch_threads import one_torch_thread  # noqa: F401

STEP = dict(rtol=1e-4, atol=1e-6)
P, H, E, T, B, S = 4, 8, 3, 7, 16, 3      # tests/test_torch_port_train.py's
CFG = dict(max_iter=1, check_every=1, batch_size=B, lam=0.05, lr=0.03,
           lam_ridge=0.01, beta=0.1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_step(jm, jp, batch, parents, key):
    """JAX's ``make_phase1_step`` on a fixed batch; returns (new state,
    metrics, the epsilon it drew)."""
    step = jax_step(jm, JPhase1Config(**CFG), jnp.asarray(batch),
                    jnp.asarray(parents), fixed_batch=jnp.asarray(batch))
    state = JPhase1State(params=jp, prior=None, best_params=jp,
                         best_loss=jnp.array(jnp.inf), key=key,
                         step=jnp.zeros([], jnp.int32))
    new_state, metrics = step(state, None)
    _, _, k_z = jax.random.split(key, 3)
    return new_state, metrics, np.asarray(jax.random.normal(k_z, (B, H)))


def _seed(tree, s):
    return [leaf[s] for leaf in tree_leaves(tree)]


@pytest.mark.parametrize("masked", [False, True])
def test_sweep_step_matches_jax_per_seed(masked):
    """S=3 seeds, each from its own JAX init, batch and epsilon, through one
    sweep step: each seed's params, best params, best loss and metrics as
    JAX's ``make_phase1_step`` for that seed alone."""
    rng = np.random.default_rng(1)
    parents = ((rng.random((P, P)) > 0.4) if masked
               else np.ones((P, P))).astype(np.float32)
    jm = JCRVAE(p=P, hidden=H, enc_len=E)
    jps = [jm.init(jax.random.key(10 + s)) for s in range(S)]
    batches = rng.normal(size=(S, B, T, P)).astype(np.float32)
    refs = [_jax_step(jm, jp, batches[s], parents, jax.random.key(20 + s))
            for s, jp in enumerate(jps)]
    params = stack_trees([convert.from_numpy(
        CRVAEParams, flax.serialization.to_state_dict(jp), "cpu")
        for jp in jps])
    model = CRVAE(P, H, E)
    step = make_sweep_step(model, Phase1Config(**CFG), _t(batches[0]),
                           _t(parents))
    state = init_sweep_state(model, range(S), "cpu")
    state.params = state.best_params = params
    got, metrics = step(state, batch=_t(batches),
                        eps=torch.stack([_t(r[2]) for r in refs]))
    assert got.step == 1 and metrics["loss"].shape == (S,)
    for s, (ref, ref_metrics, _) in enumerate(refs):
        for tree, jtree in ((got.params, ref.params),
                            (got.best_params, ref.best_params)):
            for a, r in zip(_seed(tree, s), jax.tree.leaves(jtree)):
                np.testing.assert_allclose(a.numpy(), np.asarray(r), **STEP)
        np.testing.assert_allclose(float(got.best_loss[s]),
                                   float(ref.best_loss), **STEP)
        for k, v in ref_metrics.items():
            np.testing.assert_allclose(float(metrics[k][s]), float(v),
                                       **STEP, err_msg=k)


def _windows(p=4, t=160, ctx=10):
    series = lorenz96(torch.Generator().manual_seed(0), p=p, t=t,
                      device="cpu")
    return arrange_input(series, ctx)[0]


def _single_loops(model, cfg, windows, parents, seeds):
    """The port's single-seed loop per seed, on that seed's generators."""
    out = []
    for s in seeds:
        gens = seed_generators(s, "cpu")
        params = model.init(gens["init"], "cpu")
        step = make_phase1_step(model, cfg, windows, parents)
        state = Phase1State(params=params, prior=None, best_params=params,
                            best_loss=torch.tensor(float("inf")),
                            generator=gens["run"], step=0)
        for _ in range(cfg.max_iter):
            state, metrics = step(state)
        out.append((model.gc(state.best_params, parents, threshold=False),
                    metrics["mean_loss"], state.best_loss))
    return out


@pytest.mark.parametrize("resample", [True, False],
                         ids=["resampled", "fixed-batch"])
def test_sweep_matches_single_seed_loops(resample):
    """``sweep_phase1`` for 10 steps: each seed's scores, last mean_loss and
    best loss as the single-seed loop's on the same generators; with
    resampling off every seed trains on the step's one fixed batch."""
    model, windows = CRVAE(4, 16, 5), _windows()
    parents = _t(np.random.default_rng(2).random((4, 4)) > 0.3)
    cfg = Phase1Config(max_iter=10, batch_size=24, lam=0.1,
                       resample_batches=resample)
    seeds = [5, 6, 7]
    out = sweep_phase1(model, windows, parents, cfg, seeds)
    assert out["gc_scores"].shape == (3, 4, 4)
    for s, (scores, mean_loss, best_loss) in enumerate(
            _single_loops(model, cfg, windows, parents, seeds)):
        np.testing.assert_allclose(out["gc_scores"][s].numpy(),
                                   scores.numpy(), rtol=1e-5)
        np.testing.assert_allclose(float(out["mean_loss"][s]),
                                   float(mean_loss), rtol=1e-5)
        np.testing.assert_allclose(float(out["best_loss"][s]),
                                   float(best_loss), rtol=1e-5)


def test_sweep_is_repeatable_and_takes_indices():
    """Two sweeps of the same seeds are bitwise equal; a step given the
    (S, B) indices equals the step given the windows they pick."""
    model, windows = CRVAE(4, 8, 5), _windows()
    parents = torch.ones((4, 4))
    cfg = Phase1Config(max_iter=4, batch_size=8)
    run = make_sweep_fn(model, windows, parents, cfg)
    a, b = run([0, 1]), run([0, 1])
    assert all(torch.equal(a[k], b[k]) for k in a)
    step = make_sweep_step(model, cfg, windows, parents)
    idx = torch.randint(0, windows.shape[0], (2, 8),
                        generator=torch.Generator().manual_seed(3))
    eps = torch.randn((2, 8, 8), generator=torch.Generator().manual_seed(4))
    by_idx, _ = step(init_sweep_state(model, [0, 1], "cpu"), idx, eps)
    by_win, _ = step(init_sweep_state(model, [0, 1], "cpu"), windows[idx],
                     eps)
    assert all(torch.equal(u, v) for u, v in
               zip(tree_leaves(by_idx.params), tree_leaves(by_win.params)))


def test_seed_generators_rule():
    """One generator a role, the inits on the CPU; the same seed gives the
    same draws, another seed others."""
    g = seed_generators(3, "cpu")
    assert tuple(g) == SEED_ROLES
    draw = [torch.rand(4, generator=v) for v in g.values()]
    again = [torch.rand(4, generator=v)
             for v in seed_generators(3, "cpu").values()]
    other = [torch.rand(4, generator=v)
             for v in seed_generators(4, "cpu").values()]
    assert all(torch.equal(u, v) for u, v in zip(draw, again))
    assert not any(torch.equal(u, v) for u, v in zip(draw, other))
    assert len({float(d[0]) for d in draw}) == len(SEED_ROLES)


def test_kept_seed_axis_losses_are_per_seed_values():
    """``ridge_value`` and ``kl_gaussian`` with a kept seed axis give each
    seed's own value, the terms of the sweep's per-seed loss."""
    from vae_connexe_torch.losses import kl_gaussian, ridge_value

    rng = np.random.default_rng(5)
    ro, whh = _t(rng.normal(size=(S, P, 1, H))), _t(rng.normal(size=(S, P, 3 * H, H)))
    mu, lv = _t(rng.normal(size=(S, B, H))), _t(rng.normal(size=(S, B, H)))
    ridge = ridge_value(ro, whh, 0.3, keep=1)
    kl = kl_gaussian(mu, lv, keep=1)
    assert ridge.shape == kl.shape == (S,)
    for s in range(S):
        torch.testing.assert_close(ridge[s], ridge_value(ro[s], whh[s], 0.3),
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(kl[s], kl_gaussian(mu[s], lv[s]),
                                   rtol=1e-6, atol=0)


def test_unported_sweep_options_raise():
    """A mesh is ported: on a world of one rank the seed axis stays whole
    and the sweep is the unmeshed one bit for bit (the split over dp:
    tests/test_torch_port_parallel.py); an object that is no mesh raises a
    TypeError; latent_reg='cs' builds (it trains on KL, as the JAX
    package's sweep: tests/test_torch_port_cs.py); another name raises."""
    from torch_ranks import world_of_one

    model, windows = CRVAE(4, 8, 5), _windows()
    with pytest.raises(TypeError, match="make_mesh"):
        make_sweep_fn(model, windows, torch.ones((4, 4)), Phase1Config(),
                      mesh=object())
    cfg = Phase1Config(max_iter=3, batch_size=8)
    meshed = make_sweep_fn(model, windows, torch.ones((4, 4)), cfg,
                           mesh=world_of_one())([0, 1])
    plain = make_sweep_fn(model, windows, torch.ones((4, 4)), cfg)([0, 1])
    for k in plain:
        torch.testing.assert_close(meshed[k], plain[k], rtol=0, atol=0)
    assert callable(make_sweep_step(model, Phase1Config(latent_reg="cs"),
                                    windows, torch.ones((4, 4))))
    with pytest.raises(ValueError, match="latent_reg"):
        make_sweep_step(model, Phase1Config(latent_reg="l1"), windows,
                        torch.ones((4, 4)))
