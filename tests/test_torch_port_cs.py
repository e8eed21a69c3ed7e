"""``latent_reg='cs'`` in the port against the JAX package: the CS
divergence against a GMM prior (both variants, values and gradients), one
phase-1 and one phase-2 step with a prior from a JAX-made state on JAX's
draws, ``fit_phase1`` with the prior killed and resumed, and the sweep,
which trains on KL whatever ``latent_reg`` says, as the JAX package's.

Tolerances: the divergence and its gradients rtol 1e-5, atol 1e-5 (float32,
the same operations in another order); one step rtol 1e-4, atol 1e-6, the
phase-1 and phase-2 step tests'; resume and the sweep bitwise.
"""

import math

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch import convert, discover
from vae_connexe_torch.losses import cs_divergence_gmm, log_gaussian_overlap
from vae_connexe_torch.models import (
    CRVAE,
    CRVAEParams,
    ErrorVAE,
    GMMPrior,
    init_gmm_prior,
)
from vae_connexe_torch.parallel import sweep_phase1
from vae_connexe_torch.train import (
    Phase1Config,
    Phase1State,
    Phase2Config,
    Phase2State,
    fit_phase1,
    make_phase1_step,
    make_phase2_step,
)
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.losses import cs_divergence as jcs
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.models.gmm_prior import GMMPrior as JGMMPrior
from vae_connexe_tpu.models.gmm_prior import init_gmm_prior as jinit_prior
from vae_connexe_tpu.train import config as jconfig
from vae_connexe_tpu.train import crvae_trainer as jtrainer
from torch_threads import one_torch_thread  # noqa: F401

CS = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
P, H, E, T, B, N, K = 4, 8, 3, 7, 16, 40, 3
HE, Z = 6, 5
CS_CFG = dict(latent_reg="cs", lambda_cs=0.3, gmm_components=K, batch_size=B,
              lr=0.05, lam_ridge=0.01, max_iter=1, check_every=1)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _sd(tree):
    return flax.serialization.to_state_dict(tree)


def _inputs(seed, b=5, k=K, d=6, far=False):
    rng = np.random.default_rng(seed)
    mu_q = rng.normal(size=(b, d)).astype(np.float32)
    mu_p = rng.normal(size=(k, d)).astype(np.float32)
    var_q = rng.uniform(0.3, 2.0, (b, d)).astype(np.float32)
    var_p = rng.uniform(0.3, 2.0, (k, d)).astype(np.float32)
    if far:
        # Components 40 apart and narrow: every overlap is far below
        # float32's smallest number, so exponentiating and taking the log
        # again gives inf.
        mu_p = mu_p + 40.0 * np.arange(1, k + 1, dtype=np.float32)[:, None]
        var_q, var_p = var_q * 0.01, var_p * 0.01
    return mu_q, var_q, mu_p, var_p


def _jax_tree(jax_init, port_params):
    """The port's params laid into the JAX package's tree, whose structure
    ``jax.eval_shape`` gives without running (and compiling) its init."""
    shapes = jax.eval_shape(jax_init, jax.random.key(0))
    return jax.tree.unflatten(jax.tree.structure(shapes), [
        jnp.asarray(a.numpy()) for a in tree_leaves(port_params)])


def _grads(fn, args):
    t = [_t(a).requires_grad_(True) for a in args]
    out = fn(*t)
    return out.detach().numpy(), [g.numpy() for g in
                                  torch.autograd.grad(out.sum(), t)]


def test_log_gaussian_overlap_matches_jax():
    """Value and gradients over broadcast leading axes."""
    mu_q, var_q, mu_p, var_p = _inputs(0)
    args = (mu_q[:, None], var_q[:, None], mu_p[None], var_p[None])
    ref = jax.jit(jcs.log_gaussian_overlap)(*map(jnp.asarray, args))
    jgrads = jax.jit(jax.grad(lambda *a: jcs.log_gaussian_overlap(*a).sum(),
                              argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
    got, grads = _grads(log_gaussian_overlap, args)
    np.testing.assert_allclose(got, np.asarray(ref), **CS)
    for g, r, a in zip(grads, jgrads, args):
        # Summed over the broadcast axes, as jax.grad does.
        np.testing.assert_allclose(g, np.asarray(r).reshape(a.shape), **CS)


@pytest.mark.parametrize("far", [False, True], ids=["near", "far"])
@pytest.mark.parametrize("variant", ["symmetric", "paper"])
def test_cs_divergence_matches_jax(variant, far):
    """D_CS per row, clamped at 0, and its gradients with respect to all
    four inputs, against the JAX package's and ``jax.grad``; far apart,
    where exp-then-log underflows, both stay finite."""
    args = _inputs(1, far=far)

    def port(*a):
        return cs_divergence_gmm(*a, variant=variant)

    def ref_fn(*a):
        return jcs.cs_divergence_gmm(*a, variant=variant)

    ref = jax.jit(ref_fn)(*map(jnp.asarray, args))
    jgrads = jax.jit(jax.grad(lambda *a: ref_fn(*a).sum(),
                              argnums=(0, 1, 2, 3)))(*map(jnp.asarray, args))
    got, grads = _grads(port, args)
    assert got.shape == (5,) and (got >= 0).all() and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(ref), **CS)
    for g, r in zip(grads, jgrads):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, np.asarray(r), **CS)
    if far:
        mu_q, var_q, mu_p, var_p = map(_t, args)
        overlap = torch.exp(log_gaussian_overlap(
            mu_q[:, None], var_q[:, None], mu_p[None], var_p[None]))
        assert (overlap == 0).all()     # the naive form's log is -inf
        assert (got > 100).all()


def test_cs_divergence_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant 'both'"):
        cs_divergence_gmm(*map(_t, _inputs(2)), variant="both")


def test_init_gmm_prior_draws_its_means_first():
    """Means 0.05 times one (K, D) normal draw from the generator, on its
    device; log-variances zero; the shapes of the JAX package's."""
    prior = init_gmm_prior(torch.Generator().manual_seed(3), K, H, device="cpu")
    want = 0.05 * torch.randn((K, H), generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(prior.mu, want, rtol=0, atol=0)
    assert torch.equal(prior.logvar, torch.zeros((K, H)))
    torch.testing.assert_close(prior.var, torch.ones((K, H)))
    jp = jax.eval_shape(lambda k: jinit_prior(k, K, H), jax.random.key(0))
    assert prior.mu.shape == jp.mu.shape and prior.logvar.shape == jp.logvar.shape


@pytest.fixture(scope="module")
def setup():
    jm = JCRVAE(p=P, hidden=H, enc_len=E)
    je = JErrorVAE(d=P, hidden=HE, latent=Z)
    g = torch.Generator().manual_seed(0)
    jp = _jax_tree(jm.init, CRVAE(P, H, E).init(g, "cpu"))
    jep = _jax_tree(je.init, ErrorVAE(P, HE, Z).init(g, "cpu"))
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(N, T, P)).astype(np.float32)
    parents = (rng.random((P, P)) > 0.4).astype(np.float32)
    # A prior away from its init, so that every term of its gradient counts.
    jprior = JGMMPrior(
        mu=jnp.asarray(0.05 * rng.normal(size=(K, H)), jnp.float32),
        logvar=jnp.asarray(rng.uniform(-0.5, 0.5, (K, H)), jnp.float32))
    return jm, je, jp, jep, jprior, windows, parents


def _prior(jprior) -> GMMPrior:
    return GMMPrior(mu=_t(jprior.mu), logvar=_t(jprior.logvar))


def _assert_trees(port_tree, jax_tree, tol=STEP):
    for a, r in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("variant", ["symmetric", "paper"])
def test_phase1_step_with_prior_matches_jax(setup, variant):
    """One ``make_phase1_step`` with a prior in each package from the same
    JAX-made state on JAX's draws: params, prior, best params and loss and
    the metrics."""
    jm, _, jp, _, jprior, windows, parents = setup
    jcfg = jconfig.Phase1Config(**CS_CFG, cs_variant=variant)
    jstep = jax.jit(jtrainer.make_phase1_step(jm, jcfg, jnp.asarray(windows),
                                              jnp.asarray(parents)))
    key = jax.random.key(4)
    js = jtrainer.Phase1State(params=jp, prior=jprior, best_params=jp,
                              best_loss=jnp.array(jnp.inf), key=key,
                              step=jnp.zeros([], jnp.int32))
    _, k_batch, k_z = jax.random.split(key, 3)
    idx = np.asarray(jax.random.randint(k_batch, (B,), 0, N))
    eps = np.asarray(jax.random.normal(k_z, (B, H)))
    js, jmet = jstep(js, None)

    tp = convert.from_numpy(CRVAEParams, _sd(jp), "cpu")
    step = make_phase1_step(CRVAE(P, H, E), Phase1Config(**CS_CFG,
                                                         cs_variant=variant),
                            _t(windows), _t(parents))
    state = Phase1State(params=tp, prior=_prior(jprior), best_params=tp,
                        best_loss=torch.tensor(float("inf")),
                        generator=torch.Generator(), step=0)
    state, met = step(state, batch=_t(windows[idx]), eps=_t(eps))
    for port_tree, jax_tree in ((state.params, js.params),
                                (state.prior, js.prior),
                                (state.best_params, js.best_params)):
        _assert_trees(port_tree, jax_tree)
    assert not np.allclose(state.prior.logvar.numpy(),
                           np.asarray(jprior.logvar))        # it moved
    assert set(met) == set(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k]), float(v), **STEP, err_msg=k)
    np.testing.assert_allclose(float(state.best_loss), float(js.best_loss),
                               **STEP)


def test_phase2_step_with_prior_matches_jax(setup):
    """One ``make_phase2_step`` with a prior (CS on the CRVAE, KL on the
    ErrorVAE) from a JAX-made state on JAX's draws: params, prior, ErrorVAE
    params, Adam's moments and the metrics."""
    jm, je, jp, jep, jprior, windows, parents = setup
    cfg = {k: v for k, v in CS_CFG.items()}
    jcfg = jconfig.Phase2Config(**cfg, lr_error=1e-2, beta_error=0.5,
                                cs_variant="paper")
    opt = optax.adam(1e-2)
    jstep = jax.jit(jtrainer.make_phase2_step(
        jm, je, jcfg, jnp.asarray(windows), jnp.asarray(parents), opt))
    key = jax.random.key(5)
    js = jtrainer.Phase2State(params=jp, err_params=jep,
                              err_opt=opt.init(jep), prior=jprior,
                              best_params=jp, best_loss=jnp.array(jnp.inf),
                              key=key, step=jnp.zeros([], jnp.int32))
    _, k_batch, k_z, k_e = jax.random.split(key, 4)
    idx = np.asarray(jax.random.randint(k_batch, (B,), 0, N))
    eps = np.asarray(jax.random.normal(k_z, (B, H)))
    eps_err = np.asarray(jax.random.normal(k_e, (B, Z)))
    js, jmet = jstep(js, None)

    fields = convert.phase2_state_from_numpy(_sd(jp), _sd(jep),
                                             _sd(opt.init(jep)), "cpu")
    state = Phase2State(**fields, prior=_prior(jprior),
                        best_params=fields["params"],
                        best_loss=torch.tensor(float("inf")),
                        generator=torch.Generator(), step=0)
    step = make_phase2_step(CRVAE(P, H, E), ErrorVAE(P, HE, Z),
                            Phase2Config(**cfg, lr_error=1e-2,
                                         beta_error=0.5, cs_variant="paper"),
                            _t(windows), _t(parents))
    state, met = step(state, batch=_t(windows[idx]), eps=_t(eps),
                      eps_err=_t(eps_err))
    for port_tree, jax_tree in ((state.params, js.params),
                                (state.prior, js.prior),
                                (state.err_params, js.err_params),
                                (state.err_opt.mu, js.err_opt[0].mu),
                                (state.err_opt.nu, js.err_opt[0].nu),
                                (state.best_params, js.best_params)):
        _assert_trees(port_tree, jax_tree)
    assert set(met) == set(jmet)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k]), float(v), **STEP, err_msg=k)


def _windows(seed=6):
    return torch.randn((N, T, P), generator=torch.Generator().manual_seed(seed))


def test_fit_phase1_cs_kill_and_resume_bitwise(tmp_path):
    """``fit_phase1`` with a prior: the prior is the generator's first draw
    (a 0-step fit returns it as drawn), and a fit killed after its first
    chunk and resumed equals the uninterrupted one bitwise, prior, params,
    best params and loss, generator and metrics."""
    m = CRVAE(P, H, E)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    cfg = Phase1Config(**{**CS_CFG, "max_iter": 6, "check_every": 3})
    args = (m, params, _windows(), torch.ones((P, P)))

    _, s0, _ = fit_phase1(*args, Phase1Config(**{**CS_CFG, "max_iter": 0}),
                          torch.Generator().manual_seed(7))
    want = 0.05 * torch.randn((K, H), generator=torch.Generator().manual_seed(7))
    assert torch.equal(s0.prior.mu, want) and s0.step == 0

    class Kill(Exception):
        pass

    def kill(step, state, metrics):
        raise Kill

    whole = fit_phase1(*args, cfg, torch.Generator().manual_seed(7))
    ck = str(tmp_path / "ck")
    with pytest.raises(Kill):
        fit_phase1(*args, cfg, torch.Generator().manual_seed(7),
                   checkpoint_dir=ck, checkpoint_every=3, callback=kill)
    resumed = fit_phase1(*args, cfg, torch.Generator().manual_seed(99),
                         checkpoint_dir=ck, checkpoint_every=3, resume=True)

    def leaves(r):
        best, state, _ = r
        return (tree_leaves(best) + tree_leaves(state.params)
                + tree_leaves(state.prior) + [state.best_loss])

    assert all(torch.equal(u, v) for u, v in zip(leaves(whole),
                                                 leaves(resumed)))
    assert whole[2] == resumed[2] and resumed[1].step == 6
    assert torch.equal(whole[1].generator.get_state(),
                       resumed[1].generator.get_state())
    assert not torch.equal(whole[1].prior.mu, want)           # it trained


def test_cs_sweep_equals_kl_sweep():
    """``sweep_phase1`` and ``discover`` with seeds > 1 train on KL with no
    prior whatever ``latent_reg`` says, as the JAX package's sweep
    (``vae_connexe_tpu/parallel/seed_sweep.py:37``): a cs configuration
    gives the kl configuration's results bit for bit."""
    m, windows = CRVAE(P, H, E), _windows(8)
    kw = dict(max_iter=3, batch_size=B, lambda_cs=0.3, gmm_components=K)
    out = {reg: sweep_phase1(m, windows, torch.ones((P, P)),
                             Phase1Config(latent_reg=reg, **kw), [0, 1])
           for reg in ("kl", "cs")}
    for k in ("gc_scores", "mean_loss", "best_loss"):
        assert torch.equal(out["cs"][k], out["kl"][k]), k

    series = np.random.default_rng(9).normal(size=(60, 3)).astype(np.float32)
    found = {reg: discover(series, context=6, hidden=8, max_iter=3,
                           batch_size=B, seeds=2, latent_reg=reg,
                           device="cpu")
             for reg in ("kl", "cs")}
    for k in ("scores", "votes", "seed_scores", "gc"):
        np.testing.assert_array_equal(getattr(found["cs"], k),
                                      getattr(found["kl"], k), err_msg=k)
    assert found["cs"].metrics == found["kl"].metrics
    assert math.isfinite(found["cs"].metrics["mean_loss"])
