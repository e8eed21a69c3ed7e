"""The port's MixtureCSRAE against the JAX package's: ``forward``, ``loss``
and ``sample`` on JAX's draws, two steps of ``fit_csrae``'s update against
``optax.adam``, and ``fit_csrae``'s epoch loop replayed from its draws.

Tolerances: forward, loss and sample rtol 1e-5, atol 1e-5 (float32, the
same products in another order); the Adam steps rtol 1e-4, atol 1e-6, the
training-step tests'; the epoch loop bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch.models import MixtureCSRAE
from vae_connexe_torch.optim import adam_init
from vae_connexe_torch.train import fit_csrae
from vae_connexe_torch.train.csrae_trainer import make_csrae_step
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.models import MixtureCSRAE as JMixtureCSRAE
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
D, HID, Z, K, B, LR = 12, (16, 8), 4, 3, 16, 1e-2


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _models(variant="symmetric"):
    args = (D, HID, Z, K, 0.7, variant)
    return JMixtureCSRAE(*args), MixtureCSRAE(*args)


@pytest.fixture(scope="module")
def setup():
    """The port's init laid into the JAX package's tree (``jax.eval_shape``
    gives its structure without compiling the init) and Bernoulli data."""
    jm, m = _models()
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    assert [tuple(s.shape) for s in jax.tree.leaves(shapes)] == [
        tuple(t.shape) for t in tree_leaves(params)]
    jp = jax.tree.unflatten(jax.tree.structure(shapes), [
        jnp.asarray(t.numpy()) for t in tree_leaves(params)])
    rng = np.random.default_rng(0)
    x = (rng.random((40, D)) > 0.5).astype(np.float32)
    return jp, params, x


def _close(got, ref, tol):
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("variant", ["symmetric", "paper"])
def test_forward_and_loss_match_jax(setup, variant):
    """(logits, mu, logvar) and (total, bce, cs) on the epsilon JAX draws
    from its key."""
    jp, params, x = setup
    jm, m = _models(variant)
    key = jax.random.key(3)
    ref_fwd = jax.jit(jm.forward)(jp, jnp.asarray(x), key)
    ref_loss = jax.jit(jm.loss)(jp, jnp.asarray(x), key)
    eps = _t(jax.random.normal(key, (x.shape[0], Z)))
    _close(m.forward(params, _t(x), eps), ref_fwd, FWD)
    _close(m.loss(params, _t(x), eps), ref_loss, FWD)
    total, bce, cs = m.loss(params, _t(x), eps)
    assert float(total) == pytest.approx(float(bce) + 0.7 * float(cs),
                                         rel=1e-6)


def test_sample_matches_jax(setup):
    """A component of the equal-weight prior a sample, then epsilon (the
    order of JAX's key split), decoded to probabilities; without draws it
    takes them from the generator in that order."""
    jp, params, _ = setup
    jm, m = _models()
    key, n = jax.random.key(4), 9
    ref = jax.jit(jm.sample, static_argnums=2)(jp, key, n)
    k_comp, k_eps = jax.random.split(key)
    comp = torch.tensor(np.asarray(jax.random.randint(k_comp, (n,), 0, K)))
    eps = _t(jax.random.normal(k_eps, (n, Z)))
    got = m.sample(params, None, n, comp=comp, eps=eps)
    assert got.shape == (n, D) and ((got > 0) & (got < 1)).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    g = torch.Generator().manual_seed(5)
    drawn = m.sample(params, torch.Generator().manual_seed(5), n)
    comp = torch.randint(0, K, (n,), generator=g)
    eps = torch.randn((n, Z), generator=g)
    assert torch.equal(drawn, m.sample(params, None, n, comp=comp, eps=eps))
    with pytest.raises(ValueError, match="generator"):
        m.sample(params, None, n)


def test_fit_csrae_step_matches_optax(setup):
    """Two updates of ``fit_csrae``'s step (its gradient over every leaf,
    the prior's included, then Adam) against ``jax.value_and_grad`` and
    ``optax.adam`` on the same batches and epsilons: params, Adam's moments
    and the metrics."""
    jp, params, x = setup
    jm, m = _models()
    opt = optax.adam(LR)

    @jax.jit
    def jstep(p, s, batch, key):
        (total, (bce, cs)), grads = jax.value_and_grad(
            lambda q: (lambda t: (t[0], t[1:]))(jm.loss(q, batch, key)),
            has_aux=True)(p)
        upd, s = opt.update(grads, s, p)
        return optax.apply_updates(p, upd), s, (total, bce, cs)

    step = make_csrae_step(m, LR)
    js, state = opt.init(jp), adam_init(params)
    for i, key in enumerate((jax.random.key(6), jax.random.key(7))):
        batch = x[i * B:(i + 1) * B]
        jp, js, jmet = jstep(jp, js, jnp.asarray(batch), key)
        eps = _t(jax.random.normal(key, (B, Z)))
        params, state, met = step(params, state, _t(batch), eps)
    _close(tree_leaves(params), jax.tree.leaves(jp), STEP)
    _close(tree_leaves(state.mu), jax.tree.leaves(js[0].mu), STEP)
    _close(tree_leaves(state.nu), jax.tree.leaves(js[0].nu), STEP)
    assert int(state.count) == int(js[0].count) == 2
    _close([met["total"], met["bce"], met["cs"]], jmet, STEP)


def test_fit_csrae_replays_from_its_draws(setup):
    """``fit_csrae``: each epoch a permutation of the rows (the remainder
    dropped), then one epsilon a batch, drawn from the generator in that
    order; the returned metrics are the last epoch's means."""
    _, params, x = setup
    _, m = _models()
    data = _t(x)
    got, metrics = fit_csrae(m, params, data, torch.Generator().manual_seed(8),
                             epochs=2, batch_size=B, lr=LR)
    g = torch.Generator().manual_seed(8)
    step, state, p = make_csrae_step(m, LR), adam_init(params), params
    nb = x.shape[0] // B
    for _ in range(2):
        perm = torch.randperm(x.shape[0], generator=g)[:nb * B]
        eps = torch.randn((nb, B, Z), generator=g)
        sums = {}
        for i in range(nb):
            p, state, met = step(p, state, data[perm[i * B:(i + 1) * B]],
                                 eps[i])
            sums = {k: sums.get(k, 0.0) + float(v) for k, v in met.items()}
    for a, r in zip(tree_leaves(got), tree_leaves(p)):
        assert torch.equal(a, r)
    assert set(metrics) == {"total", "bce", "cs"}
    for k, v in sums.items():
        assert metrics[k] == pytest.approx(v / nb, rel=1e-6)
