"""The port's VRAE against the JAX package's: the RNN and LSTM cells and
scans, ``VRAE`` encode, decode, forward and generate for the three cells
with the teacher-forcing coins and epsilon passed in, two ``fit_vrae``
updates against ``optax.adam``, both schedules, and ``fit_vrae``'s loop
replayed from its draws.

Tolerances: cells, scans and the model's outputs rtol 1e-5, atol 1e-5
(float32, the same products in another order); the Adam steps rtol 1e-4,
atol 1e-6, the training-step tests'; the loop bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch.models import VRAE
from vae_connexe_torch.models.vrae import (
    exponential_teacher_forcing_schedule,
    linear_teacher_forcing_schedule,
)
from vae_connexe_torch.ops import (
    LSTMCellParams,
    RNNCellParams,
    lstm_cell,
    lstm_scan,
    rnn_cell,
    rnn_scan,
)
from vae_connexe_torch.optim import adam_init
from vae_connexe_torch.train import fit_vrae
from vae_connexe_torch.train.vrae_trainer import make_vrae_step
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.models import VRAE as JVRAE
from vae_connexe_tpu.models import vrae as jvrae
from vae_connexe_tpu.ops import rnn_cells as jcells
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
D, H, Z, B, T, LR = 3, 5, 2, 4, 6, 1e-2


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _close(got, ref, tol=FWD):
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("cell", ["rnn", "lstm"])
def test_cells_and_scans_match_jax(cell):
    """One step of the cell and a T-step scan from a nonzero state."""
    rng = np.random.default_rng(0)
    g = 4 * H if cell == "lstm" else H
    leaves = [rng.normal(size=s).astype(np.float32) * 0.5
              for s in ((g, D), (g, H), (g,), (g,))]
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    h0 = rng.normal(size=(B, H)).astype(np.float32)
    c0 = rng.normal(size=(B, H)).astype(np.float32)
    if cell == "lstm":
        jp, p = jcells.LSTMCellParams(*map(jnp.asarray, leaves)), \
            LSTMCellParams(*map(_t, leaves))
        ref_cell = jax.jit(jcells.lstm_cell)(jp, x[:, 0], (h0, c0))
        ref_scan = jax.jit(jcells.lstm_scan)(jp, x, (h0, c0))
        got_cell = lstm_cell(p, _t(x[:, 0]), (_t(h0), _t(c0)))
        outs, (h_t, c_t) = lstm_scan(p, _t(x), (_t(h0), _t(c0)))
        _close(got_cell, ref_cell)
        _close([outs, h_t, c_t], [ref_scan[0], *ref_scan[1]])
    else:
        jp, p = jcells.RNNCellParams(*map(jnp.asarray, leaves)), \
            RNNCellParams(*map(_t, leaves))
        ref_cell = jax.jit(jcells.rnn_cell)(jp, x[:, 0], h0)
        ref_scan = jax.jit(jcells.rnn_scan)(jp, x, h0)
        _close([rnn_cell(p, _t(x[:, 0]), _t(h0))], [ref_cell])
        _close(rnn_scan(p, _t(x), _t(h0)), ref_scan)


def _setup(cell, act="tanh"):
    """The JAX and port models and the port's init laid into the JAX
    package's tree (``jax.eval_shape`` gives its structure without
    compiling the init)."""
    jm, m = JVRAE(D, H, Z, cell, act), VRAE(D, H, Z, cell, act)
    params = m.init(torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    assert [tuple(s.shape) for s in jax.tree.leaves(shapes)] == [
        tuple(t.shape) for t in tree_leaves(params)]
    jp = jax.tree.unflatten(jax.tree.structure(shapes), [
        jnp.asarray(t.numpy()) for t in tree_leaves(params)])
    x = np.random.default_rng(1).normal(size=(B, T, D)).astype(np.float32)
    return jm, m, jp, params, x


@pytest.mark.parametrize("cell", ["rnn", "gru", "lstm"])
def test_vrae_matches_jax(cell):
    """encode; decode with a target at teacher-forcing ratio 0.5 on JAX's
    coins; forward on JAX's epsilon and coins (the key's split: epsilon
    first); generate with no target."""
    jm, m, jp, params, x = _setup(cell)
    key = jax.random.key(2)
    jx = jnp.asarray(x)

    _close(m.encode(params, _t(x)), jax.jit(jm.encode)(jp, jx))
    z = np.random.default_rng(3).normal(size=(B, Z)).astype(np.float32)
    ref_dec = jax.jit(jm.decode, static_argnums=2)(jp, jnp.asarray(z), T, key,
                                                   jx, 0.5)
    coins = _t(jax.random.uniform(key, (T,)))
    got = m.decode(params, _t(z), T, target=_t(x), teacher_forcing_ratio=0.5,
                   coins=coins)
    _close([got], [ref_dec])

    ref_fwd = jax.jit(jm.forward)(jp, jx, key, 0.5)
    k_z, k_tf = jax.random.split(key)
    eps = _t(jax.random.normal(k_z, (B, Z)))
    got = m.forward(params, _t(x), None, 0.5, eps=eps,
                    coins=_t(jax.random.uniform(k_tf, (T,))))
    _close(got, ref_fwd)

    ref_gen = jax.jit(jm.generate, static_argnums=2)(jp, jnp.asarray(z), T)
    _close([m.generate(params, _t(z), T)], [ref_gen])


def test_vrae_draws_and_errors():
    """forward draws epsilon, then the coins, from its generator; decode
    with a target needs coins or a generator; an unknown cell raises."""
    _, m, _, params, x = _setup("gru")
    a = m.forward(params, _t(x), torch.Generator().manual_seed(4), 0.5)
    g = torch.Generator().manual_seed(4)
    eps, coins = torch.randn((B, Z), generator=g), torch.rand((T,), generator=g)
    b = m.forward(params, _t(x), None, 0.5, eps=eps, coins=coins)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="coins"):
        m.decode(params, torch.zeros((B, Z)), T, target=_t(x))
    with pytest.raises(ValueError, match="rnn_type"):
        VRAE(D, rnn_type="transformer")


def test_fit_vrae_step_matches_optax():
    """Two updates of ``fit_vrae``'s step at teacher-forcing ratios 0.9 and
    0.4 (the start token unread, its gradient zeros as JAX's) against
    ``jax.value_and_grad`` and ``optax.adam`` on the same draws: params,
    Adam's moments and the metrics."""
    jm, m, jp, params, x = _setup("gru")
    opt, beta = optax.adam(LR), 0.5
    jx = jnp.asarray(x)

    @jax.jit
    def jstep(p, s, key, tf):
        def loss_fn(q):
            recon, mu, logvar = jm.forward(q, jx, key, tf)
            total, rec, kld = jm.loss(recon, jx, mu, logvar, beta)
            return total, (rec, kld)
        (total, (rec, kld)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(p)
        upd, s = opt.update(grads, s, p)
        return optax.apply_updates(p, upd), s, (total, rec, kld)

    step = make_vrae_step(m, _t(x), LR, beta)
    js, state = opt.init(jp), adam_init(params)
    for key, tf in ((jax.random.key(5), 0.9), (jax.random.key(6), 0.4)):
        jp, js, jmet = jstep(jp, js, key, jnp.float32(tf))
        k_z, k_tf = jax.random.split(key)
        params, state, met = step(params, state, tf,
                                  _t(jax.random.normal(k_z, (B, Z))),
                                  _t(jax.random.uniform(k_tf, (T,))))
    _close(tree_leaves(params), jax.tree.leaves(jp), STEP)
    _close(tree_leaves(state.mu), jax.tree.leaves(js[0].mu), STEP)
    _close(tree_leaves(state.nu), jax.tree.leaves(js[0].nu), STEP)
    _close([met["total"], met["rec"], met["kld"]], jmet, STEP)


def test_schedules_match_jax():
    for e in (0, 1, 7, 99):
        assert exponential_teacher_forcing_schedule(e, 0.9, 0.02) == \
            jvrae.exponential_teacher_forcing_schedule(e, 0.9, 0.02)
        assert linear_teacher_forcing_schedule(e, 1.0, 0.1, 50) == \
            jvrae.linear_teacher_forcing_schedule(e, 1.0, 0.1, 50)


def test_fit_vrae_replays_from_its_draws():
    """``fit_vrae``: each epoch the schedule's ratio, epsilon (N, Z) then
    the coins (T,) from the generator, one full-batch step; the returned
    metrics are the last epoch's with its ratio."""
    _, m, _, params, x = _setup("lstm")
    sched = exponential_teacher_forcing_schedule
    got, metrics = fit_vrae(m, params, _t(x), torch.Generator().manual_seed(7),
                            epochs=3, lr=LR, beta=0.5,
                            teacher_forcing_schedule=sched)
    g = torch.Generator().manual_seed(7)
    step, state, p = make_vrae_step(m, _t(x), LR, 0.5), adam_init(params), params
    for e in range(3):
        eps = torch.randn((B, Z), generator=g)
        coins = torch.rand((T,), generator=g)
        p, state, met = step(p, state, sched(e), eps, coins)
    for a, r in zip(tree_leaves(got), tree_leaves(p)):
        assert torch.equal(a, r)
    assert metrics == {**{k: float(v) for k, v in met.items()},
                       "tf_ratio": sched(2)}


def test_vrae_step_float32_departs_only_at_vanishing_gradients():
    """vrae_demo's step in float32 against the same step in float64, from
    the same parameters, data, epsilon and coins: the metrics and Adam's
    moments within the step tolerance, and every parameter beyond it is
    one whose first gradient is of the order of Adam's eps (1e-8), where
    Adam divides the gradient by itself and a few per cent of rounding
    moves the step by more than the tolerance.  ``chip_smoke.py``'s
    card-against-CPU check of this step excludes such parameters by this
    witness."""
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.configs.experiments import vrae_model
    from vae_connexe_torch.utils.tree import tree_map

    exp = get_experiment("vrae_demo")
    m = vrae_model(exp)
    g = torch.Generator().manual_seed(71)
    params = m.init(g, "cpu")
    x = torch.randn((32, exp.t, exp.p), generator=g)
    draws = [(exponential_teacher_forcing_schedule(e, decay_rate=0.02),
              torch.randn((32, exp.latent), generator=g),
              torch.rand((exp.t,), generator=g)) for e in range(2)]

    def run(dtype):
        to = lambda t: t.to(dtype)    # noqa: E731
        step, p = make_vrae_step(m, to(x), 1e-3, 0.5), tree_map(to, params)
        state, out = adam_init(p), []
        for tf, eps, coins in draws:
            p, state, met = step(p, state, tf, to(eps), to(coins))
            out.append((torch.cat([t.reshape(-1) for t in tree_leaves(p)]),
                        torch.cat([t.reshape(-1) for t in
                                   tree_leaves(state.mu)
                                   + tree_leaves(state.nu)]),
                        torch.stack(list(met.values())),
                        torch.cat([t.reshape(-1).abs() for t in
                                   tree_leaves(state.mu)]) / 0.1))
        return out

    got, want = run(torch.float32), run(torch.float64)
    first_grad = want[0][3]
    for (p, mom, met, _), (rp, rmom, rmet, _) in zip(got, want):
        torch.testing.assert_close(met.double(), rmet, **STEP)
        torch.testing.assert_close(mom.double(), rmom, **STEP)
        off = (p.double() - rp).abs() > STEP["atol"] + STEP["rtol"] * rp.abs()
        assert bool((first_grad[off] < 1e-6).all()), first_grad[off]
