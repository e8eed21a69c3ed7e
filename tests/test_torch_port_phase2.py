"""The port's phase 2 against the JAX package: ``ErrorVAE.forward``, the
written-out Adam against ``optax.adam``, ``make_phase2_step`` from the same
JAX-made state on the same draws, and ``fit_phase2``.

States made by the JAX package cross over through ``convert``; the draws a
JAX step takes from its key (``k_batch, k_z, k_e``) are computed from that
key and handed to the port as tensors.  On the CPU every recurrence runs its
plain version.

Tolerances: forward 1e-5; Adam on the same gradients rtol 1e-6, atol 1e-9
(float32, the same operations); one and five steps rtol 1e-4, atol 1e-6, the
phase-1 step test's.
"""

import dataclasses
import inspect

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.models import CRVAE, ErrorVAE, ErrorVAEParams
from vae_connexe_torch.optim import adam_init, adam_update
from vae_connexe_torch.train import (
    CSRAETrainConfig,
    Phase2Config,
    Phase2State,
    WInTrainConfig,
    fit_phase1,
    fit_phase2,
    make_phase2_step,
)
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.train import config as jconfig
from vae_connexe_tpu.train import fit_phase1 as jax_fit_phase1
from vae_connexe_tpu.train import fit_phase2 as jax_fit_phase2
from vae_connexe_tpu.train.crvae_trainer import Phase2State as JPhase2State
from vae_connexe_tpu.train.crvae_trainer import make_phase2_step as jax_step
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
P, H, E, T, B, N = 4, 8, 3, 7, 16, 40
HE, Z = 6, 5
CFG = dict(max_iter=1, check_every=1, batch_size=B, lr=0.03, lr_error=1e-2,
           beta=1.0, beta_error=0.5, lam_ridge=0.01)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _sd(tree):
    return flax.serialization.to_state_dict(tree)


@pytest.fixture(scope="module")
def setup():
    jm = JCRVAE(p=P, hidden=H, enc_len=E)
    je = JErrorVAE(d=P, hidden=HE, latent=Z)
    jp, jep = jm.init(jax.random.key(0)), je.init(jax.random.key(1))
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(N, T, P)).astype(np.float32)
    parents = (rng.random((P, P)) > 0.4).astype(np.float32)
    return jm, je, jp, jep, windows, parents


@pytest.mark.parametrize("args", [(10, 64), (10, 64, None, True, 21),
                                  (5, 8, 3, False), (3, 4, 2, True, 9)])
def test_error_vae_positional_signature_matches_jax(args):
    """ErrorVAE(d, hidden, latent, shift_decoder_input, rollout_len) in
    JAX's order."""
    jm, m = JErrorVAE(*args), ErrorVAE(*args)
    for name in ("d", "hidden", "latent", "shift_decoder_input",
                 "rollout_len"):
        assert getattr(m, name) == getattr(jm, name), name


@pytest.mark.parametrize("port,ref", [(fit_phase1, jax_fit_phase1),
                                      (fit_phase2, jax_fit_phase2)],
                         ids=["fit_phase1", "fit_phase2"])
def test_fit_signature_matches_jax(port, ref):
    """The fits' parameter names, order and defaults are JAX's, with the
    generator in place of the key."""
    got = [(n, p.default) for n, p in inspect.signature(port).parameters.items()]
    want = [("generator" if n == "key" else n, p.default)
            for n, p in inspect.signature(ref).parameters.items()]
    assert got == want


@pytest.mark.parametrize("name", ["Phase2Config", "WInTrainConfig",
                                  "CSRAETrainConfig"])
def test_config_fields_match_jax(name):
    port = {"Phase2Config": Phase2Config, "WInTrainConfig": WInTrainConfig,
            "CSRAETrainConfig": CSRAETrainConfig}[name]
    got = [(f.name, f.default) for f in dataclasses.fields(port)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(getattr(jconfig, name))]
    assert got == want


@pytest.mark.parametrize("shift", [True, False], ids=["shift", "no-shift"])
def test_error_vae_forward_matches_jax(setup, shift):
    """Encoder from h0 = 0, z from the key's draw, tanh(z2h(z)) as the
    decoder's h0, the shifted or unshifted input, the readout."""
    _, _, _, jep, windows, _ = setup
    je = JErrorVAE(d=P, hidden=HE, latent=Z, shift_decoder_input=shift)
    e = ErrorVAE(P, HE, Z, shift)
    tep = convert.from_numpy(ErrorVAEParams, _sd(jep), "cpu")
    key = jax.random.key(3)
    ref = je.forward(jep, jnp.asarray(windows[:B]), key)
    eps = _t(jax.random.normal(key, (B, Z)))
    got = e.forward(tep, _t(windows[:B]), eps)
    assert got[0].shape == (B, T, P)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **FWD)


def test_error_vae_forward_needs_a_draw(setup):
    e = ErrorVAE(P, HE, Z)
    params = e.init(torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="eps"):
        e.forward(params, torch.zeros((2, T, P)))
    a = e.forward(params, torch.zeros((2, T, P)),
                  generator=torch.Generator().manual_seed(1))
    b = e.forward(params, torch.zeros((2, T, P)),
                  eps=torch.randn((2, Z), generator=torch.Generator()
                                  .manual_seed(1)))
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_adam_matches_optax():
    """Five updates of the same gradients (one of them tiny, near eps) from
    the same params: params, moments and count as optax's."""
    rng = np.random.default_rng(4)
    shapes = {"a": (3, 4), "b": (5,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (1e-8 if i == 2 else 1.0))
              .astype(np.float32) for k, s in shapes.items()} for i in range(5)]
    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)

    @dataclasses.dataclass(frozen=True)
    class Tree:
        a: torch.Tensor
        b: torch.Tensor

    tp = Tree(**{k: _t(v) for k, v in params.items()})
    ts = adam_init(tp)
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp, ts = adam_update(Tree(**{k: _t(v) for k, v in g.items()}), ts,
                             tp, 1e-2)
    adam = js[0]
    assert int(ts.count) == int(adam.count) == 5
    for k in shapes:
        for got, ref in ((getattr(tp, k), jp[k]), (getattr(ts.mu, k), adam.mu[k]),
                         (getattr(ts.nu, k), adam.nu[k])):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-6, atol=1e-9)


def _draws(key):
    """The draws a JAX phase-2 step takes from its state's key."""
    _, k_batch, k_z, k_e = jax.random.split(key, 4)
    idx = np.asarray(jax.random.randint(k_batch, (B,), 0, N))
    return (idx, np.asarray(jax.random.normal(k_z, (B, H))),
            np.asarray(jax.random.normal(k_e, (B, Z))))


def _jax_state(jp, jep, key, opt):
    return JPhase2State(params=jp, err_params=jep, err_opt=opt.init(jep),
                        prior=None, best_params=jp,
                        best_loss=jnp.array(jnp.inf), key=key,
                        step=jnp.zeros([], jnp.int32))


def _port_state(js) -> Phase2State:
    fields = convert.phase2_state_from_numpy(
        _sd(js.params), _sd(js.err_params), _sd(js.err_opt), "cpu")
    best = convert.phase2_state_from_numpy(
        _sd(js.best_params), _sd(js.err_params), _sd(js.err_opt), "cpu")
    return Phase2State(**fields, prior=None, best_params=best["params"],
                       best_loss=torch.tensor(float(js.best_loss)),
                       generator=torch.Generator(), step=int(js.step))


def _worst(a, r):
    d = np.abs(a - r) - STEP["rtol"] * np.abs(r)
    i = np.unravel_index(np.argmax(d), d.shape)
    return f"worst element {i}: port {a[i]!r} vs JAX {r[i]!r}"


def _assert_state_close(got: Phase2State, ref: JPhase2State):
    pairs = [(got.params, ref.params), (got.best_params, ref.best_params),
             (got.err_params, ref.err_params),
             (got.err_opt.mu, ref.err_opt[0].mu),
             (got.err_opt.nu, ref.err_opt[0].nu)]
    for port_tree, jax_tree in pairs:
        for a, r in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
            a, r = a.numpy(), np.asarray(r)
            np.testing.assert_allclose(a, r, **STEP, err_msg=_worst(a, r))
    assert int(got.err_opt.count) == int(ref.err_opt[0].count)
    np.testing.assert_allclose(float(got.best_loss), float(ref.best_loss),
                               **STEP)
    assert got.step == int(ref.step)


_JSTEPS = {}


def _jax_step(setup, parents):
    """The JAX phase-2 step, jitted once per parents mask."""
    jm, je, _, _, windows, _ = setup
    key = parents.tobytes()
    if key not in _JSTEPS:
        _JSTEPS[key] = jax.jit(jax_step(
            jm, je, jconfig.Phase2Config(**CFG), jnp.asarray(windows),
            jnp.asarray(parents), optax.adam(CFG["lr_error"])))
    return _JSTEPS[key]


def _run_both(setup, parents, js, steps):
    """``steps`` phase-2 steps of each package from the JAX state ``js``,
    the port's on the JAX draws.  Returns both states and the last
    metrics."""
    windows = setup[4]
    cfg = Phase2Config(**CFG)
    jstep = _jax_step(setup, parents)
    pstep = make_phase2_step(CRVAE(P, H, E), ErrorVAE(P, HE, Z), cfg,
                             _t(windows), _t(parents))
    state = _port_state(js)
    for _ in range(steps):
        idx, eps, eps_err = _draws(js.key)
        js, jmet = jstep(js, None)
        state, met = pstep(state, batch=_t(windows[idx]), eps=_t(eps),
                           eps_err=_t(eps_err))
    return state, js, met, jmet


@pytest.mark.parametrize("masked", [False, True])
def test_one_step_matches_jax(setup, masked):
    """One ``make_phase2_step`` in each package from the same JAX-made
    state on the same draws: params, best params and loss, ErrorVAE params,
    Adam's state and the metrics."""
    _, _, jp, jep, _, parents = setup
    parents = parents if masked else np.ones((P, P), np.float32)
    js = _jax_state(jp, jep, jax.random.key(5), optax.adam(CFG["lr_error"]))
    state, js, met, jmet = _run_both(setup, parents, js, 1)
    _assert_state_close(state, js)
    assert set(met) == set(jmet) == {"recon", "latent_reg", "mean_loss",
                                     "loss_e", "kl_e"}
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k]), float(v), **STEP, err_msg=k)


def test_five_steps_from_a_trained_state_match_jax(setup):
    """Three JAX steps make a state with an Adam count of 3 and a finite
    best; five more steps of each package from it, masked."""
    _, _, jp, jep, _, parents = setup
    js = _jax_state(jp, jep, jax.random.key(6), optax.adam(CFG["lr_error"]))
    jstep = _jax_step(setup, parents)
    for _ in range(3):
        js, _ = jstep(js, None)
    assert int(js.err_opt[0].count) == 3
    state, js, met, jmet = _run_both(setup, parents, js, 5)
    _assert_state_close(state, js)
    for k, v in jmet.items():
        np.testing.assert_allclose(float(met[k]), float(v), **STEP, err_msg=k)


def test_step_draws_in_order(setup):
    """Without draws passed in, a step takes the batch indices, then eps
    (B, H), then the ErrorVAE's eps (B, Z) from the state's generator."""
    _, _, _, _, windows, parents = setup
    m, e = CRVAE(P, H, E), ErrorVAE(P, HE, Z)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    eparams = e.init(torch.Generator().manual_seed(2), "cpu")
    cfg = Phase2Config(**CFG)
    step = make_phase2_step(m, e, cfg, _t(windows), _t(parents))

    def fresh(seed):
        return Phase2State(params=params, err_params=eparams,
                           err_opt=adam_init(eparams), prior=None,
                           best_params=params,
                           best_loss=torch.tensor(float("inf")),
                           generator=torch.Generator().manual_seed(seed),
                           step=0)

    drawn, met = step(fresh(7))
    g = torch.Generator().manual_seed(7)
    idx = torch.randint(0, N, (B,), generator=g)
    eps = torch.randn((B, H), generator=g)
    eps_err = torch.randn((B, Z), generator=g)
    given, ref = step(fresh(0), batch=_t(windows)[idx], eps=eps,
                      eps_err=eps_err)
    for a, r in zip(tree_leaves(drawn.params) + tree_leaves(drawn.err_params),
                    tree_leaves(given.params) + tree_leaves(given.err_params)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert drawn.step == 1 and float(met["loss_e"]) == float(ref["loss_e"])


def test_fit_phase2_runs_max_iter_keeps_the_mask_and_the_best(setup):
    """Exactly max_iter steps in chunks of check_every; every head input
    column off the mask stays zero; the returned params are the pre-update
    params of the step with the lowest mean_loss, replayed here step by
    step from the same generator; the ErrorVAE params are the last."""
    _, _, _, _, windows, parents = setup
    m, e = CRVAE(P, H, E), ErrorVAE(P, HE, Z)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    eparams = e.init(torch.Generator().manual_seed(2), "cpu")
    cfg = Phase2Config(max_iter=7, check_every=3, batch_size=8, lr=0.3)
    seen = []
    best, err, state, metrics = fit_phase2(
        m, e, params, eparams, _t(windows), _t(parents), cfg,
        torch.Generator().manual_seed(3),
        callback=lambda step, st, met: seen.append(step))
    assert seen == [3, 6, 7] and state.step == 7
    assert int(state.err_opt.count) == 7
    assert set(metrics) == {"recon", "latent_reg", "mean_loss", "loss_e",
                            "kl_e"}
    off = torch.tensor(parents) == 0
    for tree in (best, state.params):
        assert (tree.heads.w_ih.permute(0, 2, 1)[off] == 0).all()

    step = make_phase2_step(m, e, cfg, _t(windows), _t(parents))
    replay = Phase2State(params=params, err_params=eparams,
                         err_opt=adam_init(eparams), prior=None,
                         best_params=params,
                         best_loss=torch.tensor(float("inf")),
                         generator=torch.Generator().manual_seed(3), step=0)
    history = []
    for _ in range(7):
        before = replay.params
        replay, met = step(replay)
        history.append((float(met["mean_loss"]), before))
    lowest = min(history, key=lambda h: h[0])
    for a, r in zip(tree_leaves(best), tree_leaves(lowest[1])):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    for a, r in zip(tree_leaves(err), tree_leaves(replay.err_params)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
    assert float(state.best_loss) == lowest[0]


def test_cs_raises_where_phase2_training_starts(setup):
    """Where phase 2's training starts, latent_reg='cs' now trains: the fit
    draws a GMM prior of gmm_components x hidden from its generator first
    and moves it every step, the KL stays on the ErrorVAE; a regulariser
    that is neither 'kl' nor 'cs' raises; a mesh of one rank trains the
    same fit bit for bit, and an object that is no mesh raises a
    TypeError."""
    _, _, _, _, windows, parents = setup
    m, e = CRVAE(P, H, E), ErrorVAE(P, HE, Z)
    cfg = Phase2Config(latent_reg="cs", lambda_cs=0.1, gmm_components=10,
                       max_iter=3, check_every=3, batch_size=B)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    eparams = e.init(torch.Generator().manual_seed(2), "cpu")
    _, _, state, metrics = fit_phase2(m, e, params, eparams, _t(windows),
                                      _t(parents), cfg,
                                      torch.Generator().manual_seed(3))
    first = 0.05 * torch.randn((10, H),
                               generator=torch.Generator().manual_seed(3))
    assert state.prior.mu.shape == state.prior.logvar.shape == (10, H)
    assert not torch.equal(state.prior.mu, first)
    assert all(np.isfinite(v) for v in metrics.values())
    assert metrics["latent_reg"] >= 0
    with pytest.raises(ValueError, match="latent_reg"):
        fit_phase2(m, e, params, eparams, _t(windows), _t(parents),
                   Phase2Config(latent_reg="l1"), torch.Generator())
    with pytest.raises(TypeError, match="make_mesh"):
        fit_phase2(m, e, params, eparams, _t(windows), _t(parents),
                   Phase2Config(), torch.Generator(), mesh=object())
    from torch_ranks import world_of_one

    meshed = fit_phase2(m, e, params, eparams, _t(windows), _t(parents),
                        cfg, torch.Generator().manual_seed(3),
                        mesh=world_of_one())
    assert meshed[3] == metrics
    assert torch.equal(meshed[2].prior.mu, state.prior.mu)
    for a, b in zip(tree_leaves(meshed[:2]), tree_leaves(
            (state.best_params, state.err_params))):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
