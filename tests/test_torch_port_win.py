"""The W_in family of the port against the JAX package (CPU): ``WInCRVAE``
(encode, forward in both phases, generate, the Granger matrix),
``WInTrainer`` (stage-I and stage-II steps from a JAX-made state on
JAX's batches and draws, the prune and the support mask, ``fit_many``
seed by seed against the single fits), win discovery and the
context-conditioned artifact and server.

Parameters and trainer states made by the JAX package cross over through
``convert``; the draws a JAX step takes from its key (``k_z``, then
``k_e`` from the split of ``k_z``) are computed from that key and handed
to the port as tensors.  On the CPU every recurrence runs its plain
version.  Tolerances: forward and generate 1e-5; one and five steps rtol
1e-4, atol 1e-6 (``tests/test_torch_port_phase2.py``'s ``STEP``);
``fit_many`` against the single fits rtol 1e-5.
"""

import dataclasses
import io
import json
import urllib.error
import urllib.request

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.discover import discover
from vae_connexe_torch.models import WInCRVAE, WInCRVAEParams
from vae_connexe_torch.server import GeneratorServer
from vae_connexe_torch.serving import export_win_generator, load_generator
from vae_connexe_torch.train import WInTrainConfig, WInTrainer, WInTrainState
from vae_connexe_torch.utils.tree import stack_trees, tree_leaves, unstack_tree
from vae_connexe_tpu.data import var_process as jvar_process
from vae_connexe_tpu.data import var_truth as jvar_truth
from vae_connexe_tpu.models import WInCRVAE as JWInCRVAE
from vae_connexe_tpu.train import WInTrainConfig as JWInTrainConfig
from vae_connexe_tpu.train import WInTrainer as JWInTrainer
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
D, H, Z, TAU, B, N = 4, 8, 6, 4, 16, 40


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _port(tree, cls=WInCRVAEParams):
    return convert.from_numpy(cls, flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, tree)), "cpu")


def _close(port_tree, jax_tree, tol):
    for a, b in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


@pytest.fixture(scope="module")
def setup():
    """The JAX model, its params, the port's model, the same params
    carried across by ``convert``, and the windows.  The params are the
    port's init laid into the JAX package's tree (whose structure
    ``jax.eval_shape`` gives without running its init, which compiles
    some forty small programs on the CPU)."""
    jm = JWInCRVAE(d=D, hidden=H, latent=Z, tau=TAU)
    m = WInCRVAE(d=D, hidden=H, latent=Z, tau=TAU)
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    jp = jax.tree.unflatten(jax.tree.structure(shapes), [
        jnp.asarray(a.numpy()) for a in
        tree_leaves(m.init(torch.Generator().manual_seed(0), "cpu"))])
    rng = np.random.default_rng(0)
    windows = rng.normal(size=(N, 2 * TAU, D)).astype(np.float32)
    return jm, jp, m, _port(jp), windows


def test_init_shapes_and_order(setup):
    jm, jp, m, tp, _ = setup
    mine = m.init(torch.Generator().manual_seed(0), "cpu")
    shapes = jax.eval_shape(jm.init, jax.random.key(0))
    for a, b in zip(tree_leaves(mine), jax.tree.leaves(shapes), strict=True):
        assert tuple(a.shape) == b.shape and str(a.dtype)[6:] == b.dtype
    assert m.err_vae.hidden == H // 2 and m.err_vae.latent == Z // 2
    assert not m.err_vae.shift_decoder_input


def test_encode_matches_jax(setup):
    jm, jp, m, tp, windows = setup
    ref = jm.encode(jp, jnp.asarray(windows[:, :TAU]))
    got = m.encode(tp, _t(windows[:, :TAU]))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def _forward_draws(m, key, b):
    """The epsilons JAX's ``WInCRVAE.forward`` takes from ``key``."""
    k_z, k_e = jax.random.split(key)
    return (_t(jax.random.normal(k_z, (b, m.latent))),
            _t(jax.random.normal(k_e, (b, m.err_vae.latent))))


@pytest.mark.parametrize("phase", [1, 2])
def test_forward_matches_jax(setup, phase):
    jm, jp, m, tp, windows = setup
    xp, xc = windows[:, :TAU], windows[:, TAU:]
    key = jax.random.key(3)
    ref = jm.forward(jp, jnp.asarray(xp), jnp.asarray(xc), key, phase=phase)
    eps_z, eps_e = _forward_draws(m, key, N)
    got = m.forward(tp, _t(xp), _t(xc), eps_z, phase, eps_e)
    for a, b in zip(got, ref):
        if b is None:
            assert a is None
        else:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **FWD)


def test_forward_draws_in_jax_order(setup):
    """A generator draws eps_z, then (phase 2) eps_e."""
    _, _, m, tp, windows = setup
    xp, xc = _t(windows[:, :TAU]), _t(windows[:, TAU:])
    g = torch.Generator().manual_seed(5)
    got = m.forward(tp, xp, xc, phase=2, generator=g)
    g = torch.Generator().manual_seed(5)
    eps_z = torch.randn((N, Z), generator=g)
    eps_e = torch.randn((N, Z // 2), generator=g)
    want = m.forward(tp, xp, xc, eps_z, 2, eps_e)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="draws"):
        m.forward(tp, xp, xc)


def test_generate_matches_jax(setup):
    jm, jp, m, tp, windows = setup
    key = jax.random.key(4)
    ref = jm.generate(jp, jnp.asarray(windows), key, 9)
    eps = _t(jax.random.normal(key, (N, Z)))
    got = m.generate(tp, _t(windows), None, 9, eps=eps)
    assert got.shape == (N, 9, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
    # bf16 serving (ported): within test_serve_dtype.py's elementwise bound
    # of JAX's bf16 generate on the same draw, float32 out.
    ref16 = np.asarray(jm.generate(jp, jnp.asarray(windows), key, 9,
                                   dtype=jnp.bfloat16))
    got16 = m.generate(tp, _t(windows), None, 9, dtype="bfloat16", eps=eps)
    assert got16.dtype == torch.float32
    assert np.abs(got16.numpy() - ref16).max() < 0.15 * (
        np.abs(ref16).max() + 1.0)
    # bf16 values only, and not the float32 generate's.
    torch.testing.assert_close(got16, got16.to(torch.bfloat16).float(),
                               rtol=0, atol=0)
    assert not torch.equal(got16, got)


def test_granger_matrix_matches_jax(setup):
    jm, jp, m, tp, _ = setup
    for thr, binary in ((1e-6, True), (0.2, True), (0.0, False)):
        np.testing.assert_allclose(
            m.granger_matrix(tp, thr, binary).numpy(),
            np.asarray(jm.granger_matrix(jp, thr, binary)), **FWD)
    stacked = m.granger_matrix(stack_trees([tp, tp]), threshold=False)
    assert stacked.shape == (2, D, D)


# ---------------- the trainer ----------------

_JAX = {}


def _jax_trainer(jm, prox, update):
    key = (prox, update)
    if key not in _JAX:
        _JAX[key] = JWInTrainer(jm, JWInTrainConfig(
            lr=2e-2, lam=0.5, prox_groups=prox, batch_size=B,
            prune_threshold=0.02, update_w_in_stage2=update))
    return _JAX[key]


def _port_state(jstate):
    sd = flax.serialization.to_state_dict(
        jax.tree.map(np.asarray, jstate.opt_state))
    parts = convert.win_state_from_numpy(
        flax.serialization.to_state_dict(
            jax.tree.map(np.asarray, jstate.params)), sd, "cpu")
    return WInTrainState(generator=torch.Generator(), step=0, **parts)


def _step_draws(m, jstate):
    """The epsilons a JAX step takes from ``state.key``."""
    _, k_z = jax.random.split(jstate.key)
    return _forward_draws(m, k_z, B)


@pytest.mark.parametrize("prox,update", [("row", True), ("element", False)])
def test_steps_match_jax(setup, prox, update):
    """From a JAX-made state (two stage-I steps in): one and five stage-I
    steps, the prune, then one and five stage-II steps, each on JAX's
    batch and draws; params, Adam's state and metrics.  The two cases
    cover both prox groups (stage I) and both stage-II rules, the masked
    W_in step at row granularity among them."""
    jm, jp, m, _, windows = setup
    jt = _jax_trainer(jm, prox, update)
    cfg = WInTrainConfig(**dataclasses.asdict(jt.cfg))
    tt = WInTrainer(m, cfg)
    rng = np.random.default_rng(1)
    js = jt.init_state(jp, jax.random.key(7))
    for _ in range(2):
        js, _ = jt.step_stage1(js, jnp.asarray(windows[rng.integers(0, N, B)]))
    ts = _port_state(js)
    for stage in (1, 2):
        if stage == 2:
            js = js.replace(params=jt.prune(js.params))
            ts = dataclasses.replace(ts, params=tt.prune(ts.params))
            _close(ts.params, js.params, STEP)
        for k in range(5):
            batch = windows[rng.integers(0, N, B)]
            eps_z, eps_e = _step_draws(m, js)
            if stage == 1:
                js, jmet = jt.step_stage1(js, jnp.asarray(batch))
                ts, tmet = tt.step_stage1(ts, _t(batch), eps_z)
            else:
                js, jmet = jt.step_stage2(js, jnp.asarray(batch))
                ts, tmet = tt.step_stage2(ts, _t(batch), eps_z, eps_e)
            if k in (0, 4):
                _close(ts.params, js.params, STEP)
                adam = js.opt_state.inner_states["adam"].inner_state[0]
                _close(ts.opt_state.mu, adam.mu, STEP)
                _close(ts.opt_state.nu, adam.nu, STEP)
                assert int(ts.opt_state.count) == int(adam.count)
                for name, v in jmet.items():
                    np.testing.assert_allclose(float(tmet[name]), float(v),
                                               **STEP, err_msg=name)
    frozen = ts.params.w_in == 0
    if not update:   # stage II leaves W_in as the prune left it
        assert frozen.sum() > 0


@pytest.mark.parametrize("prox", ["row", "element"])
def test_prune_and_support_mask_match_jax(setup, prox):
    jm, jp, m, tp, _ = setup
    jt = _jax_trainer(jm, prox, True)
    tt = WInTrainer(m, WInTrainConfig(**dataclasses.asdict(jt.cfg)))
    w = np.asarray(jp.w_in).copy()
    w[0, 1] = 0.0
    w[1, 2, :3] = 0.0
    np.testing.assert_array_equal(tt._support_mask(_t(w)).numpy(),
                                  np.asarray(jt._support_mask(jnp.asarray(w))))
    pruned = tt.prune(dataclasses.replace(tp, w_in=_t(w)))
    np.testing.assert_array_equal(
        pruned.w_in.numpy(),
        np.asarray(jt.prune(jp.replace(w_in=jnp.asarray(w))).w_in))


def test_fit_many_matches_single_fits_seed_by_seed(setup):
    """Three seeds trained at once equal three ``fit``s on the same
    generators (stage I and stage II, W_in updated in both)."""
    _, _, m, _, windows = setup
    cfg = WInTrainConfig(lr=1e-2, lam=0.05, prox_groups="element",
                         batch_size=B, stage1_epochs=3, stage2_epochs=2,
                         update_w_in_stage2=True)
    tt = WInTrainer(m, cfg)
    inits = [m.init(torch.Generator().manual_seed(s), "cpu") for s in range(3)]
    many, met = tt.fit_many(stack_trees(inits), _t(windows),
                            [torch.Generator().manual_seed(10 + s)
                             for s in range(3)])
    assert met["loss"].shape == (3,)
    for s in range(3):
        one, m1 = tt.fit(inits[s], _t(windows),
                         torch.Generator().manual_seed(10 + s))
        for a, b in zip(tree_leaves(unstack_tree(many, s)), tree_leaves(one)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
        assert m1["loss"] == pytest.approx(float(met["loss"][s]), rel=1e-5)
    # A mesh of one rank keeps every seed on the rank: the same fits
    # (the split over dp: tests/test_torch_port_parallel.py).
    from torch_ranks import world_of_one

    meshed, met_m = tt.fit_many(stack_trees(inits), _t(windows),
                                [torch.Generator().manual_seed(10 + s)
                                 for s in range(3)], mesh=world_of_one())
    for a, b in zip(tree_leaves(meshed), tree_leaves(many)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(met_m["loss"], met["loss"], rtol=0, atol=0)
    with pytest.raises(TypeError, match="make_mesh"):
        tt.fit_many(stack_trees(inits), _t(windows), [], mesh=object())


def test_fit_returns_stage1_params_and_prunes(setup):
    _, _, m, _, windows = setup
    tt = WInTrainer(m, WInTrainConfig(lr=1e-2, lam=0.5, batch_size=B,
                                      stage1_epochs=2, stage2_epochs=1,
                                      prune_threshold=0.02))
    init = m.init(torch.Generator().manual_seed(1), "cpu")
    params, metrics, s1 = tt.fit(init, _t(windows), torch.Generator(),
                                 return_stage1=True)
    assert set(metrics) == {"loss", "recon", "kl"}
    # Stage II leaves W_in as the prune left it.
    torch.testing.assert_close(params.w_in, tt.prune(s1).w_in, rtol=0, atol=0)


# ---------------- discovery ----------------

@pytest.fixture(scope="module")
def var_series():
    a = jvar_truth(5)
    series = np.asarray(jvar_process(jax.random.key(0), a, n=1, t=400))[0]
    return series, np.asarray(a > 0).astype(int)


def test_win_single_seed(var_series):
    series, truth = var_series
    res = discover(series, context=10, max_iter=6, batch_size=128,
                   family="win", device="cpu")
    assert res.scores.shape == truth.shape
    assert set(np.unique(res.gc)) <= {0, 1}
    assert np.isfinite(res.scores).all()
    assert res.metrics.keys() == {"loss", "recon", "kl"}


def test_win_stability_and_generate(var_series):
    series, truth = var_series
    res = discover(series, context=10, max_iter=4, batch_size=128,
                   family="win", prox="element", seeds=3, generate=6,
                   device="cpu")
    assert res.votes is not None and res.votes.shape == truth.shape
    assert res.seed_scores.shape == (3,) + truth.shape
    assert res.samples.shape == (6, 10, series.shape[1])
    assert np.isfinite(res.samples).all()


def test_win_seed0_in_the_sweep_matches_sequential(var_series):
    """Seed 0 of the folded sweep trains from the single run's own init
    and run generators."""
    series, _ = var_series
    kw = dict(context=10, max_iter=3, batch_size=128, family="win", seed=3,
              device="cpu")
    seq = discover(series, **kw)
    swept = discover(series, seeds=3, **kw)
    np.testing.assert_allclose(swept.seed_scores[0], seq.scores, rtol=1e-4,
                               atol=1e-5)


def test_win_validation(var_series):
    """The win family's mesh shards its stability seeds over dp: with two
    seeds on a world of one rank, the unmeshed result; an object that is
    no mesh raises a TypeError."""
    from torch_ranks import world_of_one

    series, _ = var_series
    kw = dict(context=10, max_iter=1, family="win", seeds=2, device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        discover(series, mesh=object(), **kw)
    meshed = discover(series, mesh=world_of_one(), **kw)
    np.testing.assert_array_equal(meshed.seed_scores,
                                  discover(series, **kw).seed_scores)


# ---------------- the context-conditioned artifact ----------------

@pytest.fixture(scope="module")
def win():
    model = WInCRVAE(d=4, hidden=16, latent=8, tau=5)
    return model, model.init(torch.Generator().manual_seed(0), "cpu")


def test_win_artifact_matches_in_process(win):
    model, params = win
    blob = export_win_generator(model, params, batch=3, length=7)
    fn, meta = load_generator(blob, "cpu")
    assert meta["kind"] == "win_conditioned_generator"
    assert meta["tau"] == model.tau and meta["batch"] == 3
    ctx = np.random.default_rng(1).normal(size=(3, model.tau, model.d))
    out = fn(9, ctx)
    assert out.shape == (3, 7, model.d)
    ref = model.generate(params, _t(ctx), torch.Generator().manual_seed(9), 7)
    np.testing.assert_allclose(out, ref.numpy(), atol=1e-6)
    np.testing.assert_array_equal(fn(9, ctx), out)


def test_win_context_shape_validated(win):
    model, params = win
    fn, _ = load_generator(export_win_generator(model, params, batch=3,
                                                length=7), "cpu")
    with pytest.raises(ValueError, match="context shape"):
        fn(0, np.zeros((3, model.tau + 2, model.d), np.float32))
    # A bf16 artifact validates its context the same way.
    fn16, meta = load_generator(export_win_generator(
        model, params, batch=3, length=6, serve_dtype="bfloat16"), "cpu")
    assert meta["serve_dtype"] == "bfloat16"
    with pytest.raises(ValueError, match="context shape"):
        fn16(0, np.zeros((3, model.tau + 2, model.d), np.float32))


def _post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return np.load(io.BytesIO(r.read()))


def test_server_serves_win_artifact(win):
    model, params = win
    srv = GeneratorServer(export_win_generator(model, params, batch=2,
                                               length=5), device="cpu")
    srv.start()
    try:
        ctx = np.random.default_rng(2).normal(size=(2, model.tau, model.d))
        samples = _post(srv, {"seed": 4, "context": ctx.tolist()})
        assert samples.shape == (2, 5, model.d)
        ref = model.generate(params, _t(ctx),
                             torch.Generator().manual_seed(4), 5)
        np.testing.assert_allclose(samples, ref.numpy(), atol=1e-6)
        # No seed: served with a fresh seed, never coalesced.
        assert _post(srv, {"seed": None, "context": ctx.tolist()}).shape \
            == (2, 5, model.d)
        for body, msg in (({"seed": 4}, "context-conditioned"),
                          ({"seed": 4, "context": [[0.0]]}, "context shape")):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(srv, body)
            assert ei.value.code == 400
            assert msg in json.loads(ei.value.read())["error"]
        art = srv._artifacts[srv._default]
        assert art.coalesced_requests == 0 and art.errors == 0
    finally:
        srv.shutdown()
