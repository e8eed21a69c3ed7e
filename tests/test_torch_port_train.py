"""The port's CRVAE training path against the JAX package: encode, forward,
one phase-1 step, the plain version of the whole-step kernel B3 and of its
launches phase by phase, the fit loop, and the conditioned rollout.

Parameters initialised by the JAX package cross over through ``convert``;
the draws a JAX function takes from its key (the reparameterisation
epsilon, the rollout's latent draw) are computed from that key and handed
to the port as tensors.  On the CPU every recurrence runs its plain version.

Tolerances: forward 1e-5; one step (params, metrics) rtol 1e-4, atol 1e-6,
the order of ``tests/test_fused_step.py``.
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.losses import kl_gaussian
from vae_connexe_torch.models import CRVAE, CRVAEParams, masked_heads
from vae_connexe_torch.models.crvae import decoder_input
from vae_connexe_torch.ops import cuda_gru, cuda_step
from vae_connexe_torch.ops.gru import gru_scan
from vae_connexe_torch.optim import prox_column_groups
from vae_connexe_torch.train import Phase1Config, Phase1State, fit_phase1, make_phase1_step
from vae_connexe_torch.train.crvae_trainer import _chunk_lengths
from vae_connexe_torch.utils.layers import dense
from vae_connexe_torch.utils.tree import tree_leaves, tree_unflatten
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.ops.pallas_step import fused_phase1_step as jax_fused_step
from vae_connexe_tpu.train import Phase1Config as JPhase1Config
from vae_connexe_tpu.train.crvae_trainer import Phase1State as JPhase1State
from vae_connexe_tpu.train.crvae_trainer import make_phase1_step as jax_step
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
STEP = dict(rtol=1e-4, atol=1e-6)
P, H, E, T, B = 4, 8, 3, 7, 16         # tests/test_fused_step.py's shape
CFG = dict(max_iter=1, check_every=1, batch_size=B, lam=0.05, lr=0.03,
           lam_ridge=0.01, beta=0.1)


def _port(jax_params) -> CRVAEParams:
    return convert.from_numpy(CRVAEParams,
                              flax.serialization.to_state_dict(jax_params),
                              "cpu")


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def setup():
    jm = JCRVAE(p=P, hidden=H, enc_len=E)
    jp = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    batch = rng.normal(size=(B, T, P)).astype(np.float32)
    parents = (rng.random((P, P)) > 0.4).astype(np.float32)
    return jm, jp, CRVAE(P, H, E), _port(jp), batch, parents


@pytest.mark.parametrize("args", [(20, 64, 10), (5, 8, 3, 9), (3, 4, 2, 5, 0.3)])
def test_crvae_positional_signature_matches_jax(args):
    """CRVAE(p, hidden, enc_len, rollout_len, noise_scale) in JAX's order."""
    jm, m = JCRVAE(*args), CRVAE(*args)
    for name in ("p", "hidden", "enc_len", "rollout_len", "noise_scale"):
        assert getattr(m, name) == getattr(jm, name), name


def test_phase1_config_fields_match_jax():
    """Phase1Config's fields in JAX's names, order and defaults; the CS
    keywords and latent_reg='cs' construct and build a step; a regulariser
    that is neither 'kl' nor 'cs' raises where training starts."""
    got = [(f.name, f.default) for f in dataclasses.fields(Phase1Config)]
    want = [(f.name, f.default) for f in dataclasses.fields(JPhase1Config)]
    assert got == want
    assert Phase1Config(lambda_cs=0.1, gmm_components=10,
                        cs_variant="symmetric").lambda_cs == 0.1
    cfg = Phase1Config(latent_reg="cs", lambda_cs=0.1)
    windows, parents = torch.zeros((4, T, P)), torch.ones((P, P))
    assert callable(make_phase1_step(CRVAE(P, H, E), cfg, windows, parents))
    with pytest.raises(ValueError, match="latent_reg 'l1'"):
        make_phase1_step(CRVAE(P, H, E), Phase1Config(latent_reg="l1"),
                         windows, parents)


def test_encode_matches_jax(setup):
    jm, jp, m, tp, batch, _ = setup
    mu, lv = jm.encode(jp, jnp.asarray(batch))
    got_mu, got_lv = m.encode(tp, _t(batch))
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(mu), **FWD)
    np.testing.assert_allclose(got_lv.numpy(), np.asarray(lv), **FWD)


@pytest.mark.parametrize("deterministic", [True, False], ids=["mean", "eps"])
def test_forward_matches_jax(setup, deterministic):
    """Teacher-forced forward with a parents mask: z = mu, or z from the
    epsilon JAX draws from its key."""
    jm, jp, m, tp, batch, parents = setup
    key = jax.random.key(7)
    ref = jm.forward(jp, jnp.asarray(batch), key, jnp.asarray(parents),
                     deterministic=deterministic)
    eps = None if deterministic else _t(jax.random.normal(key, (B, H)))
    got = m.forward(tp, _t(batch), eps, _t(parents),
                    deterministic=deterministic)
    assert got[0].shape == (B, T - E, P)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **FWD)


def test_forward_needs_eps_or_deterministic(setup):
    _, _, m, tp, batch, _ = setup
    with pytest.raises(ValueError, match="eps"):
        m.forward(tp, _t(batch))


def _jax_one_step(jm, jp, batch, parents, key):
    cfg = JPhase1Config(**CFG)
    step = jax_step(jm, cfg, jnp.asarray(batch), jnp.asarray(parents),
                    fixed_batch=jnp.asarray(batch))
    state = JPhase1State(params=jp, prior=None, best_params=jp,
                         best_loss=jnp.array(jnp.inf), key=key,
                         step=jnp.zeros([], jnp.int32))
    new_state, metrics = step(state, None)
    _, _, k_z = jax.random.split(key, 3)       # the step's epsilon key
    return new_state, metrics, np.asarray(jax.random.normal(k_z, (B, H)))


def _assert_tree_close(port_tree, jax_tree, tol):
    for a, r in zip(tree_leaves(port_tree), jax.tree.leaves(jax_tree)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("masked", [False, True])
def test_jax_initialised_params_take_the_same_step(setup, masked):
    """Params initialised by JAX, one ``make_phase1_step`` in each package on
    the same batch and epsilon, lam > 0 and ridge > 0: the same params,
    best params, best loss and metrics."""
    jm, jp, m, tp, batch, parents = setup
    parents = parents if masked else np.ones((P, P), np.float32)
    new_state, metrics, eps = _jax_one_step(jm, jp, batch, parents,
                                            jax.random.key(42))
    step = make_phase1_step(m, Phase1Config(**CFG), _t(batch), _t(parents),
                            fixed_batch=_t(batch))
    state = Phase1State(params=tp, prior=None, best_params=tp,
                        best_loss=torch.tensor(float("inf")),
                        generator=torch.Generator(), step=0)
    got_state, got = step(state, eps=_t(eps))
    assert got_state.step == 1
    _assert_tree_close(got_state.params, new_state.params, STEP)
    _assert_tree_close(got_state.best_params, new_state.best_params, STEP)
    np.testing.assert_allclose(float(got_state.best_loss),
                               float(new_state.best_loss), **STEP)
    for k, v in metrics.items():
        np.testing.assert_allclose(float(got[k]), float(v), **STEP, err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_step_kernel_plain_matches_pallas_interpret(setup, masked):
    """B3's plain version (the CPU path of ``fused_phase1_step``) against the
    TPU megakernel in Pallas interpret mode; it never launches."""
    jm, jp, m, tp, batch, parents = setup
    parents = parents if masked else np.ones((P, P), np.float32)
    eps = np.random.default_rng(5).normal(size=(B, H)).astype(np.float32)
    ref_params, ref_metrics = jax_fused_step(
        jm, JPhase1Config(**CFG), jp, jnp.asarray(parents), jnp.asarray(batch),
        jnp.asarray(eps), interpret=True)
    cuda_step.reset_launches()
    got_params, got = cuda_step.fused_phase1_step(
        m, Phase1Config(**CFG), tp, _t(parents), _t(batch), _t(eps))
    assert cuda_step.LAUNCHES == {"phase1_step": 0}
    _assert_tree_close(got_params, ref_params, STEP)
    for k in cuda_step.METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref_metrics[k]),
                                   **STEP, err_msg=k)


def _step_by_phases(m, cfg, params, parents, batch, eps):
    """B3's launches, each through its plain phase: the encoder forward,
    ``decoder_readout_plain``, B2's two plain phases on the decoder (parents
    mask, teacher-forced input, h0 = z), ``latent_plain``, B2's phases on
    the encoder, then the update as step.cu's ``step_update`` writes it
    (w m - lr (g + 2 lam_ridge w on the ridge leaves)) m, the prox and the
    metrics.  Returns (new params, metrics)."""
    e, p, b = m.enc_len, m.p, batch.shape[0]
    henc, h_e = gru_scan(params.enc, batch[:, :e], torch.zeros((b, m.hidden)))
    mu, lv = dense(params.fc_mu, h_e), dense(params.fc_std, h_e)
    z = mu + torch.exp(0.5 * lv) * eps
    hdec, douts, sq, g_ro_w, g_ro_b = cuda_step.decoder_readout_plain(
        params, parents, batch, z, e)
    heads = masked_heads(params.heads, parents)
    w = (heads.w_ih, heads.b_ih, heads.w_hh, heads.b_hh)
    x_dec, z_p = decoder_input(batch, e), z.expand(p, b, m.hidden)
    gh, dz = cuda_gru.bwd_chain_plain(*w, x_dec, z_p, hdec, douts)
    _, dwih, dbih, dwhh, dbhh = cuda_gru.bwd_wgrad_plain(*w, x_dec, z_p, hdec,
                                                         gh, False)
    *g_fc, dhe = cuda_step.latent_plain(params, mu, lv, z, h_e, dz.sum(0),
                                        cfg.beta)
    enc = params.enc
    ew = (enc.w_ih[None], enc.b_ih[None], enc.w_hh[None], enc.b_hh[None])
    h0 = torch.zeros((1, b, m.hidden))
    egh, _ = cuda_gru.bwd_chain_plain(*ew, batch[:, :e], h0, henc[None],
                                      cuda_step.encoder_douts(dhe, e)[None])
    _, ewih, ebih, ewhh, ebhh = cuda_gru.bwd_wgrad_plain(
        *ew, batch[:, :e], h0, henc[None], egh, False)
    grads = [ewih[0], ewhh[0], ebih[0], ebhh[0], *g_fc, dwih, dwhh, dbih,
             dbhh, g_ro_w, g_ro_b]
    ridge_leaves = {"hd_whh", "ro_w"}
    new = []
    for name, v, g in zip(cuda_step.LEAVES, tree_leaves(params), grads):
        mask = parents[:, None, :] if name == "hd_wih" else 1.0
        r2 = 2 * cfg.lam_ridge if name in ridge_leaves else 0.0
        new.append((v * mask - cfg.lr * (g + r2 * v)) * mask)
    new = tree_unflatten(params, new)
    w_ih = prox_column_groups(new.heads.w_ih, cfg.lam, cfg.lr)
    recon = sq / (b * (batch.shape[1] - e))
    ridge = cfg.lam_ridge * (params.readout.w.square().sum()
                             + params.heads.w_hh.square().sum())
    reg = cfg.beta * kl_gaussian(mu, lv)
    metrics = {"loss": recon + ridge + reg, "recon": recon, "latent_reg": reg,
               "mean_loss": (recon + ridge) / p,
               "variable_usage": (torch.linalg.vector_norm(w_ih, dim=-2) > 0)
               .float().mean()}
    heads = dataclasses.replace(new.heads, w_ih=w_ih)
    return dataclasses.replace(new, heads=heads), metrics


def _phase_inputs(setup, masked):
    jm, jp, m, tp, batch, parents = setup
    parents = parents if masked else np.ones((P, P), np.float32)
    eps = np.random.default_rng(5).normal(size=(B, H)).astype(np.float32)
    return m, tp, parents, batch, eps


@pytest.mark.parametrize("masked", [False, True])
def test_step_phases_compose_to_the_plain_step(setup, masked):
    """B3's launches, each through its plain phase, reproduce B3's plain
    version (one ``make_phase1_step`` body under autograd)."""
    m, tp, parents, batch, eps = _phase_inputs(setup, masked)
    cfg = Phase1Config(**CFG)
    args = (m, cfg, tp, _t(parents), _t(batch), _t(eps))
    got_params, got = _step_by_phases(*args)
    ref_params, ref = cuda_step.fused_phase1_step_plain(*args)
    for a, r in zip(tree_leaves(got_params), tree_leaves(ref_params)):
        np.testing.assert_allclose(a.numpy(), r.numpy(), **STEP)
    for k in cuda_step.METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), **STEP,
                                   err_msg=k)


@pytest.mark.parametrize("masked", [False, True])
def test_step_phases_compose_to_pallas_interpret(setup, masked):
    """B3's launches, each through its plain phase, against the TPU
    megakernel in Pallas interpret mode."""
    jm, jp = setup[:2]
    m, tp, parents, batch, eps = _phase_inputs(setup, masked)
    ref_params, ref = jax_fused_step(
        jm, JPhase1Config(**CFG), jp, jnp.asarray(parents), jnp.asarray(batch),
        jnp.asarray(eps), interpret=True)
    got_params, got = _step_by_phases(m, Phase1Config(**CFG), tp, _t(parents),
                                      _t(batch), _t(eps))
    _assert_tree_close(got_params, ref_params, STEP)
    for k in cuda_step.METRICS:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), **STEP,
                                   err_msg=k)


@pytest.mark.parametrize("max_iter,check_every,want", [
    (10, 5, [5, 5]), (7, 3, [3, 3, 1]), (2, 5, [2]), (0, 4, [])])
def test_chunk_lengths(max_iter, check_every, want):
    assert _chunk_lengths(max_iter, check_every) == want


def _windows(seed, n=40):
    return torch.tensor(np.random.default_rng(seed).normal(
        size=(n, T, P)).astype(np.float32))


def test_fit_phase1_runs_max_iter_and_keeps_the_best():
    """Exactly max_iter steps in chunks of check_every, and the returned
    params are the pre-update params of the step with the lowest
    mean_loss, replayed here step by step from the same generator."""
    m = CRVAE(P, H, E)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    windows, parents = _windows(2), torch.ones((P, P))
    cfg = Phase1Config(max_iter=7, check_every=3, batch_size=8, lam=0.05,
                       lr=0.3)
    seen = []
    cuda_gru.reset_launches()
    best, state, metrics = fit_phase1(
        m, params, windows, parents, cfg, torch.Generator().manual_seed(3),
        callback=lambda step, st, met: seen.append(step))
    assert seen == [3, 6, 7] and state.step == 7
    assert set(metrics) == set(cuda_step.METRICS)
    assert cuda_gru.LAUNCHES == {"gru_forward": 0, "gru_backward": 0,
                                 "gru_forward_wide": 0,
                                 "gru_backward_wide": 0}

    step = make_phase1_step(m, cfg, windows, parents)
    replay = Phase1State(params=params, prior=None, best_params=params,
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
    assert float(state.best_loss) == lowest[0]
    assert metrics["mean_loss"] == pytest.approx(history[-1][0])


def test_fit_phase1_fixed_batch_draws_once():
    """resample_batches=False: the batch is drawn once before the first
    step, so every step after it draws only epsilon from the generator."""
    m = CRVAE(P, H, E)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    windows, parents = _windows(4), torch.ones((P, P))
    cfg = Phase1Config(max_iter=3, check_every=3, batch_size=8,
                       resample_batches=False)
    g = torch.Generator().manual_seed(6)
    _, state, _ = fit_phase1(m, params, windows, parents, cfg, g)
    ref = torch.Generator().manual_seed(6)
    idx = torch.randint(0, windows.shape[0], (8,), generator=ref)
    fixed = windows[idx]
    replay = Phase1State(params=params, prior=None, best_params=params,
                         best_loss=torch.tensor(float("inf")), generator=ref,
                         step=0)
    step = make_phase1_step(m, cfg, windows, parents, fixed_batch=fixed)
    for _ in range(3):
        replay, _ = step(replay)
    for a, r in zip(tree_leaves(state.params), tree_leaves(replay.params)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_unported_options_raise(tmp_path):
    """A mesh is ported: a world of one rank trains bit for bit the
    unmeshed fit, and an object that is no mesh raises a TypeError where
    the fit starts; a checkpoint directory works: a fit resumed from its
    own finished snapshot is a pure restore."""
    from torch_ranks import world_of_one

    m = CRVAE(P, H, E)
    params = m.init(torch.Generator().manual_seed(1), "cpu")
    args = (m, params, _windows(5), torch.ones((P, P)))
    with pytest.raises(TypeError, match="make_mesh"):
        fit_phase1(*args, Phase1Config(), torch.Generator(), mesh=object())
    cfg = Phase1Config(max_iter=4, check_every=2, batch_size=8)
    meshed = fit_phase1(*args, cfg, torch.Generator().manual_seed(3),
                        mesh=world_of_one())
    plain = fit_phase1(*args, cfg, torch.Generator().manual_seed(3))
    assert meshed[2] == plain[2]
    for a, b in zip(tree_leaves(meshed[0]), tree_leaves(plain[0])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    ckpt = str(tmp_path / "ckpt")
    best, _, metrics = fit_phase1(*args, cfg, torch.Generator().manual_seed(2),
                                  checkpoint_dir=ckpt)
    calls = []
    again, state, restored = fit_phase1(
        *args, cfg, torch.Generator().manual_seed(9), checkpoint_dir=ckpt,
        resume=True, callback=lambda *a: calls.append(a))
    assert calls == [] and state.step == 4 and restored == metrics
    for a, r in zip(tree_leaves(again), tree_leaves(best)):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


def test_conditioned_rollout_matches_jax(setup):
    """Encode the context's last enc_len steps, z from the key's draw, a
    free run from the last observation, with noise and a parents mask."""
    jm, jp, m, tp, batch, parents = setup
    key = jax.random.key(11)
    noise = np.random.default_rng(8).normal(size=(B, 5, P)).astype(np.float32)
    ref = jm.conditioned_rollout(jp, jnp.asarray(batch), key,
                                 noise=jnp.asarray(noise),
                                 parents=jnp.asarray(parents), length=5)
    eps = _t(jax.random.normal(key, (B, H)))
    got = m.conditioned_rollout(tp, _t(batch), eps=eps, noise=_t(noise),
                                parents=_t(parents), length=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD)
