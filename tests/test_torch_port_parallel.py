"""The port's meshes against the JAX package's (``parallel/mesh.py``,
``parallel/sharded.py``, ``parallel/serve.py``, the seed axes of
``parallel/seed_sweep.py`` and ``WInTrainer.fit_many``, and the meshed
fits).

The port runs one process a device: its ranks here are four gloo CPU
processes on loopback (``tests/torch_ranks.py``), one group running every
case of this module (``tests/torch_mesh_cases.py::parallel_cases``).  The
JAX reference runs in this process on ``tests/conftest.py``'s eight
virtual CPU devices.  Held against JAX on the same inputs (epsilon from
JAX's key): one ``make_sharded_phase1_step`` and one
``make_sharded_phase2_step`` on a (2, 2) mesh, KL and cs, at the JAX
package's tolerances (``tests/test_sharded_phase2.py``, rtol 2e-5 / atol
1e-6).  Held against the port's single-process results: meshed fits at
(2, 2) and (4, 1), a killed and resumed meshed fit, phase 2, a streamed
meshed fit, the seed axes over dp and sharded serving in float32 and bf16
(``tests/test_meshed_fit.py``'s tolerances, and the serving test's atol
1e-5).

A CPU rank group checks the mesh logic and the collectives over gloo; a
group of NCCL ranks across several cards cannot be checked on a machine
with one card, and is not checked here.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_connexe_torch.data import arrange_input, sliding_windows
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.models.gmm_prior import init_gmm_prior
from vae_connexe_tpu.parallel import make_mesh as jmake_mesh
from vae_connexe_tpu.parallel.sharded import (
    make_sharded_phase1_step as jstep1,
    make_sharded_phase2_step as jstep2,
)
from vae_connexe_tpu.train import Phase1Config as JPhase1Config
from vae_connexe_tpu.train import Phase2Config as JPhase2Config
from torch_ranks import run_ranks

TOL = dict(rtol=2e-5, atol=1e-6)
CFG = dict(p=4, hidden=16, enc_len=5, err_hidden=16, batch=32, lam=0.1,
           lr=5e-2, lam_ridge=1e-2, lambda_cs=0.1, k=5, ctx=10)


def _tensors(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.fixture(scope="module")
def jax_inputs():
    c = CFG
    jm = JCRVAE(p=c["p"], hidden=c["hidden"], enc_len=c["enc_len"])
    jerr = JErrorVAE(d=c["p"], hidden=c["err_hidden"])
    jp, jep = jm.init(jax.random.key(0)), jerr.init(jax.random.key(1))
    prior = init_gmm_prior(jax.random.key(4), c["k"], c["hidden"])
    batch = jax.random.normal(jax.random.key(2), (c["batch"], c["ctx"],
                                                  c["p"]))
    key = jax.random.key(3)
    k_z, k_e = jax.random.split(key)
    series = np.cumsum(np.random.default_rng(5).standard_normal(
        (200, c["p"])), axis=0).astype(np.float32) * 0.1
    t_series = torch.from_numpy(series)
    return dict(jm=jm, jerr=jerr, jp=jp, jep=jep, prior=prior, batch=batch,
                key=key, k_z=k_z, k_e=k_e, torch={
                    "cfg": c,
                    "params": _tensors(flax.serialization.to_state_dict(jp)),
                    "err_params": _tensors(
                        flax.serialization.to_state_dict(jep)),
                    "prior": _tensors(flax.serialization.to_state_dict(
                        prior)),
                    "batch": torch.tensor(np.asarray(batch)),
                    "eps": torch.tensor(np.asarray(jax.random.normal(
                        key, (c["batch"], c["hidden"])))),
                    "eps2": torch.tensor(np.asarray(jax.random.normal(
                        k_z, (c["batch"], c["hidden"])))),
                    "eps_err": torch.tensor(np.asarray(jax.random.normal(
                        k_e, (c["batch"], jerr.latent)))),
                    "series": t_series,
                    "windows": arrange_input(t_series, c["ctx"])[0],
                    "win_windows": sliding_windows(t_series, 6)})


@pytest.fixture(scope="module")
def ranks(jax_inputs, tmp_path_factory):
    """One group of four gloo CPU ranks runs every case of this module."""
    out = tmp_path_factory.mktemp("parallel_ranks")
    torch.save(jax_inputs["torch"], out / "inputs.pt")
    run_ranks("torch_mesh_cases:parallel_cases", out, world=4, timeout=180)
    return torch.load(out / "results.pt", weights_only=False)


def _close(got, want, tol=TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def _jax_cfg(cls, reg):
    c = CFG
    extra = ({} if reg == "kl" else
             dict(latent_reg="cs", lambda_cs=c["lambda_cs"],
                  gmm_components=c["k"]))
    return cls(lr=c["lr"], batch_size=c["batch"], lam_ridge=c["lam_ridge"],
               **({"lam": c["lam"]} if cls is JPhase1Config else {}),
               **extra)


@pytest.mark.parametrize("reg", ["kl", "cs"])
def test_sharded_phase1_step_matches_jax(ranks, jax_inputs, eight_devices,
                                         reg):
    """One sharded phase-1 step on a (2, 2) mesh, the port's ranks against
    JAX's jitted step on the same params, batch and epsilon."""
    j = jax_inputs
    mesh = jmake_mesh(n_dp=2, n_ep=2, devices=eight_devices[:4])
    parents = jnp.ones((CFG["p"], CFG["p"]), jnp.float32)
    step, pshard, bshard = jstep1(j["jm"], _jax_cfg(JPhase1Config, reg),
                                  mesh, parents)
    params = jax.device_put(j["jp"], pshard)
    batch = jax.device_put(j["batch"], bshard)
    if reg == "kl":
        new, met = step(params, batch, j["key"])
        new_prior = None
    else:
        new, new_prior, met = step(params, j["prior"], batch, j["key"])
    got_params, got_prior, got_met = ranks[f"step1_{reg}"]
    _close(got_params, jax.tree.leaves(new))
    _close(got_prior, jax.tree.leaves(new_prior))
    for k in ("loss", "recon", "latent_reg", "mean_loss"):
        np.testing.assert_allclose(got_met[k], float(met[k]), rtol=1e-5)


@pytest.mark.parametrize("reg", ["kl", "cs"])
def test_sharded_phase2_step_matches_jax(ranks, jax_inputs, eight_devices,
                                         reg):
    """One sharded phase-2 step on a (2, 2) mesh (the residual columns
    gathered over ep, Adam on the replicated ErrorVAE) against JAX's."""
    j = jax_inputs
    mesh = jmake_mesh(n_dp=2, n_ep=2, devices=eight_devices[:4])
    parents = jnp.ones((CFG["p"], CFG["p"]), jnp.float32)
    cfg = _jax_cfg(JPhase2Config, reg)
    err_opt = optax.adam(cfg.lr_error)
    step, pshard, bshard = jstep2(j["jm"], j["jerr"], cfg, mesh, parents,
                                  err_opt)
    params = jax.device_put(j["jp"], pshard)
    batch = jax.device_put(j["batch"], bshard)
    opt = err_opt.init(j["jep"])
    if reg == "kl":
        new, new_err, _, met = step(params, j["jep"], opt, batch, j["key"])
        new_prior = None
    else:
        new, new_prior, new_err, _, met = step(params, j["prior"], j["jep"],
                                               opt, batch, j["key"])
    got_params, got_err, got_prior, got_met = ranks[f"step2_{reg}"]
    _close(got_params, jax.tree.leaves(new))
    _close(got_err, jax.tree.leaves(new_err))
    _close(got_prior, jax.tree.leaves(new_prior))
    for k in ("mean_loss", "loss_e"):
        np.testing.assert_allclose(got_met[k], float(met[k]), rtol=1e-5)


@pytest.mark.parametrize("mesh", ["22", "41"])
def test_meshed_fit_phase1_equals_single_process(ranks, mesh):
    """fit_phase1 over (dp, ep) = (2, 2) and (4, 1) against the
    single-process fit on the same windows and generator; the metrics are
    global, the same on every rank."""
    want, want_met = ranks["fit1_single"]
    got, met, steps = ranks[f"fit1_{mesh}"]
    assert steps == 12
    _close(got, want)
    np.testing.assert_allclose(met["loss"], want_met["loss"], rtol=1e-4)
    assert all(m == met for m in ranks[f"fit1_{mesh}_every_rank"])


def test_meshed_fit_killed_and_resumed(ranks):
    """A (2, 2) fit killed after its step-8 snapshot (written by rank 0 from
    the gathered state) and resumed on every rank from a generator seeded
    otherwise equals the uninterrupted meshed fit bit for bit."""
    got, met, steps = ranks["fit1_resumed"]
    want, want_met, _ = ranks["fit1_22"]
    assert steps == 12 and met == want_met
    _close(got, want, dict(rtol=0, atol=0))


def test_meshed_fit_phase2_and_streamed_fit(ranks):
    """fit_phase2 at (2, 2) against the single-process fit; streamed (2, 2)
    fits of both phases, each rank gathering its dp slice of each batch
    through the native loader, bit for bit the in-memory (2, 2) fits."""
    (gp, ge, gm), (wp, we, wm) = ranks["fit2"]
    _close(gp + ge, wp + we)
    np.testing.assert_allclose(gm["mean_loss"], wm["mean_loss"], rtol=1e-4)
    for phase in ("stream1", "stream2"):
        (sp, sm), (mp, mm) = ranks[phase]
        _close(sp, mp, dict(rtol=0, atol=0))
        assert sm == mm


def test_seed_axes_over_dp(ranks):
    """The sweep's 3 seeds (padded to 4) and fit_many's 4 seeds split over
    dp = 4, gathered, against the unmeshed calls."""
    got, want = ranks["sweep"]
    assert got.keys() == want.keys() and got["gc_scores"].shape[0] == 3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL)
    (gp, gm), (wp, wm) = ranks["fit_many"]
    _close(gp, wp)
    for k in wm:
        np.testing.assert_allclose(gm[k], wm[k], rtol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_sharded_serving(ranks, dtype):
    """make_sharded_generator on four ranks, float32 and bf16, against
    generate_with_compensation on the same generator; a batch the ranks
    do not divide raises with JAX's message."""
    got, want = ranks[f"serve_{dtype}"]
    assert got.shape == want.shape == (8, 21, CFG["p"])
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert "not divisible by the 4-device mesh" in ranks["serve_indivisible"]
