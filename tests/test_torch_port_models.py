"""The port's models, compensated generation and converters against JAX.

Weights made by the JAX package cross over through ``convert`` (nested dicts
of numpy arrays keyed by the reference's field names).  Random draws cannot
line up between threefry keys and torch generators, so the JAX draws are
computed from the JAX key and handed to the port as tensors, exactly as
``generate_with_compensation`` splits it (``k_e, k_r = split(key)``).

Tolerance: ``rtol=atol=1e-5`` — float32 recurrences of at most 6 steps whose
products are summed in another order by XLA and by PyTorch.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.models import (
    CRVAE,
    CRVAEParams,
    ErrorVAE,
    ErrorVAEParams,
    WInCRVAE,
    masked_heads,
)
from vae_connexe_torch.serving import export_generator, export_win_generator
from vae_connexe_torch.train import generate_from_draws, generate_with_compensation
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.train import generate_with_compensation as jax_generate
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
P, H, HE, B, T = 4, 8, 6, 8, 6


@pytest.fixture(scope="module")
def pair():
    """A JAX (CRVAE, ErrorVAE) pair, its parents mask, and the port's copy."""
    jm, je = JCRVAE(p=P, hidden=H, rollout_len=T), JErrorVAE(d=P, hidden=HE)
    jp, jep = jm.init(jax.random.key(0)), je.init(jax.random.key(1))
    parents = (np.random.default_rng(9).random((P, P)) > 0.3).astype(np.float32)
    m, e = CRVAE(p=P, hidden=H, rollout_len=T), ErrorVAE(d=P, hidden=HE)
    tp = convert.from_numpy(CRVAEParams, flax.serialization.to_state_dict(jp),
                            "cpu")
    tep = convert.from_numpy(ErrorVAEParams,
                             flax.serialization.to_state_dict(jep), "cpu")
    return (jm, je, jp, jep), (m, e, tp, tep), parents


def test_rollout_with_parents_matches_jax(pair):
    (jm, _, jp, _), (m, _, tp, _), parents = pair
    key = jax.random.key(5)
    noise = np.random.default_rng(6).normal(size=(B, T, P)).astype(np.float32)
    ref = jm.rollout(jp, key, B, noise=jnp.asarray(noise),
                     parents=jnp.asarray(parents))
    h0 = torch.tensor(np.asarray(jax.random.normal(key, (B, H))))
    got = m.rollout(tp, None, B, noise=torch.tensor(noise),
                    parents=torch.tensor(parents), h0=h0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_error_vae_sample_matches_jax(pair):
    (_, je, _, jep), (_, e, _, tep), _ = pair
    key = jax.random.key(7)
    ref = je.sample(jep, key, B, T)
    h0 = torch.tensor(np.asarray(jax.random.normal(key, (B, HE))))
    got = e.sample(tep, None, B, T, h0=h0)
    assert got.shape == (B, T + 1, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_generate_with_compensation_matches_jax(pair):
    """End to end: the port's compensated generation equals the reference's
    (lax path) on the same weights and the same draws."""
    (jm, je, jp, jep), (m, e, tp, tep), parents = pair
    key = jax.random.key(2)
    ref = jax_generate(jm, je, jp, jep, key, B, parents=jnp.asarray(parents))
    k_e, k_r = jax.random.split(key)
    h0_err = torch.tensor(np.asarray(jax.random.normal(k_e, (B, HE))))
    h0 = torch.tensor(np.asarray(jax.random.normal(k_r, (B, H))))
    heads = masked_heads(tp.heads, torch.tensor(parents))
    got = generate_from_draws(m, e, heads, tp.readout, tep.dec, tep.out,
                              h0_err, h0)
    assert got.shape == (B, T, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_generate_with_compensation_draw_order(pair):
    """ErrorVAE h0 first, rollout h0 second, from the one generator."""
    _, (m, e, tp, tep), parents = pair
    par = torch.tensor(parents)
    got = generate_with_compensation(m, e, tp, tep,
                                     torch.Generator().manual_seed(3), B,
                                     parents=par, kernel="auto")
    g = torch.Generator().manual_seed(3)
    h0_err, h0 = torch.randn((B, HE), generator=g), torch.randn((B, H), generator=g)
    want = generate_from_draws(m, e, masked_heads(tp.heads, par), tp.readout,
                               tep.dec, tep.out, h0_err, h0)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="kernel"):
        generate_with_compensation(m, e, tp, tep, g, B, kernel="pallas")


def test_gc_matches_jax(pair):
    (jm, _, jp, _), (m, _, tp, _), parents = pair
    np.testing.assert_allclose(
        m.gc(tp, torch.tensor(parents), threshold=False).numpy(),
        np.asarray(jm.gc(jp, jnp.asarray(parents), threshold=False)), **TOL)
    np.testing.assert_array_equal(
        m.gc(tp, torch.tensor(parents)).numpy(),
        np.asarray(jm.gc(jp, jnp.asarray(parents))))


@pytest.mark.parametrize("cls,seed_model", [
    (CRVAEParams, lambda g: CRVAE(p=3, hidden=5).init(g, "cpu")),
    (ErrorVAEParams, lambda g: ErrorVAE(d=3, hidden=5, latent=2).init(g, "cpu")),
], ids=["crvae", "error_vae"])
def test_convert_round_trip(cls, seed_model):
    params = seed_model(torch.Generator().manual_seed(0))
    tree = convert.to_numpy(params)
    back = convert.from_numpy(cls, tree, "cpu")
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(convert.to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    tree.pop(next(iter(tree)))
    with pytest.raises(KeyError, match="expects keys"):
        convert.from_numpy(cls, tree, "cpu")


def test_same_seed_same_weights():
    a = CRVAE(p=3, hidden=5).init(torch.Generator().manual_seed(4), "cpu")
    b = CRVAE(p=3, hidden=5).init(torch.Generator().manual_seed(4), "cpu")
    torch.testing.assert_close(a.heads.w_ih, b.heads.w_ih, rtol=0, atol=0)


def test_reduced_precision_and_win_family_not_ported(pair):
    """bf16 serving is ported (``tests/test_torch_port_bf16.py`` holds it
    to JAX's): every entry point takes JAX's bfloat16 and returns
    float32, and a dtype that is neither float32 nor bfloat16 raises."""
    _, (m, e, tp, tep), _ = pair
    g = torch.Generator().manual_seed(0)
    for out in (generate_with_compensation(m, e, tp, tep, g, B,
                                           dtype=torch.bfloat16),
                m.rollout(tp, g, B, dtype="bfloat16")):
        assert out.dtype == torch.float32 and out.shape == (B, m.rollout_len, P)
    with pytest.raises(ValueError, match="bfloat16"):
        m.rollout(tp, g, B, dtype=torch.float16)
    assert export_generator(m, e, tp, tep, batch=B, serve_dtype="bfloat16")
    win = WInCRVAE(d=P, hidden=4, latent=4, tau=3)
    assert export_win_generator(win, win.init(g, "cpu"), batch=B, length=T,
                                serve_dtype="bfloat16")
    with pytest.raises(ValueError, match="serve_dtype"):
        export_generator(m, e, tp, tep, batch=B, serve_dtype="float16")


def test_convert_round_trips_reference_weights(pair):
    """Reference weights -> port -> nested dict: every leaf unchanged."""
    (_, _, jp, jep), (_, _, tp, tep), _ = pair
    for jax_params, port in ((jp, tp), (jep, tep)):
        want = flax.serialization.to_state_dict(jax_params)
        got = convert.to_numpy(port)
        assert jax.tree.structure(got) == jax.tree.structure(
            jax.tree.map(np.asarray, want))
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
            np.testing.assert_array_equal(np.asarray(a), b)
