"""The port's recurrence primitives and rollout kernels against the JAX package.

The same numpy-seeded inputs go through the JAX function and its port, on
the CPU.  There the rollout wrappers run their plain PyTorch versions (a
CPU tensor never reaches the CUDA kernels); the kernels themselves are held
against those plain versions on the card by
``test_torch_port_device.py::test_kernels_match_plain_on_card`` and by
``chip_smoke.py``.

Tolerance: ``rtol=atol=1e-5`` throughout — float32 recurrences of at most 6
steps whose products are summed in another order by XLA and by PyTorch.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.ops import cuda_rollout, gru
from vae_connexe_torch.utils.layers import Dense
from vae_connexe_tpu.models import CRVAE as JCRVAE
from vae_connexe_tpu.models import ErrorVAE as JErrorVAE
from vae_connexe_tpu.ops import gru as jgru
from vae_connexe_tpu.ops.pallas_rollout import crvae_free_run_fused
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
P, H, B, T = 4, 8, 16, 6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _port(cls, jax_params):
    """JAX parameter pytree -> the port's dataclass ``cls`` on the CPU."""
    return convert.from_numpy(cls, flax.serialization.to_state_dict(jax_params),
                              "cpu")


@pytest.fixture(scope="module")
def crvae():
    model = JCRVAE(p=P, hidden=H, rollout_len=T)
    return model, model.init(jax.random.key(0))


def test_gru_cell_matches_jax():
    params = jgru.init_gru(jax.random.key(1), P, H)
    rng = np.random.default_rng(0)
    x, h = rng.normal(size=(B, P)), rng.normal(size=(B, H))
    ref = jgru.gru_cell(params, jnp.asarray(x, jnp.float32),
                        jnp.asarray(h, jnp.float32))
    got = gru.gru_cell(_port(gru.GRUParams, params), _t(x), _t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_gru_step_heads_matches_jax(per_head):
    params = jgru.init_stacked_gru(jax.random.key(2), P, P, H)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(P, B, P) if per_head else (B, P))
    h = rng.normal(size=(P, B, H))
    ref = jgru.gru_step_heads(params, jnp.asarray(x, jnp.float32),
                              jnp.asarray(h, jnp.float32))
    got = gru.gru_step_heads(_port(gru.GRUParams, params), _t(x), _t(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_init_is_torch_default_uniform():
    g = torch.Generator().manual_seed(0)
    params = gru.init_stacked_gru(g, 3, 5, 16, device="cpu")
    assert params.w_ih.shape == (3, 48, 5) and params.w_hh.shape == (3, 48, 16)
    for leaf in (params.w_ih, params.w_hh, params.b_ih, params.b_hh):
        assert leaf.abs().max() <= 0.25 and leaf.abs().max() > 0.2


def _crvae_inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, P)), rng.normal(size=(B, H)),
            rng.normal(size=(B, T, P)))


def test_crvae_plain_matches_free_run(crvae):
    """K1's plain version against ``CRVAE._free_run`` (nonzero x0, the h0
    broadcast to every head)."""
    model, params = crvae
    x0, h0, noise = _crvae_inputs(2)
    ref = model._free_run(params, params.heads, jnp.asarray(x0, jnp.float32),
                          jnp.broadcast_to(jnp.asarray(h0, jnp.float32),
                                           (P, B, H)),
                          jnp.asarray(noise, jnp.float32))
    got = cuda_rollout.crvae_free_run_fused(
        _port(gru.GRUParams, params.heads), _port(Dense, params.readout),
        _t(x0), _t(h0), _t(noise), model.noise_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_crvae_plain_matches_pallas_interpret(crvae):
    """K1's plain version against the TPU kernel it replaces, run in Pallas
    interpret mode."""
    model, params = crvae
    x0, h0, noise = _crvae_inputs(3)
    ref = crvae_free_run_fused(params.heads, params.readout,
                               jnp.asarray(x0, jnp.float32),
                               jnp.asarray(h0, jnp.float32),
                               jnp.asarray(noise, jnp.float32),
                               model.noise_scale, interpret=True)
    got = cuda_rollout.crvae_free_run_plain(
        _port(gru.GRUParams, params.heads), _port(Dense, params.readout),
        _t(x0), _t(h0), _t(noise), model.noise_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_errvae_plain_matches_sample():
    """K2's plain version against ``ErrorVAE.sample`` from the same h0."""
    model = JErrorVAE(d=P, hidden=H, rollout_len=T)
    params = model.init(jax.random.key(3))
    key = jax.random.key(4)
    ref = model.sample(params, key, B)                 # (B, T + 1, P)
    h0 = np.asarray(jax.random.normal(key, (B, H)))    # sample's own draw
    got = cuda_rollout.errvae_sample_fused(
        _port(gru.GRUParams, params.dec), _port(Dense, params.out), _t(h0),
        P, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 1:], **TOL)
    np.testing.assert_array_equal(np.asarray(ref)[:, 0], 0.0)


def test_cpu_tensors_never_launch(crvae):
    model, params = crvae
    x0, h0, noise = _crvae_inputs(4)
    cuda_rollout.reset_launches()
    heads, readout = _port(gru.GRUParams, params.heads), _port(Dense,
                                                               params.readout)
    cuda_rollout.crvae_free_run_fused(heads, readout, _t(x0), _t(h0),
                                      _t(noise), 0.1)
    # The bf16 instantiation's plain version runs on the CPU too.
    bf = torch.bfloat16
    cuda_rollout.crvae_free_run_fused(
        cuda_rollout.cast_weights(heads, bf),
        cuda_rollout.cast_weights(readout, bf), _t(x0), _t(h0), _t(noise),
        0.1)
    assert cuda_rollout.LAUNCHES == {"crvae_free_run": 0, "errvae_sample": 0,
                                     "crvae_free_run_bf16": 0,
                                     "errvae_sample_bf16": 0}


@pytest.mark.parametrize("batch,heads,hidden,budget,want", [
    (3072, 20, 64, 232448, 8),     # serving width: 384 blocks of 82,560 bytes
    (1024, 20, 64, 232448, 4),     # 8 rows a block would leave SMs idle
    (264, 20, 64, 232448, 2),      # exactly one block per SM
    (37, 20, 64, 232448, 1),       # fewer rows than SMs: one row a block
    (1, 20, 64, 232448, 1),
    (3072, 20, 64, 49152, 4),      # a 48 KB budget forces narrow tiles
])
def test_pick_bt(batch, heads, hidden, budget, want):
    bt = cuda_rollout.pick_bt(batch, heads, hidden, heads, budget, n_sm=132)
    assert bt == want
    assert cuda_rollout.tile_smem_bytes(bt, heads, hidden, heads) <= budget


def test_pick_bt_raises_when_one_row_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_rollout.pick_bt(8, 128, 256, 128, 232448, n_sm=132)


def test_kernel_inputs_are_validated():
    """Before a launch, every input must be float32 of the shape the kernel
    reads it by (checked here on the CPU, where no launch follows)."""
    cpu = torch.device("cpu")
    cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3), (2, 3)))
    with pytest.raises(ValueError, match="expected \\(2, 4\\)"):
        cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3), (2, 4)))
    with pytest.raises(ValueError, match="float32"):
        cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3).double(), (2, 3)))
