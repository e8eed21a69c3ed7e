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


@pytest.mark.parametrize("p", [40, 128], ids=["scaled", "xl"])
def test_plain_rollouts_match_jax_at_hidden_128(p):
    """K1's and K2's plain versions, the reference the streamed kernels are
    held to on the card, against ``CRVAE._free_run`` and ``ErrorVAE.sample``
    at lorenz96_scaled's (p=40) and lorenz96_xl's (p=128) widths, H=128,
    B=3, T=21.  Tolerance: the module's 1e-5 (the two differ by ~5e-7 on
    outputs of order 1: 21 float32 steps of 168-256-term sums, summed in
    other orders by XLA and PyTorch)."""
    hidden, b, t = 128, 3, 21
    model = JCRVAE(p=p, hidden=hidden, rollout_len=t)
    params = model.init(jax.random.key(5))
    rng = np.random.default_rng(p)
    x0, h0 = rng.normal(size=(b, p)), rng.normal(size=(b, hidden))
    noise = rng.normal(size=(b, t, p))
    ref = model._free_run(params, params.heads, jnp.asarray(x0, jnp.float32),
                          jnp.broadcast_to(jnp.asarray(h0, jnp.float32),
                                           (p, b, hidden)),
                          jnp.asarray(noise, jnp.float32))
    got = cuda_rollout.crvae_free_run_plain(
        _port(gru.GRUParams, params.heads), _port(Dense, params.readout),
        _t(x0), _t(h0), _t(noise), model.noise_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    err = JErrorVAE(d=p, hidden=hidden, rollout_len=t)
    eparams = err.init(jax.random.key(6))
    key = jax.random.key(7)
    ref2 = err.sample(eparams, key, b)                  # (B, T + 1, d)
    eh0 = np.asarray(jax.random.normal(key, (b, hidden)))
    got2 = cuda_rollout.errvae_sample_plain(
        _port(gru.GRUParams, eparams.dec), _port(Dense, eparams.out),
        _t(eh0), p, t)
    np.testing.assert_allclose(got2.numpy(), np.asarray(ref2)[:, 1:], **TOL)


def test_packed_weights_follow_the_tensors():
    """The wrappers' packed weights are reused for the same weight tensors,
    packed again after an in-place write and dropped when a tensor is
    freed; inference tensors, which keep no version counter, are packed at
    every call."""
    g = torch.Generator().manual_seed(1)
    w_ih, w_hh = torch.randn((2, 24, 5), generator=g), torch.randn(
        (2, 24, 8), generator=g)
    key = (id(w_ih), id(w_hh))
    first = cuda_rollout._packed_weights(w_ih, w_hh)
    assert cuda_rollout._packed_weights(w_ih, w_hh) is first
    with torch.no_grad():
        w_ih.mul_(2.0)
    again = cuda_rollout._packed_weights(w_ih, w_hh)
    assert again is not first
    assert torch.equal(again, cuda_rollout.pack_streamed(w_ih, w_hh))
    assert key in cuda_rollout._PACKED
    del w_ih
    assert key not in cuda_rollout._PACKED
    with torch.inference_mode():
        a, b = w_hh.clone(), w_hh.clone()
    assert cuda_rollout._packed_weights(a, b) is not \
        cuda_rollout._packed_weights(a, b)


@pytest.mark.parametrize("batch,heads,d,hidden,outs,budget,want", [
    (3072, 40, 40, 128, 1, 232448, 32),   # lorenz96_scaled: 3840 blocks
    (512, 40, 40, 128, 1, 232448, 32),    # 640 blocks of the widest tile
    (37, 40, 40, 128, 1, 232448, 8),      # 16 rows would leave SMs idle
    (1, 40, 40, 128, 1, 232448, 4),       # one block a head at any tile
    (3072, 128, 128, 128, 1, 232448, 32),  # lorenz96_xl
    (3072, 1, 40, 128, 40, 232448, 16),   # K2: one head, 192 blocks
    (264, 1, 40, 128, 40, 232448, 4),     # K2: 66 blocks at best
    (3072, 40, 40, 128, 1, 60000, 8),     # a 60 KB budget: narrower tiles
])
def test_stream_tile(batch, heads, d, hidden, outs, budget, want):
    m = cuda_rollout.stream_tile(batch, heads, d, hidden, outs, budget,
                                 n_sm=132)
    assert m == want
    assert cuda_rollout.stream_smem_bytes(m, d, hidden, outs) <= budget
    assert (cuda_rollout.stream_threads(m, hidden)
            <= cuda_rollout.stream_max_threads(m))


def test_stream_tile_raises_when_the_smallest_tile_does_not_fit():
    need = cuda_rollout.stream_smem_bytes(4, 128, 1024, 1)
    with pytest.raises(ValueError, match=f"{need} bytes of shared memory"):
        cuda_rollout.stream_tile(8, 128, 128, 1024, 1, 232448, n_sm=132)


@pytest.mark.parametrize("p,d,hidden", [
    (3, 5, 36),        # pad rows to a whole chunk, pad units to 64
    (2, 40, 128),      # lorenz96_scaled's widths: nothing padded
    (None, 40, 128),   # K2: one head's (3H, D), (3H, H)
])
def test_pack_streamed_layout(p, d, hidden):
    """The streamed kernels' packed weights: row k of head i holds gate g
    of unit j at [i, k, g, j]: W_ih's columns, zero rows to a whole chunk,
    W_hh's columns, zero rows past H; units past 32-rounded H zero; bf16
    widened exactly to float32."""
    g = torch.Generator().manual_seed(0)
    heads = 1 if p is None else p
    w_ih = torch.randn((heads, 3 * hidden, d), generator=g)
    w_hh = torch.randn((heads, 3 * hidden, hidden), generator=g)
    dp, hp = cuda_rollout.stream_dims(d, hidden)
    assert (dp, hp) == (-(-d // 8) * 8, -(-hidden // 32) * 32)
    for dtype in (torch.float32, torch.bfloat16):
        a, b = w_ih.to(dtype), w_hh.to(dtype)
        got = (cuda_rollout.pack_streamed(a[0], b[0]) if p is None
               else cuda_rollout.pack_streamed(a, b))
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert got.shape == (heads, dp + hp, 3, hp)
        want = torch.zeros((heads, dp + hp, 3, hp))
        for gate in range(3):
            rows = slice(gate * hidden, (gate + 1) * hidden)
            want[:, :d, gate, :hidden] = a[:, rows].float().transpose(1, 2)
            want[:, dp:dp + hidden, gate, :hidden] = \
                b[:, rows].float().transpose(1, 2)
        assert torch.equal(got, want)


H100 = (232448, 233472, 132, 2048, 8, 16)


@pytest.mark.parametrize("kind,heads,d,hidden,want", [
    # (plan at B = 1, 37, 3072) as the float32 kernels took them before
    # the bf16 resident body changed its sizing.
    ("crvae", 20, 20, 64, [("resident", 7, 3, 4, 4, 512, 217440, 0, 0)] * 2
     + [("resident", 7, 3, 8, 2, 512, 224416, 0, 0)]),
    ("errvae", 1, 20, 64, [("resident", 1, 1, 4, 4, 512, 77888, 0, 0)] * 2
     + [("resident", 1, 1, 24, 2, 512, 91488, 0, 0)]),
    ("errvae", 1, 40, 128, [("streamed", 1, 1, 4, 0, 512, 125408, 1, 3328),
                            ("streamed", 1, 1, 4, 0, 512, 125408, 10, 33280),
                            ("streamed", 1, 1, 16, 0, 128, 84320, 192,
                             2555904)]),
    ("crvae", 2, 2, 64, [("resident", 2, 1, 4, 4, 512, 57376, 0, 0)] * 2
     + [("resident", 2, 1, 32, 2, 512, 72608, 0, 0)]),
    ("crvae", 6, 6, 7, [("resident", 6, 1, 4, 4, 512, 3072, 0, 0)] * 2
     + [("resident", 6, 1, 32, 4, 512, 6656, 0, 0)]),
    ("errvae", 1, 6, 7, [("resident", 1, 1, 4, 4, 512, 3232, 0, 0)] * 2
     + [("resident", 1, 1, 24, 4, 512, 5632, 0, 0)]),
])
def test_float32_plans_unchanged(kind, heads, d, hidden, want):
    """The float32 route, tile, split and shared memory stay as they were
    at the main and edge shapes."""
    got = [tuple(cuda_rollout.rollout_route(kind, heads, b, d, hidden, H100))
           for b in (1, 37, 3072)]
    assert got == want


def test_kernel_inputs_are_validated():
    """Before a launch, every input must be float32 of the shape the kernel
    reads it by (checked here on the CPU, where no launch follows)."""
    cpu = torch.device("cpu")
    cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3), (2, 3)))
    with pytest.raises(ValueError, match="expected \\(2, 4\\)"):
        cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3), (2, 4)))
    with pytest.raises(ValueError, match="float32"):
        cuda_rollout._check(cpu, "k", w=(torch.zeros(2, 3).double(), (2, 3)))
