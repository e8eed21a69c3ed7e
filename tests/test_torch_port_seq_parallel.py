"""The port's sequence-parallel recurrence against the JAX package's
(``parallel/seq_parallel.py``, ``ops/dispatch.py``'s sp routing and the
sp fits).

The port's ranks are four gloo CPU processes (``tests/torch_ranks.py``),
one group for every case of this module
(``tests/torch_mesh_cases.py::seq_cases``); the JAX reference runs here on
``tests/conftest.py``'s virtual CPU devices.  ``seq_sharded_gru_heads``'s
outputs and gradients (params, x, h0) at sp = 4 and at sp = 2 on a
(2, 1, 2) mesh, with the batch whole and split over dp
(``batch_axis="dp"``), are held against JAX's ``seq_sharded_gru_heads``
on the same inputs at the JAX tests' tolerances
(``tests/test_seq_parallel.py``: outputs rtol/atol 1e-6, gradients rtol
1e-5, atol 1e-6).  The sp fits (both phases, the decoder through the
pipeline, the batch over dp) are held against the port's single-process
fits (``tests/test_meshed_fit.py``'s tolerances).

The point-to-point sends run over gloo on the CPU here; on the card two
ranks share it over gloo with the sends staged through the host, and NCCL
between cards cannot be checked with one card.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch.data import arrange_input
from vae_connexe_torch.ops import dispatch
from vae_connexe_tpu.ops.gru import GRUParams as JGRUParams
from vae_connexe_tpu.parallel import make_mesh as jmake_mesh
from vae_connexe_tpu.parallel.seq_parallel import (
    seq_sharded_gru,
    seq_sharded_gru_heads,
)
from torch_ranks import run_ranks, world_of_one

P, B, T, D, H = 3, 8, 8, 4, 8
FWD = dict(rtol=1e-6, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-6)
FIT = dict(rtol=2e-5, atol=1e-6)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    k = 1 / np.sqrt(H)

    def u(*shape):
        return rng.uniform(-k, k, shape).astype(np.float32)

    heads = {"w_ih": u(P, 3 * H, D), "w_hh": u(P, 3 * H, H),
             "b_ih": u(P, 3 * H), "b_hh": u(P, 3 * H)}
    arrays = dict(x=rng.standard_normal((B, T, D)).astype(np.float32),
                  h0=rng.standard_normal((P, B, H)).astype(np.float32) * .5,
                  w_out=rng.standard_normal((P, B, T, H)).astype(np.float32),
                  w_h=rng.standard_normal((P, B, H)).astype(np.float32))
    series = np.cumsum(rng.standard_normal((120, 4)), axis=0).astype(
        np.float32) * 0.1
    return heads, arrays, series


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    heads, arrays, series = inputs
    out = tmp_path_factory.mktemp("seq_ranks")
    torch.save({"heads": {k: torch.from_numpy(v) for k, v in heads.items()},
                **{k: torch.from_numpy(v) for k, v in arrays.items()},
                "windows": arrange_input(torch.from_numpy(series), 12)[0]},
               out / "inputs.pt")
    run_ranks("torch_mesh_cases:seq_cases", out, world=4, timeout=120)
    return torch.load(out / "results.pt", weights_only=False)


def _jax_ref(inputs, mesh, batch_axis):
    heads, a, _ = inputs
    params = JGRUParams(**{k: jnp.asarray(v) for k, v in heads.items()})

    def loss(params, x, h0):
        outs, h_t = seq_sharded_gru_heads(params, x, h0, mesh,
                                          batch_axis=batch_axis)
        return (jnp.sum(outs * a["w_out"]) + jnp.sum(h_t * a["w_h"]),
                (outs, h_t))

    (_, (outs, h_t)), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(a["x"]), jnp.asarray(a["h0"]))
    g_params = [grads[0].w_ih, grads[0].w_hh, grads[0].b_ih, grads[0].b_hh]
    return (np.asarray(outs), np.asarray(h_t),
            [np.asarray(g) for g in g_params + [grads[1], grads[2]]])


@pytest.mark.parametrize("n_sp,batch_axis", [(4, None), (2, None),
                                             (2, "dp")])
def test_seq_sharded_gru_heads_matches_jax(ranks, inputs, eight_devices,
                                           n_sp, batch_axis):
    """Outputs and gradients of every rank against JAX's pipeline on a mesh
    of the same shape.  Without ``batch_axis`` every rank holds the whole
    result; with it, rank r holds dp slice r // 2 of the batch, and its
    parameter gradients summed over dp are JAX's."""
    n_dp = 4 // n_sp
    mesh = jmake_mesh(n_dp=n_dp, n_ep=1, n_sp=n_sp,
                      devices=eight_devices[:4])
    outs, h_t, grads = _jax_ref(inputs, mesh, batch_axis)
    per_rank = ranks[f"sp{n_sp}_{batch_axis}"]
    for r, (o, h, g) in enumerate(per_rank):
        rows = slice(None)
        if batch_axis is not None:
            d, b = r // n_sp, B // n_dp
            rows = slice(d * b, (d + 1) * b)
        np.testing.assert_allclose(o, outs[:, rows], **FWD)
        np.testing.assert_allclose(h, h_t[:, rows], **FWD)
        np.testing.assert_allclose(g[4], grads[4][rows], **GRAD)
        np.testing.assert_allclose(g[5], grads[5][:, rows], **GRAD)
        if batch_axis is None:
            for a, w in zip(g[:4], grads[:4]):
                np.testing.assert_allclose(a, w, **GRAD)
    if batch_axis is not None:
        for i in range(4):
            total = per_rank[0][2][i] + per_rank[n_sp][2][i]
            np.testing.assert_allclose(total, grads[i], **GRAD)


def test_seq_sharded_gru_single(ranks, inputs, eight_devices):
    """One unstacked GRU through the pipeline as a one-head stack."""
    heads, a, _ = inputs
    mesh = jmake_mesh(n_dp=1, n_ep=1, n_sp=4, devices=eight_devices[:4])
    params = JGRUParams(**{k: jnp.asarray(v[0]) for k, v in heads.items()})
    outs, h_t = jax.jit(lambda p, x, h: seq_sharded_gru(p, x, h, mesh))(
        params, jnp.asarray(a["x"]), jnp.asarray(a["h0"][0]))
    got_o, got_h = ranks["single"]
    np.testing.assert_allclose(got_o, np.asarray(outs), **FWD)
    np.testing.assert_allclose(got_h, np.asarray(h_t), **FWD)


@pytest.mark.parametrize("phase", [1, 2])
def test_sp_fits_equal_single_process(ranks, phase):
    """fit_phase1 / fit_phase2 on a (2, 1, 2) mesh, the decoder recurrence
    time-split over sp, against the single-process fits."""
    got, want = ranks[f"sp_fit{phase}"]
    leaves_g = got[0] + (got[1] if phase == 2 else [])
    leaves_w = want[0] + (want[1] if phase == 2 else [])
    for a, b in zip(leaves_g, leaves_w):
        np.testing.assert_allclose(a, b, **FIT)
    np.testing.assert_allclose(got[-1]["mean_loss"], want[-1]["mean_loss"],
                               rtol=1e-4)


def test_sp_routing_and_default_microbatches():
    """On a world of one rank: ``seq_parallel`` sets and clears the sp
    context, and ``heads_recurrence`` under it (an sp axis of one rank)
    is the plain recurrence bit for bit; the pipeline itself over a
    one-rank axis is too, at the default depth of one microbatch without
    a warning, and a depth that does not divide the batch raises with
    JAX's message."""
    from vae_connexe_torch.ops.gru import GRUParams, gru_scan_heads
    from vae_connexe_torch.parallel.seq_parallel import (
        seq_sharded_gru_heads as port_sp,
    )

    mesh = world_of_one()
    g = torch.Generator().manual_seed(0)
    params = GRUParams(*(torch.randn(s, generator=g) * 0.3 for s in
                         ((2, 12, 3), (2, 12, 4), (2, 12), (2, 12))))
    x, h0 = torch.randn(5, 6, 3, generator=g), torch.zeros(2, 5, 4)
    with dispatch.seq_parallel(mesh):
        assert dispatch._SP_CTX[0] is mesh
        got = dispatch.heads_recurrence(params, x, h0)
    assert dispatch._SP_CTX is None
    want = gru_scan_heads(params, x, h0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    # sp of one rank: the pipeline itself, one microbatch, no warning.
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        outs, h_t = port_sp(params, x, h0, mesh, axis="ep")
    torch.testing.assert_close(outs, want[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible by microbatches"):
        port_sp(params, x, h0, mesh, axis="ep", microbatches=2)
