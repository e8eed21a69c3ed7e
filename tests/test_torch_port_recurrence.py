"""The port's GRU recurrences and the plain versions of kernels B1/B2 against
the JAX package.

The same numpy-seeded inputs go through the JAX function and its port on
the CPU.  There ``heads_recurrence`` and the kernel wrappers run their plain
versions (a CPU tensor never reaches the CUDA kernels); the kernels
themselves are held against those plain versions on the card by
``test_torch_port_device.py`` and ``chip_smoke.py``.

Tolerances: forward 1e-5 (float32 recurrences of 6 steps summed in another
order by XLA and PyTorch); gradients rtol 1e-3, atol 1e-4, the order of
``tests/test_pallas_gru.py``.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch import convert
from vae_connexe_torch.ops import cuda_gru, cuda_step, dispatch, gru
from vae_connexe_tpu.ops import gru as jgru
from vae_connexe_tpu.ops import pallas_gru
from torch_threads import one_torch_thread  # noqa: F401

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
P, B, T, D, H = 3, 16, 6, 5, 8          # tests/test_pallas_gru.py's shape


def _port(jax_params) -> gru.GRUParams:
    return convert.from_numpy(gru.GRUParams,
                              flax.serialization.to_state_dict(jax_params),
                              "cpu")


def _draws(seed, x_shape, h0_shape, out_shape):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=s).astype(np.float32)
                 for s in (x_shape, h0_shape, out_shape))


def _jax_grads(fn, params, x, h0, douts):
    """Forward and jax.grad of sum(outs * douts) + 0.3 sum(h_T)."""
    def loss(p_, x_, h_):
        outs, h_t = fn(p_, x_, h_)
        return jnp.sum(outs * douts) + 0.3 * jnp.sum(h_t)

    outs, h_t = fn(params, x, h0)
    g_p, g_x, g_h = jax.grad(loss, argnums=(0, 1, 2))(params, x, h0)
    return [np.asarray(v) for v in (outs, h_t, g_p.w_ih, g_p.w_hh, g_p.b_ih,
                                    g_p.b_hh, g_x, g_h)]


def _torch_grads(fn, params, x, h0, douts):
    leaves = [params.w_ih, params.w_hh, params.b_ih, params.b_hh,
              torch.tensor(x), torch.tensor(h0)]
    leaves = [v.clone().requires_grad_(True) for v in leaves]
    outs, h_t = fn(gru.GRUParams(*leaves[:4]), leaves[4], leaves[5])
    loss = (outs * torch.tensor(douts)).sum() + 0.3 * h_t.sum()
    grads = torch.autograd.grad(loss, leaves)
    return [v.detach().numpy() for v in (outs, h_t, *grads)]


def _compare(got, ref):
    for a, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a, r, **FWD)
    for a, r in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, r, **GRAD)


def test_gru_scan_matches_jax():
    """Single GRU: outputs, h_T and every gradient."""
    params = jgru.init_gru(jax.random.key(0), D, H)
    x, h0, douts = _draws(0, (B, T, D), (B, H), (B, T, H))
    ref = _jax_grads(jgru.gru_scan, params, x, h0, douts)
    got = _torch_grads(gru.gru_scan, _port(params), x, h0, douts)
    _compare(got, ref)


CASES = {"shared": ((B, T, D), (P, B, H)),
         "per_head": ((P, B, T, D), (P, B, H)),
         "shared_h0_p1h": ((B, T, D), (P, 1, H))}


@pytest.mark.parametrize("case", list(CASES))
def test_gru_scan_heads_matches_jax(case):
    """Stacked heads with shared and per-head inputs and a broadcast
    (P, 1, H) h0: outputs, h_T and the gradients of params, x and h0."""
    x_shape, h0_shape = CASES[case]
    params = jgru.init_stacked_gru(jax.random.key(1), P, D, H)
    x, h0, douts = _draws(1, x_shape, h0_shape, (P, B, T, H))
    ref = _jax_grads(jgru.gru_scan_heads, params, x, h0, douts)
    got = _torch_grads(gru.gru_scan_heads, _port(params), x, h0, douts)
    _compare(got, ref)


@pytest.fixture
def interpret():
    pallas_gru.set_interpret(True)
    yield
    pallas_gru.set_interpret(False)


@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_kernel_plain_versions_match_pallas_interpret(interpret, per_head):
    """B1's plain version against ``pallas_gru.fused_gru_scan_heads`` and
    B1+B2's against ``gru_scan_heads_fused`` (custom VJP), both in Pallas
    interpret mode."""
    params = jgru.init_stacked_gru(jax.random.key(2), P, D, H)
    x_shape = (P, B, T, D) if per_head else (B, T, D)
    x, h0, douts = _draws(2, x_shape, (P, B, H), (P, B, T, H))
    outs, h_t = pallas_gru.fused_gru_scan_heads(params, jnp.asarray(x),
                                                jnp.asarray(h0),
                                                interpret=True)
    got_outs, got_ht = cuda_gru.fused_gru_scan_heads_plain(
        _port(params), torch.tensor(x), torch.tensor(h0))
    np.testing.assert_allclose(got_outs.numpy(), np.asarray(outs), **FWD)
    np.testing.assert_allclose(got_ht.numpy(), np.asarray(h_t), **FWD)
    ref = _jax_grads(pallas_gru.gru_scan_heads_fused, params, x, h0, douts)
    got = _torch_grads(cuda_gru.gru_scan_heads_fused_plain, _port(params), x,
                       h0, douts)
    _compare(got, ref)


def _phases(params, x, h0, douts):
    """B2's two plain phases after the plain forward, for the loss
    sum(outs * douts) + 0.3 sum(h_T): (outs, h_T, dW_ih, dW_hh, db_ih,
    db_hh, dx, dh0) as numpy, dh0 summed back to h0's broadcast shape."""
    p = params.w_ih.shape[0]
    x, h0 = torch.tensor(x), torch.tensor(h0)
    outs, h_t = gru.gru_scan_heads(params, x, h0)
    d = torch.tensor(douts).clone()
    d[:, :, -1] += 0.3                   # h_T is outs at the last step
    h0b = h0.expand(p, x.shape[-3], params.hidden)
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    gh, dh0 = cuda_gru.bwd_chain(*w, x, h0b, outs, d)
    dx, dwih, dbih, dwhh, dbhh = cuda_gru.bwd_wgrad(*w, x, h0b, outs, gh, True)
    dh0 = dh0.sum(dim=1, keepdim=True) if h0.shape[1] == 1 else dh0
    return [v.numpy() for v in (outs, h_t, dwih, dwhh, dbih, dbhh, dx, dh0)]


# (P, B, T, D, H, x shape, h0 shape): CASES at the small shape, and hidden
# 128 (the wide route's width; its chain is held against this plain phase
# on the card).
PHASE_CASES = {**{k: (P, B, T, D, H, *v) for k, v in CASES.items()},
               "wide_h128": (2, 8, 4, 40, 128, (8, 4, 40), (2, 8, 128))}


@pytest.mark.parametrize("case", list(PHASE_CASES))
def test_backward_phases_match_autograd_and_pallas(interpret, case):
    """B2's plain phases together (the chain: gh and dh0 from outs, x, h0,
    douts; the weight gradients: dW, db, dx from gh, outs, x, h0), as the
    CPU wrappers ``bwd_chain`` / ``bwd_wgrad`` run them, against autograd
    through ``gru_scan_heads`` and against ``pallas_gru.gru_scan_heads_fused``
    in interpret mode: shared and per-head inputs, a broadcast (P, 1, H) h0,
    dx, and hidden 128.  Tolerance: rtol 1e-3, atol 1e-4 (float32, other
    summation order)."""
    p, b, t, d, hid, x_shape, h0_shape = PHASE_CASES[case]
    params = jgru.init_stacked_gru(jax.random.key(5), p, d, hid)
    x, h0, douts = _draws(5, x_shape, h0_shape, (p, b, t, hid))
    got = _phases(_port(params), x, h0, douts)
    _compare(got, _torch_grads(gru.gru_scan_heads, _port(params), x, h0,
                               douts))
    _compare(got, _jax_grads(pallas_gru.gru_scan_heads_fused, params, x, h0,
                             douts))


# (P, B, T, D, H): the wide_h128 phase case's shape, and hidden 130, a
# width whose units pad to 160 on the wide route.
WIDE_FWD_CASES = {"wide_h128": (2, 8, 4, 40, 128), "wide_h130": (2, 8, 4, 40, 130)}


@pytest.mark.parametrize("case", list(WIDE_FWD_CASES))
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_wide_forward_decomposition_matches_jax(interpret, case, per_head):
    """The wide forward's decomposition (``fwd_wide_plain``: every step's
    input projection first, then a walk over h W_hh^T alone), the plain
    version of what ``gru_forward_wide_kernel`` computes, against
    ``pallas_gru.fused_gru_scan_heads`` in interpret mode and against
    ``gru.gru_scan_heads``: rtol 1e-5, atol 1e-5 (float32 sums in another
    order)."""
    p, b, t, d, hid = WIDE_FWD_CASES[case]
    params = jgru.init_stacked_gru(jax.random.key(7), p, d, hid)
    x_shape = (p, b, t, d) if per_head else (b, t, d)
    x, h0, _ = _draws(7, x_shape, (p, b, hid), (1,))
    outs, h_t = pallas_gru.fused_gru_scan_heads(params, jnp.asarray(x),
                                                jnp.asarray(h0),
                                                interpret=True)
    prm = _port(params)
    got = cuda_gru.fwd_wide_plain(prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh,
                                  torch.tensor(x), torch.tensor(h0))
    assert got.shape == (p, b, t, hid)
    np.testing.assert_allclose(got.numpy(), np.asarray(outs), **FWD)
    np.testing.assert_allclose(got[:, :, -1].numpy(), np.asarray(h_t), **FWD)
    ref, _ = gru.gru_scan_heads(prm, torch.tensor(x), torch.tensor(h0))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **FWD)


def test_xproj_plain_matches_input_projection():
    """The wide chain's input projection (``bwd_xproj``; on a CPU tensor its
    plain version) against W_ih x + b_ih per head in float64 numpy, for a
    shared (B, T, D) and a per-head (P, B, T, D) input at hidden 128, D=40:
    rtol 1e-5, atol 1e-5 (sums of 40 float32 products)."""
    rng = np.random.default_rng(9)
    p, b, t, d, hid = 2, 5, 3, 40, 128
    w_ih = rng.normal(size=(p, 3 * hid, d)).astype(np.float32) * 0.1
    b_ih = rng.normal(size=(p, 3 * hid)).astype(np.float32)
    for x in (rng.normal(size=(b, t, d)).astype(np.float32),
              rng.normal(size=(p, b, t, d)).astype(np.float32)):
        xs = np.broadcast_to(x, (p, b, t, d)).astype(np.float64)
        want = (np.einsum("pbtd,pgd->pbtg", xs, w_ih.astype(np.float64))
                + b_ih[:, None, None].astype(np.float64))
        args = (torch.tensor(w_ih), torch.tensor(b_ih), torch.tensor(x))
        got = cuda_gru.bwd_xproj(*args)
        assert got.shape == (p, b, t, 3 * hid)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(got, cuda_gru.xproj_plain(*args), rtol=0,
                                   atol=0)


def test_wgrad_partials_layout():
    """The weight-gradient kernel's partials (gru.cu ``wgrad_part_floats``:
    per head and split [dW_hh, dW_ih, db_hh, db_ih]) map back to the
    gradients: ``_wgrad_sums`` sums the splits and slices each one out."""
    g = torch.Generator().manual_seed(6)
    p, splits = 2, 3
    x = torch.randn((B, T, D), generator=g)
    dwhh, dwih = (torch.randn((p, splits, 3 * H, n), generator=g)
                  for n in (H, D))
    dbhh, dbih = (torch.randn((p, splits, 3 * H), generator=g)
                  for _ in range(2))
    part = torch.cat([dwhh.flatten(2), dwih.flatten(2), dbhh, dbih], dim=2)
    dx = torch.randn((p, B, T, D), generator=g)
    ops = ((p, B, T, D, H), x)
    got_dx, got_dwih, got_dbih, got_dwhh, got_dbhh = cuda_gru._wgrad_sums(
        ops, dx, part)
    for a, r in ((got_dx, dx.sum(0)), (got_dwih, dwih.sum(1)),
                 (got_dbih, dbih.sum(1)), (got_dwhh, dwhh.sum(1)),
                 (got_dbhh, dbhh.sum(1))):
        torch.testing.assert_close(a, r, rtol=0, atol=0)


@pytest.mark.parametrize("batch,steps,heads,want", [
    (256, 10, 20, (4, 640)),   # decoder: 480 blocks, one round of 4 per SM
    (256, 10, 1, (40, 64)),    # encoder: the 64-row floor
    (37, 10, 20, (4, 96)),     # a ragged batch: 370 rows in 4 chunks
    (1, 1, 1, (1, 64)),
])
def test_wgrad_splits(batch, steps, heads, want):
    """The K = B*T rows split into fixed chunks that cover them once and
    keep the grid within one round of resident blocks on an H100."""
    splits, chunk = cuda_gru.wgrad_splits(batch, steps, 20, 64, heads, 132)
    assert (splits, chunk) == want
    assert chunk % cuda_gru.WGRAD_BK == 0
    assert (splits - 1) * chunk < batch * steps <= splits * chunk


def test_cpu_recurrences_never_launch():
    """On CPU tensors the dispatch runs the plain recurrences and adds
    nothing to any kernel's launch count."""
    g = torch.Generator().manual_seed(3)
    heads = gru.init_stacked_gru(g, P, D, H, device="cpu")
    heads = gru.GRUParams(*(v.requires_grad_(True) for v in
                            (heads.w_ih, heads.w_hh, heads.b_ih, heads.b_hh)))
    one = gru.init_gru(g, D, H, device="cpu")
    x, h0 = torch.randn((B, T, D), generator=g), torch.randn((1, B, H), generator=g)
    cuda_gru.reset_launches()
    outs, h_t = dispatch.heads_recurrence(heads, x, h0)
    ref, ref_t = gru.gru_scan_heads(heads, x, h0)
    torch.testing.assert_close(outs, ref, rtol=0, atol=0)
    torch.testing.assert_close(h_t, ref_t, rtol=0, atol=0)
    outs1, h1 = dispatch.gru_sequence(one, x, h0[0])
    ref1, ref1_t = gru.gru_scan(one, x, h0[0])
    torch.testing.assert_close(outs1, ref1, rtol=0, atol=0)
    torch.testing.assert_close(h1, ref1_t, rtol=0, atol=0)
    outs.sum().backward()
    assert heads.w_hh.grad is not None
    assert set(cuda_gru.LAUNCHES) == {"gru_forward", "gru_backward",
                                      "gru_forward_wide", "gru_backward_wide"}
    assert not any(cuda_gru.LAUNCHES.values()), cuda_gru.LAUNCHES


H100 = (232448, 233472, 132, 2048)     # opt-in smem, smem per SM, SMs, threads


# kernel: False for B1's forward (the ids of the first cases predate the
# other kernels), "step_encoder" for B3's encoder forward, "chain" for B2's
# chain.
@pytest.mark.parametrize("batch,heads,kernel,want", [
    # B1 (gru_fwd.cuh): fwd_step_cost, the warps each scheduler of the
    # busiest SM holds, over FWD_TILES.
    (256, 20, False, 20),  # phase-1 decoder: 260 blocks, two an SM
    # B3's decoder forward (gru_tile.cuh's body, pick_tile's default rule):
    (256, 20, "step_decoder", 16),  # one wave of 320 blocks on 20 heads
    # B3's encoder forward (that tile plus a block's reduction scratch):
    (256, 20, "step_encoder", 16),  # the same wave
    (256, 1, False, 8),      # the encoder: 32 blocks of 4 warps, one warp
                             # a scheduler; 4 rows tie, 8 is wider
    (256, 1, "step_encoder", 4),    # B3's encoder: 64 blocks
    (37, 20, False, 8),
    (1, 1, "step_encoder", 1),
    # B2's chain: waves times the shared-memory loads a thread issues per
    # step (chain_step_loads), which a tile-width sweep on an H100 follows.
    (256, 20, "chain", 20),  # 260 blocks of 107 KB, two per SM: one wave
    (256, 1, "chain", 4),    # one wave at any width: the fewest loads a row
    (37, 20, "chain", 4),
    (1, 1, "chain", 1),
    (3072, 20, "chain", 24),  # ten waves at 24 rows, twelve at 20
])
def test_pick_tile(batch, heads, kernel, want):
    if kernel is False:
        bt = cuda_gru.fwd_tile(batch, heads, 20, 64, H100)
        assert bt == want
        assert cuda_gru.fwd_tile_smem_bytes(bt, 20, 64) <= H100[0]
        return
    fn = {"step_decoder": cuda_gru.fwd_smem_bytes,
          "step_encoder": cuda_step.encoder_fwd_smem_bytes,
          "chain": cuda_gru.chain_smem_bytes}[kernel]
    step, tiles = ((lambda n: cuda_gru.chain_step_loads(n, 20, 64),
                    cuda_gru.CHAIN_TILES) if kernel == "chain"
                   else (cuda_gru.rows_per_thread, cuda_gru.TILES))
    bt = cuda_gru.pick_tile(batch, heads, 64, lambda n: fn(n, 20, 64), H100,
                            step, tiles)
    assert bt == want
    assert fn(bt, 20, 64) <= H100[0]


# (heads, batch, d, hidden) -> route at the H100's limits, with B1's and
# B2's chain tiles on it.
@pytest.mark.parametrize("heads,batch,d,hidden,want,fwd_bt,chain_bt", [
    (20, 256, 20, 64, "kernel", 20, 20),   # the main path's decoder heads
    (1, 256, 20, 64, "kernel", 8, 4),      # ... and its encoder
    (1, 256, 10, 64, "kernel", 8, 4),      # lorenz96_crvae's ErrorVAE
    (40, 512, 40, 128, "wide", 64, 32),    # lorenz96_scaled's heads
    (1, 512, 40, 128, "wide", 16, 16),     # ... and its encoder
    (128, 64, 128, 128, "wide", 64, 32),   # lorenz96_xl's heads
    (10, 2048, 10, 64, "kernel", 32, 28),  # lorenz96_crcsrae's phase-1 heads
    (1, 2048, 10, 64, "kernel", 16, 8),    # ... its encoder
    (10, 1024, 10, 64, "kernel", 16, 20),  # ... its phase-2 heads
    (1, 1024, 10, 64, "kernel", 8, 4),     # ... its phase-2 encoder, ErrorVAE
    (1, 32, 10, 64, "kernel", 8, 4),       # vrae_demo's encoder
], ids=["main-heads", "main-encoder", "crvae-error-vae", "scaled-heads",
        "scaled-encoder", "xl-heads", "crcsrae-heads", "crcsrae-encoder",
        "crcsrae-phase2-heads", "crcsrae-phase2-encoder", "vrae-encoder"])
def test_recurrence_route(heads, batch, d, hidden, want, fwd_bt, chain_bt):
    """The kernels' variant is chosen from shapes and the card's limits
    alone: both weights in shared memory where B1's tile and B2's chain
    tile fit so, else the wide variants: B1 and B2's chain walk on
    clusters that split W_hh (at hidden 128 the two weights need more than
    an H100 block's 232,448 bytes)."""
    route = cuda_gru.recurrence_route(heads, batch, d, hidden, H100)
    assert route == want
    wide = route == "wide"
    assert (cuda_gru.fwd_tile(batch, heads, d, hidden, H100) is None) == wide
    assert (cuda_gru.chain_tile(batch, heads, d, hidden, H100) is None) == wide
    assert cuda_gru.fwd_tile(batch, heads, d, hidden, H100, wide) == fwd_bt
    assert cuda_gru.chain_tile(batch, heads, d, hidden, H100, wide) == chain_bt
    if wide:
        assert cuda_gru.wide_fwd_plan(batch, heads, hidden, H100) == fwd_bt
        assert cuda_gru.wide_fwd_smem_bytes(fwd_bt, hidden) <= H100[0]
        assert cuda_gru.wide_chain_plan(batch, heads, hidden, H100) == chain_bt
        assert cuda_gru.wide_chain_smem_bytes(chain_bt, hidden) <= H100[0]
    else:
        assert cuda_gru.fwd_tile_smem_bytes(fwd_bt, d, hidden) <= H100[0]
        assert cuda_gru.chain_smem_bytes(chain_bt, d, hidden) <= H100[0]


# The shapes at which every hidden width from 1 to 132 must route:
# lorenz96_scaled's heads and encoder, lorenz96_xl's heads, and the
# phase-1 decoder heads of bench.py's width.
ROUTE_SHAPES = [(40, 512, 40), (1, 512, 40), (128, 64, 128), (20, 256, 20)]


@pytest.mark.parametrize("heads,batch,d", ROUTE_SHAPES,
                         ids=["scaled-heads", "scaled-encoder", "xl-heads",
                              "main-heads"])
def test_recurrence_route_covers_hidden_1_to_132(heads, batch, d):
    """Every hidden width from 1 to 132 takes a route at the H100's limits
    (no width between the two routes raises): the units of the wide walks
    pad to 16 a block (H' = 160 at H = 129-132) and the wide chain's d
    h_prev items to 16 units where 32 do not divide a block's units, so B1
    and B2's chain both fit there; on each route both kernels have a
    tile."""
    for hidden in range(1, 133):
        route = cuda_gru.recurrence_route(heads, batch, d, hidden, H100)
        wide = route == "wide"
        assert cuda_gru.fwd_tile(batch, heads, d, hidden, H100, wide), hidden
        assert cuda_gru.chain_tile(batch, heads, d, hidden, H100, wide), hidden
    assert cuda_gru.recurrence_route(heads, batch, d, 132, H100) == "wide"


# (heads, batch) -> the wide chain's tile, threads, shared memory and grid
# at hidden 128 and the H100's limits.
@pytest.mark.parametrize("heads,batch,bt,threads,smem,grid", [
    (40, 512, 32, 256, 195840, (32, 40)),   # lorenz96_scaled's heads
    (1, 512, 16, 128, 148992, (64, 1)),     # ... encoder, ErrorVAE
    (128, 64, 32, 256, 195840, (4, 128)),   # lorenz96_xl's heads
    (1, 64, 16, 128, 148992, (8, 1)),       # ... and its encoder
    (64, 64, 32, 256, 195840, (4, 64)),     # xl_ep2: a rank's heads
    (3, 37, 16, 128, 148992, (6, 3)),       # a ragged batch
], ids=["scaled-heads", "scaled-encoder", "xl-heads", "xl-encoder",
        "xl-ep2-rank", "ragged"])
def test_wide_chain_plan(heads, batch, bt, threads, smem, grid):
    """The wide chain's plan from shapes and limits alone (the cost model
    fitted to the tile tool's sweep on an H100): clusters of 2 blocks
    splitting W_hh's 128 units, 32-row tiles on the many-head fits, 16-row
    tiles where one head leaves SMs idle; every block within the opt-in
    shared memory and 256 threads, and at least one a SM."""
    assert cuda_gru.WIDE_CLUSTER == 2
    assert cuda_gru.wide_chain_plan(batch, heads, 128, H100) == bt
    assert cuda_gru.wide_chain_threads(bt, 128) == threads
    assert threads <= cuda_gru.WIDE_MAX_THREADS
    assert cuda_gru.wide_chain_smem_bytes(bt, 128) == smem
    assert smem <= H100[0]
    assert cuda_gru.wide_blocks_per_sm(bt, 128, H100) >= 1
    assert (-(-batch // bt) * cuda_gru.WIDE_CLUSTER, heads) == grid
    assert cuda_gru.chain_tile(batch, heads, 40, 128, H100, True) == bt


def test_wide_chain_layout():
    """The wide chain's units and shared memory (gru_wide.cuh
    ``wide_hpad``, ``wide_smem_floats``): H padded to 16 units a block of
    the cluster, W_hh rows of H' + 4 floats, two h_prev buffers, the gate
    gradients at 3U + 4 a row and C slots of U + 4 a row in two buffers;
    a warp a (16 rows, 16 units) item, at most 256 threads."""
    assert cuda_gru.wide_hpad(128) == 128 and cuda_gru.wide_units(128) == 64
    assert cuda_gru.wide_hpad(100) == 128 and cuda_gru.wide_hpad(40) == 64
    assert cuda_gru.wide_units(40) == 32
    u, ks = 64, 132
    want = 4 * (3 * u * ks + 3 * u + 2 * 32 * ks + 32 * (3 * u + 4)
                + 2 * 2 * 32 * (u + 4))
    assert cuda_gru.wide_chain_smem_bytes(32, 128) == want == 195840
    assert cuda_gru.wide_chain_threads(32, 40) == 128
    assert cuda_gru.wide_chain_threads(64, 40) == 256
    assert cuda_gru.wide_blocks_per_sm(48, 128, H100) == 0   # 384 threads
    assert cuda_gru.wide_blocks_per_sm(8, 128, H100) == 0    # under 16 rows
    assert cuda_gru.wide_blocks_per_sm(64, 128, H100) == 0   # 512 threads
    # Past hidden 128 the units pad to 160 (80 a block): 16-row tiles fit,
    # and the d h_prev items take 16 units so that none straddles the two
    # blocks; past 160 units nothing fits.
    assert cuda_gru.wide_hpad(130) == cuda_gru.wide_hpad(160) == 160
    assert cuda_gru.wide_units(132) == 80 and cuda_gru.wide_hpad(96) == 96
    assert cuda_gru.wide_chain_plan(64, 40, 130, H100) == 16
    assert cuda_gru.wide_chain_smem_bytes(16, 130) == 216512 <= H100[0]
    assert cuda_gru.wide_chain_threads(16, 130) == 160
    assert cuda_gru.wide_chain_plan(64, 40, 161, H100) is None


# (heads, batch, hidden) -> the wide forward's tile, threads, shared memory
# and grid at the H100's limits.
@pytest.mark.parametrize("heads,batch,hidden,bt,threads,smem,grid", [
    (40, 512, 128, 64, 512, 169728, (16, 40)),   # lorenz96_scaled's heads
    (1, 512, 128, 16, 128, 119040, (64, 1)),     # ... encoder, ErrorVAE
    (128, 64, 128, 64, 512, 169728, (2, 128)),   # lorenz96_xl's heads
    (1, 64, 128, 16, 128, 119040, (8, 1)),       # ... and its encoder
    (3, 37, 128, 16, 128, 119040, (6, 3)),       # a ragged batch
    (40, 512, 130, 48, 480, 221376, (22, 40)),   # hidden 130: 160 units
    (128, 64, 132, 32, 320, 200384, (4, 128)),
], ids=["scaled-heads", "scaled-encoder", "xl-heads", "xl-encoder", "ragged",
        "h130-heads", "h132-xl-heads"])
def test_wide_fwd_plan(heads, batch, hidden, bt, threads, smem, grid):
    """The wide forward's plan from shapes and limits alone (gru_wide.cuh
    ``gru_fwd_wide_body``): clusters of 2 blocks splitting W_hh's units, a
    block's W_hh rows (3U of H' + 4 floats), b_hh and two h buffers of bt
    rows; a warp a (16 rows, 16 units) item, at most 512 threads, one block
    an SM; the tile the cost model ``wide_fwd_step_cost`` picks."""
    assert cuda_gru.wide_fwd_plan(batch, heads, hidden, H100) == bt
    assert cuda_gru.fwd_tile(batch, heads, 40, hidden, H100, True) == bt
    assert cuda_gru.wide_chain_threads(bt, hidden) == threads
    assert threads <= cuda_gru.WIDE_FWD_MAX_THREADS
    u, ks = cuda_gru.wide_units(hidden), cuda_gru.wide_hpad(hidden) + 4
    assert cuda_gru.wide_fwd_smem_bytes(bt, hidden) == smem == 4 * (
        3 * u * ks + 3 * u + 2 * bt * ks)
    assert smem <= H100[0]
    assert cuda_gru.wide_fwd_blocks_per_sm(bt, hidden, H100) == 1
    assert (-(-batch // bt) * cuda_gru.WIDE_CLUSTER, heads) == grid
    # No tile past the limits: 64 rows at 160 units needs 242,368 bytes.
    assert cuda_gru.wide_fwd_blocks_per_sm(64, 130, H100) == 0
    assert cuda_gru.wide_fwd_blocks_per_sm(8, 128, H100) == 0


def test_recurrence_route_raises_when_nothing_fits():
    """At hidden 256 not even half of W_hh fits a block of the wide route's
    clusters: the wrappers raise before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gru.recurrence_route(1, 256, 20, 256, H100)


def test_fwd_tile_needs_an_even_hidden_width():
    """B1's threads own unit pairs: an odd width runs with one pad unit, at
    the tile and threads of the next even width."""
    assert (cuda_gru.fwd_tile(256, 20, 20, 63, H100)
            == cuda_gru.fwd_tile(256, 20, 20, 64, H100) == 20)
    assert cuda_gru.fwd_units(63) == 64 and cuda_gru.fwd_units(64) == 64
    assert cuda_gru.fwd_tile_threads(20, 63) == cuda_gru.fwd_tile_threads(20, 64)
    assert cuda_gru.recurrence_route(20, 256, 20, 63, H100) == "kernel"


def test_pick_tile_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        cuda_gru.pick_tile(8, 1, 256, lambda n: cuda_step.encoder_fwd_smem_bytes(
            n, 20, 256), H100)


def test_gru_kernel_operands_are_validated():
    """Before a launch every operand must be float32 of the shape the
    kernel reads it by (checked here on the CPU, where no launch follows);
    h0 keeps its broadcast strides."""
    g = torch.Generator().manual_seed(4)
    p = gru.init_stacked_gru(g, P, D, H, device="cpu")
    x = torch.randn((B, T, D), generator=g)
    h0 = torch.randn((B, H), generator=g).expand(P, B, H)
    shapes, _, xs, _, hs = cuda_gru._operands(p.w_ih, p.b_ih, p.w_hh, p.b_hh,
                                              x, h0)
    assert shapes == (P, B, T, D, H)
    assert xs == (0, T * D, D) and hs == (0, H)
    with pytest.raises(ValueError, match="expected"):
        cuda_gru._operands(p.w_ih, p.b_ih, p.w_hh, p.b_hh, x[:, :, :2], h0)
    with pytest.raises(ValueError, match="float32"):
        cuda_gru._operands(p.w_ih.double(), p.b_ih, p.w_hh, p.b_hh, x, h0)
