"""The port's boundaries: no JAX inside it, no silent CPU fallback, and the
kernels on the card.

This file imports no JAX, so its card test runs where JAX is absent:
``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_port_device.py``.
"""

import subprocess
import sys

import pytest
import torch

from vae_connexe_torch import _device
from vae_connexe_torch.models import CRVAE, ErrorVAE, masked_heads
from vae_connexe_torch.ops import cuda_gru, cuda_rollout, cuda_step
from vae_connexe_torch.ops.gru import GRUParams, init_stacked_gru
from vae_connexe_torch.optim import adam_init
from vae_connexe_torch.train import (
    Phase1Config,
    Phase2Config,
    Phase2State,
    make_phase2_step,
)
from vae_connexe_torch.utils.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

_MODULES = ["vae_connexe_torch", "vae_connexe_torch._device",
            "vae_connexe_torch.cli", "vae_connexe_torch.configs",
            "vae_connexe_torch.configs.experiments", "vae_connexe_torch.convert",
            "vae_connexe_torch.data.henon", "vae_connexe_torch.data.io",
            "vae_connexe_torch.data.native_loader",
            "vae_connexe_torch.data.lorenz96",
            "vae_connexe_torch.data.timegan_utils",
            "vae_connexe_torch.data.var",
            "vae_connexe_torch.data.windows",
            "vae_connexe_torch.discover", "vae_connexe_torch.evals.gc_metrics",
            "vae_connexe_torch.evals.generation", "vae_connexe_torch.evals.viz",
            "vae_connexe_torch.losses.cs_divergence",
            "vae_connexe_torch.losses.kl",
            "vae_connexe_torch.losses.penalties",
            "vae_connexe_torch.models.crvae",
            "vae_connexe_torch.models.crvae_win",
            "vae_connexe_torch.models.csrae",
            "vae_connexe_torch.models.error_vae",
            "vae_connexe_torch.models.gmm_prior",
            "vae_connexe_torch.models.vrae",
            "vae_connexe_torch.ops._build", "vae_connexe_torch.ops.cuda_gru",
            "vae_connexe_torch.ops.cuda_rollout", "vae_connexe_torch.ops.cuda_step",
            "vae_connexe_torch.ops.dispatch", "vae_connexe_torch.ops.gru",
            "vae_connexe_torch.ops.library",
            "vae_connexe_torch.ops.rnn_cells",
            "vae_connexe_torch.optim.adam", "vae_connexe_torch.optim.prox",
            "vae_connexe_torch.parallel", "vae_connexe_torch.parallel.seed_sweep",
            "vae_connexe_torch.parallel.collectives",
            "vae_connexe_torch.parallel.mesh",
            "vae_connexe_torch.parallel.multihost",
            "vae_connexe_torch.parallel.multiprocess",
            "vae_connexe_torch.parallel.seq_parallel",
            "vae_connexe_torch.parallel.serve",
            "vae_connexe_torch.parallel.sharded",
            "vae_connexe_torch.server",
            "vae_connexe_torch.serving", "vae_connexe_torch.train.config",
            "vae_connexe_torch.train.crvae_trainer",
            "vae_connexe_torch.train.csrae_trainer",
            "vae_connexe_torch.train.streaming",
            "vae_connexe_torch.train.vrae_trainer",
            "vae_connexe_torch.train.win_trainer",
            "vae_connexe_torch.utils.checkpoint",
            "vae_connexe_torch.utils.debug",
            "vae_connexe_torch.utils.layers",
            "vae_connexe_torch.utils.metrics_log",
            "vae_connexe_torch.utils.profiling",
            "vae_connexe_torch.utils.scalers", "vae_connexe_torch.utils.seeding",
            "vae_connexe_torch.utils.tree"]


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'jaxlib', 'vae_connexe_tpu')))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _device.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CRVAE(p=3, hidden=4).init(torch.Generator().manual_seed(0))
    from vae_connexe_torch.serving import load_generator
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_generator(b"")
    assert _device.resolve_device("cpu") == torch.device("cpu")


def test_kernel_build_is_content_addressed():
    """The library path names a hash of the source and flags; nothing is
    built at import."""
    from vae_connexe_torch.ops import _build

    path = _build.library_path("rollout")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path("rollout")
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


@pytest.mark.parametrize("name", ["gru", "step", "rollout"])
def test_training_libraries_are_content_addressed(name, tmp_path, monkeypatch):
    """The libraries that share headers (gru and step; rollout, which
    reuses B1's helpers) are named by a hash of every source they are
    built from, the shared headers included: the same bytes give the same
    path, an edit to any one of them another."""
    from vae_connexe_torch.ops import _build

    path = _build.library_path(name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}-")
    assert {"gru_tile.cuh", "gru_bwd.cuh"} <= set(_build.SOURCES[name])
    for src in _build.SOURCES[name]:
        (tmp_path / src).write_bytes((_build.CSRC / src).read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build.library_path(name) == path
    for src in _build.SOURCES[name]:
        orig = (tmp_path / src).read_bytes()
        (tmp_path / src).write_bytes(orig + b"\n// edited\n")
        assert _build.library_path(name) != path
        (tmp_path / src).write_bytes(orig)


@pytest.fixture
def cuda_device():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route,p,hidden,b,parents", [
    ("resident", 6, 16, 37, True),       # one head a block, cluster of 6
    ("resident", 20, 64, 37, False),     # the serving width, cluster of 7
    ("streamed", 40, 128, 37, False),    # lorenz96_scaled's width, M=8
    ("streamed", 128, 128, 37, True),    # lorenz96_xl's width, M=32
], ids=["resident-p6", "resident-p20", "streamed-p40", "streamed-p128"])
def test_kernels_match_plain_on_card(cuda_device, route, p, hidden, b,
                                     parents):
    """Both kernels against their plain versions on the card, on each
    route, ragged batch, a random parents mask where marked, the ErrorVAE
    at the same width; two calls give bitwise-equal outputs.  Tolerance
    1e-4 absolute: 21 float32 steps, FMA order differs from cuBLAS's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    t = 21
    params = CRVAE(p, hidden).init(g, cuda_device)
    err = ErrorVAE(p, hidden).init(g, cuda_device)
    heads = params.heads
    if parents:
        heads = masked_heads(heads, (torch.rand((p, p), generator=g) > 0.3)
                             .float())
    h0 = torch.randn((b, hidden), generator=g).to(cuda_device)
    noise = torch.randn((b, t, p), generator=g).to(cuda_device)
    x0 = torch.zeros((b, p), device=cuda_device)
    cuda_rollout.reset_launches()
    k1, k1_again = (cuda_rollout.crvae_free_run_fused(
        heads, params.readout, x0, h0, noise, 0.1) for _ in range(2))
    k2, k2_again = (cuda_rollout.errvae_sample_fused(err.dec, err.out, h0, p,
                                                     t) for _ in range(2))
    assert cuda_rollout.ROUTE_LAUNCHES[f"crvae_free_run_{route}"] == 2
    assert cuda_rollout.ROUTE_LAUNCHES[f"errvae_sample_{route}"] == 2
    ref1 = cuda_rollout.crvae_free_run_plain(heads, params.readout, x0, h0,
                                             noise, 0.1)
    ref2 = cuda_rollout.errvae_sample_plain(err.dec, err.out, h0, p, t)
    torch.cuda.synchronize()
    torch.testing.assert_close(k1, ref1, rtol=0, atol=1e-4)
    torch.testing.assert_close(k2, ref2, rtol=0, atol=1e-4)
    assert torch.equal(k1, k1_again) and torch.equal(k2, k2_again)


def _params_on(p, d, hidden, seed, device):
    return init_stacked_gru(torch.Generator().manual_seed(seed), p, d, hidden,
                            device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_gru_kernels_match_plain_on_card(cuda_device, per_head):
    """B1 and B2 against their plain versions on the card: a ragged batch
    of 37, an h0 broadcast from one (B, H) state or per head, a random
    parents mask.  Tolerances: outputs 1e-4 absolute; gradients rtol 1e-3,
    atol 1e-4 (float32, another summation order than autograd's)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(1)
    p, b, t, d, hidden = 5, 37, 7, 6, 16
    params = _params_on(p, d, hidden, 2, cuda_device)
    mask = (torch.rand((p, d), generator=g) > 0.3).float().to(cuda_device)
    params = GRUParams(params.w_ih * mask[:, None, :], params.w_hh,
                       params.b_ih, params.b_hh)
    shape = (p, b, t, d) if per_head else (b, t, d)
    x = torch.randn(shape, generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden) if per_head else (1, b, hidden),
                     generator=g).to(cuda_device)
    douts = torch.randn((p, b, t, hidden), generator=g).to(cuda_device)
    leaves = [params.w_ih, params.w_hh, params.b_ih, params.b_hh]
    got, ref = [], []
    for fn, sink in ((cuda_gru.gru_scan_heads_fused, got),
                     (cuda_gru.gru_scan_heads_fused_plain, ref)):
        ins = [v.clone().requires_grad_(True) for v in leaves + [x, h0]]
        outs, h_t = fn(GRUParams(*ins[:4]), ins[4], ins[5])
        grads = torch.autograd.grad((outs * douts).sum() + h_t.sum(), ins)
        sink.extend([outs.detach(), *grads])
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-4)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [15, 16, 64])
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_gru_forward_matches_plain_on_card(cuda_device, per_head, hidden):
    """B1 (csrc/gru_fwd.cuh) against its plain version on the card: a
    ragged batch of 37, shared or per-head input and h0, a random parents
    mask, at a hidden width whose unit pairs come in sixteens (64), one
    whose do not (16) and an odd one (15, one pad unit).  Outputs 1e-5
    absolute (float32, another summation order); two calls bitwise
    equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    p, b, t, d = 5, 37, 9, 20
    params = _params_on(p, d, hidden, 7, cuda_device)
    mask = (torch.rand((p, d), generator=g) > 0.3).float().to(cuda_device)
    params = GRUParams(params.w_ih * mask[:, None, :], params.w_hh,
                       params.b_ih, params.b_hh)
    x = torch.randn((p, b, t, d) if per_head else (b, t, d),
                    generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden) if per_head else (1, b, hidden),
                     generator=g).to(cuda_device)
    first, h_t = cuda_gru.fused_gru_scan_heads(params, x, h0)
    second, _ = cuda_gru.fused_gru_scan_heads(params, x, h0)
    ref, ref_t = cuda_gru.fused_gru_scan_heads_plain(params, x, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(h_t, ref_t, rtol=0, atol=1e-5)
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 128])
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_gru_wide_matches_plain_on_card(cuda_device, per_head, d):
    """The wide variants of B1 and B2's chain (each the input projection,
    then the walk on clusters) at hidden 128
    with lorenz96_scaled's D=40 and lorenz96_xl's D=128, where the two
    weights do not fit a block together: outputs 1e-5 absolute, gradients
    rtol 1e-3, atol 1e-4, the chain's gate gradients against its plain
    phase, two calls bitwise equal, and only the wide kernels launched."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(8)
    p, b, t, hidden = 3, 37, 5, 128
    limits = cuda_gru.device_limits(cuda_device)
    assert cuda_gru.recurrence_route(p, b, d, hidden, limits) == "wide"
    params = _params_on(p, d, hidden, 9, cuda_device)
    x = torch.randn((p, b, t, d) if per_head else (b, t, d),
                    generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden) if per_head else (1, b, hidden),
                     generator=g).to(cuda_device)
    douts = torch.randn((p, b, t, hidden), generator=g).to(cuda_device)
    leaves = [params.w_ih, params.w_hh, params.b_ih, params.b_hh]
    cuda_gru.reset_launches()
    got, ref = [], []
    for fn, sink in ((cuda_gru.gru_scan_heads_fused, got),
                     (cuda_gru.gru_scan_heads_fused_plain, ref)):
        ins = [v.clone().requires_grad_(True) for v in leaves + [x, h0]]
        outs, _ = fn(GRUParams(*ins[:4]), ins[4], ins[5])
        grads = torch.autograd.grad((outs * douts).sum(), ins)
        sink.extend([outs.detach(), *grads])
    assert cuda_gru.LAUNCHES == {"gru_forward": 0, "gru_backward": 0,
                                 "gru_forward_wide": 1,
                                 "gru_backward_wide": 1}
    again, _ = cuda_gru.fused_gru_scan_heads(params, x, h0)
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    h0b = h0.expand(p, b, hidden)
    k_gh, k_dh0 = cuda_gru.bwd_chain(*w, x, h0b, got[0], douts)
    r_gh, r_dh0 = cuda_gru.bwd_chain_plain(*w, x, h0b, got[0], douts)
    first = cuda_gru._backward_launch(*w, x, h0b, got[0], douts, True)
    second = cuda_gru._backward_launch(*w, x, h0b, got[0], douts, True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=1e-5)
    assert torch.equal(got[0], again)
    for a, r in zip(got[1:], ref[1:]):
        torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(k_gh, r_gh, rtol=1e-3, atol=1e-4)
    torch.testing.assert_close(k_dh0, r_dh0, rtol=1e-3, atol=1e-4)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_wide_chain_variants_match_plain_on_card(cuda_device):
    """Every tile of the wide chain (``cuda_gru.wide_blocks_per_sm`` > 0),
    launched directly on a ragged batch of 37 with a per-head input,
    against the plain chain (rtol 1e-3, atol 1e-4, and rtol 1e-5, atol
    2e-5 as ``chip_smoke.py``'s ``WIDE_CHAIN_TOL``: its products keep
    float32's accuracy), and the input projection against ``xproj_plain``
    (rtol 1e-5, atol 1e-5)."""
    g = torch.Generator().manual_seed(12)
    p, b, t, d, hidden = 2, 37, 4, 40, 128
    params = _params_on(p, d, hidden, 13, cuda_device)
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    x = torch.randn((p, b, t, d), generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden), generator=g).to(cuda_device)
    douts = torch.randn((p, b, t, hidden), generator=g).to(cuda_device)
    outs = cuda_gru._forward_launch(*w, x, h0)
    rgh, rdh0 = cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)
    xp = cuda_gru.bwd_xproj(params.w_ih, params.b_ih, x)
    torch.testing.assert_close(
        xp, cuda_gru.xproj_plain(params.w_ih, params.b_ih, x), rtol=1e-5,
        atol=1e-5)
    ops, outs_c, douts_c = cuda_gru._bwd_operands(*w, x, h0, outs, douts,
                                                  "douts")
    limits = cuda_gru.device_limits(cuda_device)
    ran = 0
    for bt in cuda_gru.WIDE_TILES:
        if cuda_gru.wide_blocks_per_sm(bt, hidden, limits) < 1:
            continue
        gh, dh0 = cuda_gru._chain_buffers(ops)
        cuda_gru._chain_kernel(ops, w, outs_c, douts_c, gh, dh0, bt, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(gh, rgh, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(dh0, rdh0, rtol=1e-3, atol=1e-4)
        torch.testing.assert_close(gh, rgh, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(dh0, rdh0, rtol=1e-5, atol=2e-5)
        ran += 1
    assert ran >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [128, 130])
def test_wide_forward_variants_match_plain_on_card(cuda_device, hidden):
    """Every tile of the wide forward (``cuda_gru.wide_fwd_blocks_per_sm``
    > 0), launched directly on a ragged batch of 37 with a per-head input,
    against the plain forward (1e-5 absolute), bitwise repeatable; and at
    hidden 130 (160 units) the wide chain's gate gradients against its
    plain phase (rtol 1e-5, atol 2e-5)."""
    g = torch.Generator().manual_seed(14)
    p, b, t, d = 2, 37, 6, 40
    params = _params_on(p, d, hidden, 15, cuda_device)
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    x = torch.randn((p, b, t, d), generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden), generator=g).to(cuda_device)
    douts = torch.randn((p, b, t, hidden), generator=g).to(cuda_device)
    ref, _ = cuda_gru.fused_gru_scan_heads_plain(params, x, h0)
    ops = cuda_gru._operands(*w, x, h0)
    limits = cuda_gru.device_limits(cuda_device)
    ran = 0
    for bt in cuda_gru.WIDE_TILES:
        if cuda_gru.wide_fwd_blocks_per_sm(bt, hidden, limits) < 1:
            continue
        outs = torch.empty_like(ref)
        again = torch.empty_like(ref)
        cuda_gru._forward_kernel(ops, w, outs, bt, True)
        cuda_gru._forward_kernel(ops, w, again, bt, True)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs, ref, rtol=0, atol=1e-5)
        assert torch.equal(outs, again)
        ran += 1
    assert ran >= 2
    assert cuda_gru.recurrence_route(p, b, d, hidden, limits) == "wide"
    outs = cuda_gru._forward_launch(*w, x, h0)
    gh, dh0 = cuda_gru.bwd_chain(*w, x, h0, outs, douts)
    rgh, rdh0 = cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)
    torch.testing.assert_close(gh, rgh, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(dh0, rdh0, rtol=1e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("per_head", [False, True], ids=["shared", "per_head"])
def test_gru_backward_phases_match_plain_on_card(cuda_device, per_head):
    """B2's two kernels against their plain phases on the card (the chain's
    gh and dh0; the weight-gradient kernel's dx, dW, db from the plain gh),
    ragged batch of 37; two whole B2 calls give bitwise-equal gradients.
    Tolerance rtol 1e-3, atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(4)
    p, b, t, d, hidden = 5, 37, 7, 6, 16
    params = _params_on(p, d, hidden, 5, cuda_device)
    w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
    x = torch.randn((p, b, t, d) if per_head else (b, t, d),
                    generator=g).to(cuda_device)
    h0 = torch.randn((p, b, hidden), generator=g).to(cuda_device)
    douts = torch.randn((p, b, t, hidden), generator=g).to(cuda_device)
    outs = cuda_gru._forward_launch(*w, x, h0)
    gh, dh0 = cuda_gru.bwd_chain(*w, x, h0, outs, douts)
    rgh, rdh0 = cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)
    got = cuda_gru.bwd_wgrad(*w, x, h0, outs, rgh, True)
    ref = cuda_gru.bwd_wgrad_plain(*w, x, h0, outs, rgh, True)
    first = cuda_gru._backward_launch(*w, x, h0, outs, douts, need_dx=True)
    second = cuda_gru._backward_launch(*w, x, h0, outs, douts, need_dx=True)
    torch.cuda.synchronize()
    for a, r in [(gh, rgh), (dh0, rdh0), *zip(got, ref)]:
        torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)
    assert all(torch.equal(u, v) for u, v in zip(first, second))


@pytest.mark.cuda
def test_phase1_step_kernel_matches_plain_on_card(cuda_device):
    """B3 against its plain version on the card, ragged batch, random
    parents mask, lam and ridge > 0; two calls give bitwise-equal params
    and metrics.  Tolerance rtol 1e-3, atol 1e-4."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    p, hidden, e, t, b = 5, 16, 4, 9, 37
    model = CRVAE(p, hidden, e)
    params = model.init(g, cuda_device)
    cfg = Phase1Config(lam=0.05, lr=0.03, lam_ridge=0.01, beta=0.1)
    parents = (torch.rand((p, p), generator=g) > 0.4).float().to(cuda_device)
    batch = torch.randn((b, t, p), generator=g).to(cuda_device)
    eps = torch.randn((b, hidden), generator=g).to(cuda_device)
    new, met = cuda_step.fused_phase1_step(model, cfg, params, parents,
                                           batch, eps)
    ref, rmet = cuda_step.fused_phase1_step_plain(model, cfg, params, parents,
                                                  batch, eps)
    again, amet = cuda_step.fused_phase1_step(model, cfg, params, parents,
                                              batch, eps)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in
               zip(tree_leaves(new) + list(met.values()),
                   tree_leaves(again) + list(amet.values())))
    for a, r in zip(tree_leaves(new), tree_leaves(ref)):
        torch.testing.assert_close(a, r, rtol=1e-3, atol=1e-4)
    for k in cuda_step.METRICS:
        torch.testing.assert_close(met[k], rmet[k], rtol=1e-3, atol=1e-4)


def test_training_entry_points_default_to_cuda(monkeypatch):
    """The training slice's data entry points resolve to ``cuda`` and raise
    without a card unless the caller names the CPU."""
    from vae_connexe_torch.data import lorenz96, lorenz96_truth

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lorenz96(g, p=4, t=8, burn_in=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lorenz96_truth(4)
    assert lorenz96(g, p=4, t=8, burn_in=2, device="cpu").device.type == "cpu"
    assert lorenz96_truth(4, "cpu").sum() == 16


def test_phase2_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """run_experiment, fit_phase2 (through its models' init) and the
    command line resolve to ``cuda`` and raise without a card unless the
    caller names the CPU."""
    from vae_connexe_torch import cli
    from vae_connexe_torch.configs import run_experiment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_experiment("lorenz96_crvae", verbose=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ErrorVAE(3, 4).init(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["run", "lorenz96_crvae", "--iters", "1", "--quiet"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["export", "lorenz96_crvae", str(tmp_path / "ck"), "--out",
                  str(tmp_path / "g")])


@pytest.mark.cuda
def test_phase2_step_matches_plain_on_card(cuda_device):
    """Five phase-2 steps on the card (B1/B2 for all four recurrences)
    against the same steps on the CPU's plain recurrences, on the same
    draws, with a random parents mask: params, ErrorVAE params, Adam's
    state and the metrics rtol 1e-4, atol 1e-6; two card runs bitwise
    equal."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(5)
    p, hidden, ctx, b = 6, 16, 12, 37
    model, err = CRVAE(p, hidden), ErrorVAE(p, hidden)
    params = model.init(g, "cpu")
    eparams = err.init(g, "cpu")
    parents = (torch.rand((p, p), generator=g) > 0.4).float()
    windows = torch.randn((60, ctx, p), generator=g)
    draws = [(torch.randint(0, 60, (b,), generator=g),
              torch.randn((b, hidden), generator=g),
              torch.randn((b, hidden), generator=g)) for _ in range(5)]
    cfg = Phase2Config(batch_size=b, lr_error=1e-2, lam_ridge=0.01)

    def run(dev):
        to = lambda t: t.to(dev)   # noqa: E731
        from vae_connexe_torch.utils.tree import tree_map
        ps, es = tree_map(to, params), tree_map(to, eparams)
        step = make_phase2_step(model, err, cfg, to(windows), to(parents))
        state = Phase2State(params=ps, err_params=es, err_opt=adam_init(es),
                            prior=None, best_params=ps,
                            best_loss=torch.tensor(float("inf"), device=dev),
                            generator=torch.Generator(), step=0)
        for idx, eps, eps_err in draws:
            state, met = step(state, batch=to(windows[idx]), eps=to(eps),
                              eps_err=to(eps_err))
        leaves = (tree_leaves(state.params) + tree_leaves(state.err_params)
                  + tree_leaves(state.err_opt.mu) + tree_leaves(state.err_opt.nu)
                  + list(met.values()))
        return [t.cpu() for t in leaves]

    cuda_gru.reset_launches()
    got, again = run(cuda_device), run(cuda_device)
    assert cuda_gru.LAUNCHES["gru_forward"] == 2 * 5 * 4
    assert cuda_gru.LAUNCHES["gru_backward"] == 2 * 5 * 4
    ref = run(torch.device("cpu"))
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-6)


def test_a4_entry_points_default_to_cuda(monkeypatch):
    """The GMM prior, the MixtureCSRAE, the VRAE and its cells, and the
    commands that run them resolve to ``cuda`` and raise without a card
    unless the caller names the CPU."""
    from vae_connexe_torch import cli
    from vae_connexe_torch.models import VRAE, MixtureCSRAE, init_gmm_prior
    from vae_connexe_torch.ops import init_lstm_cell, init_rnn_cell

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    for make in (lambda: init_gmm_prior(g, 3, 4),
                 lambda: MixtureCSRAE(6, (5,), 2, 3).init(g),
                 lambda: VRAE(3, 4, 2, "lstm").init(g),
                 lambda: init_rnn_cell(g, 3, 4),
                 lambda: init_lstm_cell(g, 3, 4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    for name in ("lorenz96_crcsrae", "csrae_binarized", "vrae_demo"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli.main(["run", name, "--iters", "1", "--quiet"])
    assert init_gmm_prior(g, 3, 4, device="cpu").mu.device.type == "cpu"


def test_discovery_entry_points_default_to_cuda(monkeypatch):
    """discover, the sweep's generators and the two commands resolve to
    ``cuda`` and raise without a card unless the caller names the CPU."""
    import numpy as np

    from vae_connexe_torch import cli, discover
    from vae_connexe_torch.parallel import seed_generators

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    series = np.zeros((40, 3), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        discover(series, context=10, max_iter=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        seed_generators(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["sweep", "--iters", "1"])
    assert seed_generators(0, "cpu")["run"].device.type == "cpu"


@pytest.mark.cuda
def test_sweep_matches_plain_on_card(cuda_device):
    """Five sweep steps of S=3 seeds on the card (the encoder one 3-head and
    the decoder one 18-head B1/B2 launch a step) against the same steps on
    the CPU's plain recurrences, on the same draws, with a random parents
    mask: params, best params, best loss and metrics rtol 1e-4, atol 1e-6;
    two card runs bitwise equal."""
    from vae_connexe_torch.parallel import make_sweep_step
    from vae_connexe_torch.parallel.seed_sweep import init_sweep_state
    from vae_connexe_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(6)
    s, p, hidden, ctx, b, steps = 3, 6, 16, 12, 37, 5
    model = CRVAE(p, hidden)
    parents = (torch.rand((p, p), generator=g) > 0.4).float()
    windows = torch.randn((60, ctx, p), generator=g)
    draws = [(torch.randint(0, 60, (s, b), generator=g),
              torch.randn((s, b, hidden), generator=g)) for _ in range(steps)]
    cfg = Phase1Config(batch_size=b, lam=0.05, lam_ridge=0.01)
    state0 = init_sweep_state(model, [0, 1, 2], "cpu")

    def run(dev):
        to = lambda t: t.to(dev)   # noqa: E731
        step = make_sweep_step(model, cfg, to(windows), to(parents))
        state = init_sweep_state(model, [0, 1, 2], dev)
        state.params = state.best_params = tree_map(to, state0.params)
        for idx, eps in draws:
            state, met = step(state, to(idx), to(eps))
        leaves = (tree_leaves(state.params) + tree_leaves(state.best_params)
                  + [state.best_loss] + list(met.values()))
        return [t.cpu() for t in leaves]

    cuda_gru.reset_launches()
    got, again = run(cuda_device), run(cuda_device)
    assert cuda_gru.LAUNCHES == {"gru_forward": 2 * 2 * steps,
                                 "gru_backward": 2 * 2 * steps,
                                 "gru_forward_wide": 0,
                                 "gru_backward_wide": 0}
    ref = run(torch.device("cpu"))
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=1e-4, atol=1e-6)
