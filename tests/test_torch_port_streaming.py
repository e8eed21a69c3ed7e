"""The native window loader and the out-of-core streaming fits, on the CPU.

Mirrors ``tests/test_native_loader.py`` and ``tests/test_streaming.py``:
the port's loader (the same ``native/window_loader.cc``, built into the
port's own ``build/``) gathers what JAX's loader and ``arrange_input``
give, bit for bit; ``fit_phase1_streaming`` / ``fit_phase2_streaming``
equal ``fit_phase1`` / ``fit_phase2`` on the same series and generator bit
for bit, killed and resumed too; ``run_experiment(out_of_core=True)``
equals the in-memory run (``tests/test_torch_port_cli.py`` holds ``cli run
--out-of-core``).  A kill is an exception raised from the per-chunk
callback, after that boundary's snapshot, as in
``tests/test_torch_port_resume.py``.
"""

import shutil

import numpy as np
import pytest
import torch

if shutil.which("g++") is None:
    pytest.skip("no C++ toolchain", allow_module_level=True)

from vae_connexe_torch.configs import get_experiment, run_experiment
from vae_connexe_torch.data import arrange_input, lorenz96, sliding_windows
from vae_connexe_torch.data import native_loader
from vae_connexe_torch.data.native_loader import NativeWindowLoader
from vae_connexe_torch.models import CRVAE, ErrorVAE
from vae_connexe_torch.ops._build import BUILD_DIR
from vae_connexe_torch.train import (
    Phase1Config,
    Phase1State,
    Phase2Config,
    fit_phase1,
    fit_phase1_streaming,
    fit_phase2,
    fit_phase2_streaming,
    make_phase1_step,
)
from vae_connexe_torch.train import streaming
from vae_connexe_torch.utils.tree import tree_leaves
from vae_connexe_tpu.data.native_loader import NativeWindowLoader as JLoader
from torch_threads import one_torch_thread  # noqa: F401

P, CTX = 5, 12


@pytest.fixture(scope="module")
def series():
    return np.random.default_rng(0).normal(size=(2000, P)).astype(np.float32)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A Lorenz-96 series in memory, its windows, a file-backed loader of
    it, a model and its parameters."""
    s = lorenz96(torch.Generator().manual_seed(0), p=P, t=200, burn_in=100,
                 device="cpu")
    windows, _ = arrange_input(s, CTX)
    path = tmp_path_factory.mktemp("series") / "s.f32"
    s.numpy().tofile(path)
    loader = NativeWindowLoader.from_file(str(path), *s.shape)
    model = CRVAE(p=P, hidden=12)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    yield windows, loader, model, params, torch.ones((P, P))
    loader.close()


class _Kill(Exception):
    """Stands in for SIGKILL."""


def _killer(at_step):
    def cb(step, state, metrics):
        if step >= at_step:
            raise _Kill
    return cb


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in
               zip(tree_leaves(a), tree_leaves(b)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_loader_matches_jax_loader_and_arrange_input(series, tmp_path):
    """gather, gather_shifted, standardize and num_windows equal JAX's
    loader's on the same file, and the windows equal arrange_input's and
    sliding_windows'; ``out=`` fills a caller's buffer."""
    path = tmp_path / "s.f32"
    series.tofile(path)
    idx = np.array([0, 7, 1979, 3], np.int64)
    with NativeWindowLoader.from_file(str(path), *series.shape) as got, \
            JLoader.from_file(str(path), *series.shape) as want:
        for ctx, shifted in ((20, False), (20, True), (2000, False)):
            assert got.num_windows(ctx, shifted) == want.num_windows(
                ctx, shifted)
        np.testing.assert_array_equal(got.gather(idx, 20),
                                      want.gather(idx, 20))
        for a, b in zip(got.gather_shifted(idx, 15),
                        want.gather_shifted(idx, 15)):
            np.testing.assert_array_equal(a, b)
        inputs, targets = arrange_input(torch.from_numpy(series), 15)
        np.testing.assert_array_equal(got.gather_shifted(idx, 15)[0],
                                      inputs[idx].numpy())
        np.testing.assert_array_equal(got.gather_shifted(idx, 15)[1],
                                      targets[idx].numpy())
        last = got.num_windows(20) - 1
        np.testing.assert_array_equal(
            got.gather(np.array([last]), 20)[0],
            sliding_windows(torch.from_numpy(series), 20)[last].numpy())
        buf = np.zeros((4, 20, P), np.float32)
        assert got.gather(idx, 20, out=buf) is buf
        np.testing.assert_array_equal(buf, want.gather(idx, 20))
        with pytest.raises(ValueError, match="out must be"):
            got.gather(idx, 20, out=np.zeros((4, 19, P), np.float32))
        got.standardize()
        want.standardize()
        np.testing.assert_array_equal(got.gather(np.zeros(1, np.int64), 2000),
                                      want.gather(np.zeros(1, np.int64), 2000))
    with NativeWindowLoader.from_array(series) as loader:
        with pytest.raises(IndexError):
            loader.gather(np.array([series.shape[0] - 5], np.int64), 20)
        with pytest.raises(IndexError):
            loader.gather_shifted(np.array([series.shape[0] - 20]), 20)
        b = loader.sample_batch(np.random.default_rng(1), 17, 9)
        assert b.shape == (17, 9, P) and np.isfinite(b).all()
    short = tmp_path / "short.f32"
    short.write_bytes(bytes(16))
    with pytest.raises(OSError):
        NativeWindowLoader.from_file(str(short), 100, P)


def test_loader_builds_into_the_ports_build_dir(tmp_path, monkeypatch):
    """The library is named by a hash of native/window_loader.cc and the
    flags, under the package's build/ (never native/, JAX's)."""
    path = native_loader.library_path()
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("libwindow_loader-")
    edited = tmp_path / "window_loader.cc"
    edited.write_bytes(native_loader.SOURCE.read_bytes() + b"\n// edited\n")
    monkeypatch.setattr(native_loader, "SOURCE", edited)
    assert native_loader.library_path() != path


def test_stream_step_draws_what_the_in_memory_step_draws(setup):
    """A streamed step, fed the batch the host mirror says the in-memory
    step gathers, is that step bit for bit and leaves the generator where
    it does; ``_index_chunk`` replays the indices without touching it."""
    windows, _, model, params, parents = setup
    cfg = Phase1Config(batch_size=8, lam=0.1)
    mem = make_phase1_step(model, cfg, windows, parents)
    streamed = make_phase1_step(model, cfg, None, parents, stream=True,
                                n_windows=windows.shape[0])
    g_mem, g_str = _gen(3), _gen(3)
    mirror = _gen(3)
    idx = streaming._index_chunk(mirror, 2, 8, windows.shape[0],
                                 [(8, model.hidden)])
    s_mem = s_str = None
    for t in range(2):
        s_mem = mem(s_mem or Phase1State(params, None, params,
                                         torch.tensor(float("inf")),
                                         g_mem, 0))[0]
        s_str = streamed(s_str or Phase1State(params, None, params,
                                              torch.tensor(float("inf")),
                                              g_str, 0),
                         windows[torch.from_numpy(idx[t])])[0]
        assert _equal(s_mem.params, s_str.params)
    assert torch.equal(g_mem.get_state(), g_str.get_state())
    assert torch.equal(mirror.get_state(), g_mem.get_state())
    with pytest.raises(ValueError, match="takes its batch"):
        streamed(s_str)
    with pytest.raises(ValueError, match="n_windows"):
        make_phase1_step(model, cfg, None, parents, stream=True)


@pytest.mark.parametrize("case", ["resample", "fixed-batch", "cs"])
def test_phase1_streaming_bitwise(setup, case):
    """In IO sub-chunks of 3 steps (chunks of 4): ``io_stats`` counts them."""
    windows, loader, model, params, parents = setup
    cfg = Phase1Config(max_iter=10, check_every=4, batch_size=8, lam=0.1,
                       resample_batches=case != "fixed-batch",
                       latent_reg="cs" if case == "cs" else "kl",
                       gmm_components=3)
    best_m, state_m, m_m = fit_phase1(model, params, windows, parents, cfg,
                                      _gen(2))
    stats = {}
    best_s, state_s, m_s = fit_phase1_streaming(
        model, params, loader, CTX, parents, cfg, _gen(2),
        io_budget_bytes=3 * 8 * CTX * P * 4, io_stats=stats)
    assert _equal(best_m, best_s) and _equal(state_m.params, state_s.params)
    assert _equal(state_m.prior, state_s.prior) and m_m == m_s
    assert torch.equal(state_m.generator.get_state(),
                       state_s.generator.get_state())
    assert stats["chunks"] == (0 if case == "fixed-batch" else 4 + 1)
    assert stats["gather_wait_s"] >= 0.0


def test_phase2_streaming_bitwise(setup):
    windows, loader, model, params, parents = setup
    err = ErrorVAE(d=P, hidden=8)
    ep = err.init(_gen(4), "cpu")
    cfg = Phase2Config(max_iter=7, check_every=3, batch_size=8)
    mem = fit_phase2(model, err, params, ep, windows, parents, cfg, _gen(5))
    stats = {}
    got = fit_phase2_streaming(model, err, params, ep, loader, CTX, parents,
                               cfg, _gen(5), io_stats=stats)
    assert _equal((mem[0], mem[1]), (got[0], got[1])) and mem[3] == got[3]
    assert _equal(mem[2].err_opt, got[2].err_opt)
    assert stats["chunks"] == 3


@pytest.mark.parametrize("phase", [1, 2])
def test_streaming_kill_resume_bitwise(setup, tmp_path, phase):
    """Killed after a snapshot and resumed, the streamed fit equals the
    uninterrupted one (the host mirror restarts from the restored
    generator)."""
    windows, loader, model, params, parents = setup
    ck = str(tmp_path / "ck")
    if phase == 1:
        cfg = Phase1Config(max_iter=12, check_every=3, batch_size=8, lam=0.1)

        def fit(**kw):
            return fit_phase1_streaming(model, params, loader, CTX, parents,
                                        cfg, _gen(2), **kw)
    else:
        err = ErrorVAE(d=P, hidden=8)
        ep = err.init(_gen(4), "cpu")
        cfg = Phase2Config(max_iter=12, check_every=3, batch_size=8)

        def fit(**kw):
            return fit_phase2_streaming(model, err, params, ep, loader, CTX,
                                        parents, cfg, _gen(5), **kw)
    whole = fit()
    with pytest.raises(_Kill):
        fit(checkpoint_dir=ck, checkpoint_every=6, callback=_killer(7))
    resumed = fit(checkpoint_dir=ck, checkpoint_every=6, resume=True)
    assert _equal(whole[:-2], resumed[:-2])
    assert whole[-1] == resumed[-1]
    assert _equal(whole[-2].params, resumed[-2].params)


def test_run_experiment_out_of_core_matches_in_memory(tmp_path):
    """Phase 1 of lorenz96_crvae cut to 6 steps: the streamed run's results
    are the in-memory run's, and its series file is the run's series."""
    exp = get_experiment("lorenz96_crvae")
    over = {"phase1": Phase1Config(**{**exp.phase1.__dict__,
                                      "max_iter": 6, "check_every": 4})}
    kw = dict(overrides=over, run_phase2=False, verbose=False, device="cpu")
    mem = run_experiment("lorenz96_crvae", **kw)
    ooc = run_experiment("lorenz96_crvae", out_of_core=True,
                         out_dir=str(tmp_path), **kw)
    assert ooc == mem
    assert (tmp_path / "series_lorenz96_crvae.f32").stat().st_size == \
        exp.t * exp.p * 4
