"""The port's A4f utilities against the JAX package's: ``minmax_scale``,
the TimeGAN helpers bit for bit, ``StepTimer``, ``trace``, and nan
debugging, under which every training loop raises ``FloatingPointError``
naming the step that made a NaN.

Tolerance: ``minmax_scale`` rtol 1e-6, atol 1e-7 (float32, the same
operations).
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_connexe_torch.data import batch_generator, extract_time, train_test_divide
from vae_connexe_torch.models import CRVAE, VRAE, ErrorVAE, MixtureCSRAE, WInCRVAE
from vae_connexe_torch.train import (
    Phase1Config,
    Phase2Config,
    WInTrainConfig,
    WInTrainer,
    fit_csrae,
    fit_phase1,
    fit_phase2,
    fit_vrae,
)
from vae_connexe_torch.utils import (
    StepTimer,
    enable_nan_debugging,
    minmax_scale,
    nan_debugging,
    trace,
)
from vae_connexe_torch.utils.debug import check_finite, nan_debugging_enabled
from vae_connexe_tpu.data import timegan_utils as jtg
from vae_connexe_tpu.utils.profiling import StepTimer as JStepTimer
from vae_connexe_tpu.utils.scalers import minmax_scale as jminmax
from torch_threads import one_torch_thread  # noqa: F401


def test_minmax_scale_matches_jax():
    x = np.random.default_rng(0).normal(size=(7, 5, 3)).astype(np.float32) * 4
    got = minmax_scale(torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jminmax)(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert got.min() == 0.0 and (got.max(axis=(0, 1)) <= 1.0).all()


def test_timegan_helpers_match_jax_bit_for_bit():
    """Same seed, same split, lengths and batch as the JAX package's."""
    rng = np.random.default_rng(1)
    ori = [rng.normal(size=(int(n), 3)) for n in rng.integers(4, 9, 11)]
    gen = [rng.normal(size=(int(n), 3)) for n in rng.integers(4, 9, 11)]
    t_ori, t_max = extract_time(ori)
    assert (t_ori, t_max) == jtg.extract_time(ori)
    assert extract_time([]) == jtg.extract_time([]) == ([], 0)
    t_gen, _ = extract_time(gen)
    got = train_test_divide(ori, gen, t_ori, t_gen, 0.7, seed=2)
    ref = jtg.train_test_divide(ori, gen, t_ori, t_gen, 0.7, seed=2)
    assert len(got) == len(ref) == 8
    for a, r in zip(got, ref):
        assert len(a) == len(r)
        for u, v in zip(a, r):
            np.testing.assert_array_equal(u, v)
    xs, ts = batch_generator(ori, t_ori, 4, seed=3)
    rxs, rts = jtg.batch_generator(ori, t_ori, 4, seed=3)
    assert ts == rts and all(np.array_equal(u, v) for u, v in zip(xs, rxs))


def test_step_timer_leaves_out_warmup():
    """No rate before the warm-up ends; the warm-up ticks' steps are left
    out, as the JAX package's timer does."""
    for cls in (StepTimer, JStepTimer):
        timer = cls(warmup=2)
        assert np.isnan(timer.steps_per_sec())
        timer.tick(steps=100)
        timer.tick(steps=100)
        assert np.isnan(timer.steps_per_sec())
        time.sleep(0.01)
        timer.tick(steps=5)
        rate = timer.steps_per_sec()
        assert 0 < rate < 5 / 0.01 and timer._steps == 5


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")):
        torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any("matmul" in e.get("name", "") or "dot" in e.get("name", "")
               for e in events["traceEvents"])


def test_nan_debugging_switches_and_restores():
    """The flag and autograd's anomaly mode go on together and come back as
    they were; off, ``check_finite`` lets a NaN through."""
    assert not nan_debugging_enabled() and not torch.is_anomaly_enabled()
    check_finite("x", torch.tensor(float("nan")))
    with nan_debugging():
        assert nan_debugging_enabled() and torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="in x"):
            check_finite("x", {"a": torch.ones(2)}, torch.tensor(float("inf")))
    assert not nan_debugging_enabled() and not torch.is_anomaly_enabled()
    enable_nan_debugging()
    try:
        assert nan_debugging_enabled() and torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not nan_debugging_enabled() and not torch.is_anomaly_enabled()


def _nan_at(x: torch.Tensor, index) -> torch.Tensor:
    """``x`` with NaN at ``index`` (in every window where the fit draws
    batches, so that the first step meets it)."""
    x = x.clone()
    x[index] = float("nan")
    return x


def _crvae_fit(phase):
    g = torch.Generator().manual_seed(0)
    m, e = CRVAE(3, 4, 2), ErrorVAE(3, 4)
    windows = _nan_at(torch.randn((12, 5, 3), generator=g), (slice(None), 3, 1))
    cfg = dict(max_iter=3, check_every=3, batch_size=12)
    if phase == "phase1":
        return lambda: fit_phase1(m, m.init(g, "cpu"), windows,
                                  torch.ones((3, 3)),
                                  Phase1Config(latent_reg="cs", **cfg),
                                  torch.Generator())
    return lambda: fit_phase2(m, e, m.init(g, "cpu"), e.init(g, "cpu"),
                              windows, torch.ones((3, 3)), Phase2Config(**cfg),
                              torch.Generator())


def _win_fit():
    g = torch.Generator().manual_seed(1)
    m = WInCRVAE(d=2, hidden=4, latent=2, tau=3)
    windows = _nan_at(torch.randn((8, 6, 2), generator=g), (slice(None), 1, 0))
    trainer = WInTrainer(m, WInTrainConfig(batch_size=4, stage1_epochs=1,
                                           stage2_epochs=1))
    return lambda: trainer.fit(m.init(g, "cpu"), windows, torch.Generator())


def _csrae_fit():
    g = torch.Generator().manual_seed(2)
    m = MixtureCSRAE(6, (5,), 2, 3)
    data = _nan_at((torch.rand((8, 6), generator=g) > 0.5).float(), (0, 0))
    return lambda: fit_csrae(m, m.init(g, "cpu"), data, torch.Generator(),
                             epochs=1, batch_size=8)


def _vrae_fit():
    g = torch.Generator().manual_seed(3)
    m = VRAE(2, 4, 2)
    data = _nan_at(torch.randn((3, 5, 2), generator=g), (1, 2, 0))
    return lambda: fit_vrae(m, m.init(g, "cpu"), data, torch.Generator(),
                            epochs=2)


@pytest.mark.parametrize("make,where", [
    (lambda: _crvae_fit("phase1"), "phase1 step 1"),
    (lambda: _crvae_fit("phase2"), "phase2 step 1"),
    (_win_fit, "stage1 epoch 0 batch "),
    (_csrae_fit, "csrae epoch 0 batch 0"),
    (_vrae_fit, "vrae epoch 0"),
], ids=["phase1-cs", "phase2", "win", "csrae", "vrae"])
def test_nan_debugging_raises_naming_the_step(make, where):
    """A NaN in the data: without nan debugging the fit runs through;
    under it, the fit raises ``FloatingPointError`` naming its loop and
    step before that step's backward."""
    fit = make()
    fit()
    with nan_debugging():
        with pytest.raises(FloatingPointError, match=f"^{where}.*the loss"):
            fit()
    assert not torch.is_anomaly_enabled()
