"""Checkpoints and resume in the port: a killed and resumed fit equals the
uninterrupted one bitwise, for both phases (the port's counterparts of
``tests/test_resume.py``'s single-device cases).

``fit_phase1/2(checkpoint_dir=..., checkpoint_every=N, resume=True)``
snapshot the whole phase state, the generator's state included, at chunk
boundaries and run only the remaining chunks.  A kill is an exception
raised from the per-chunk callback, after that boundary's snapshot.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vae_connexe_torch.data import arrange_input, lorenz96
from vae_connexe_torch.models import CRVAE, ErrorVAE
from vae_connexe_torch.optim import adam_init
from vae_connexe_torch.train import (
    Phase1Config,
    Phase2Config,
    Phase2State,
    fit_phase1,
    fit_phase2,
)
from vae_connexe_torch.utils import (
    TrainCheckpointer,
    load_gc,
    restore_checkpoint,
    save_checkpoint,
)
from vae_connexe_torch.utils.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

P, CTX = 5, 12


class _Kill(Exception):
    """Stands in for SIGKILL."""


def _killer(at_step):
    def cb(step, state, metrics):
        if step >= at_step:
            raise _Kill
    return cb


@pytest.fixture(scope="module")
def setup():
    series = lorenz96(torch.Generator().manual_seed(0), p=P, t=200,
                      burn_in=100, device="cpu")
    windows, _ = arrange_input(series, CTX)
    model = CRVAE(p=P, hidden=12)
    params = model.init(torch.Generator().manual_seed(1), "cpu")
    return windows, model, params, torch.ones((P, P))


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in
               zip(tree_leaves(a), tree_leaves(b)))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("resample", [True, False],
                         ids=["resample", "fixed-batch"])
def test_phase1_kill_resume_bitwise(setup, tmp_path, resample):
    windows, model, params, parents = setup
    cfg = Phase1Config(max_iter=24, check_every=4, batch_size=8, lam=0.1,
                       resample_batches=resample)
    best_u, state_u, m_u = fit_phase1(model, params, windows, parents, cfg,
                                      _gen(2))
    ck = str(tmp_path / "p1")
    with pytest.raises(_Kill):
        fit_phase1(model, params, windows, parents, cfg, _gen(2),
                   checkpoint_dir=ck, checkpoint_every=12,
                   callback=_killer(12))
    assert TrainCheckpointer(ck).latest_step() == 12
    best_r, state_r, m_r = fit_phase1(model, params, windows, parents, cfg,
                                      _gen(2), checkpoint_dir=ck,
                                      checkpoint_every=12, resume=True)
    assert state_r.step == cfg.max_iter
    assert _equal(state_u.params, state_r.params) and _equal(best_u, best_r)
    assert float(state_u.best_loss) == float(state_r.best_loss)
    assert m_u == m_r


def test_phase2_kill_resume_bitwise(setup, tmp_path):
    """The snapshot carries the ErrorVAE and Adam's state too: the resumed
    moments and count equal the uninterrupted run's."""
    windows, model, params, parents = setup
    err_model = ErrorVAE(d=P, hidden=12)
    err_params = err_model.init(_gen(3), "cpu")
    mask = (torch.rand((P, P), generator=_gen(8)) > 0.3).float()
    cfg = Phase2Config(max_iter=18, check_every=3, batch_size=8)
    args = (model, err_model, params, err_params, windows, mask, cfg)
    best_u, err_u, state_u, m_u = fit_phase2(*args, _gen(4))
    ck = str(tmp_path / "p2")
    with pytest.raises(_Kill):
        fit_phase2(*args, _gen(4), checkpoint_dir=ck, checkpoint_every=9,
                   callback=_killer(9))
    best_r, err_r, state_r, m_r = fit_phase2(*args, _gen(4),
                                             checkpoint_dir=ck,
                                             checkpoint_every=9, resume=True)
    assert _equal(best_u, best_r) and _equal(err_u, err_r)
    assert _equal(state_u.err_opt, state_r.err_opt)
    assert int(state_r.err_opt.count) == 18
    assert m_u == m_r


def test_resume_completed_phase_is_pure_restore(setup, tmp_path):
    windows, model, params, parents = setup
    cfg = Phase1Config(max_iter=8, check_every=4, batch_size=8, lam=0.1)
    ck = str(tmp_path / "done")
    best_a, _, m_a = fit_phase1(model, params, windows, parents, cfg, _gen(5),
                                checkpoint_dir=ck)
    calls = []
    best_b, _, m_b = fit_phase1(model, params, windows, parents, cfg, _gen(5),
                                checkpoint_dir=ck, resume=True,
                                callback=lambda *a: calls.append(a))
    assert calls == []
    assert _equal(best_a, best_b)
    assert m_a == m_b


def test_resume_rejects_changed_chunking(setup, tmp_path):
    windows, model, params, parents = setup
    cfg = Phase1Config(max_iter=12, check_every=4, batch_size=8, lam=0.1)
    ck = str(tmp_path / "mis")
    with pytest.raises(_Kill):
        fit_phase1(model, params, windows, parents, cfg, _gen(6),
                   checkpoint_dir=ck, checkpoint_every=4,
                   callback=_killer(4))
    bad = dataclasses.replace(cfg, check_every=3)
    with pytest.raises(ValueError, match="chunk boundary"):
        fit_phase1(model, params, windows, parents, bad, _gen(6),
                   checkpoint_dir=ck, resume=True)


def test_checkpoint_round_trip(setup, tmp_path):
    """A phase-2 state with a generator and a GC companion goes through
    save_checkpoint / restore_checkpoint / load_gc unchanged; the
    generator continues its stream from the saved point; a wrong shape or
    key raises."""
    _, model, params, _ = setup
    err_model = ErrorVAE(d=P, hidden=6)
    eparams = err_model.init(_gen(1), "cpu")
    g = _gen(11)
    torch.randn(3, generator=g)
    state = Phase2State(params=params, err_params=eparams,
                        err_opt=adam_init(eparams), prior=None,
                        best_params=params,
                        best_loss=torch.tensor(0.5), generator=g, step=7)
    gc = np.eye(P, dtype=np.int32)
    path = str(tmp_path / "ck" / "state")
    save_checkpoint(path, state, gc_matrix=gc)
    want = torch.randn(4, generator=g)
    template = Phase2State(
        params=model.init(_gen(2), "cpu"), err_params=err_model.init(_gen(3), "cpu"),
        err_opt=adam_init(eparams), prior=None,
        best_params=model.init(_gen(4), "cpu"),
        best_loss=torch.tensor(0.0), generator=_gen(0), step=0)
    back = restore_checkpoint(path, template)
    assert back.step == 7 and float(back.best_loss) == 0.5
    assert _equal(back.params, params) and _equal(back.err_params, eparams)
    assert torch.equal(torch.randn(4, generator=back.generator), want)
    np.testing.assert_array_equal(load_gc(path), gc)
    with pytest.raises(KeyError):
        restore_checkpoint(path, {"params": params})
    other = ErrorVAE(d=P, hidden=7).init(_gen(0), "cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, dataclasses.replace(template,
                                                     err_params=other))


def test_checkpointer_marker_and_pruning(tmp_path):
    """Saves land every ``every`` steps and at the final step; only the
    latest snapshot is kept, named by the LATEST marker."""
    @dataclasses.dataclass
    class S:
        w: torch.Tensor
        step: int

    ck = TrainCheckpointer(str(tmp_path / "c"), every=5)
    saved = [s for s in (2, 4, 6, 8, 10, 11)
             if ck.maybe_save(S(torch.full((2,), float(s)), s), {"s": s},
                              final=(s == 11))]
    assert saved == [6, 11]
    assert ck.latest_step() == 11
    assert sorted(p.name for p in ck.dir.iterdir()) == [
        "LATEST", "metrics_11.json", "state_11"]
    state, metrics = TrainCheckpointer(str(ck.dir)).restore(
        S(torch.zeros(2), 0))
    assert state.step == 11 and metrics == {"s": 11}
    assert torch.equal(state.w, torch.full((2,), 11.0))
