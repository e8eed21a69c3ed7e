"""Multi-process runs of the port (``parallel/multiprocess.py``,
``parallel/multihost.py``): ranks as OS processes over one global mesh.

Each launch starts gloo CPU ranks on loopback, one process a rank
(``devices_per_process`` ranks a "host"), every rank joining the group
with ``initialize_multihost`` and building the same global (dp, ep) mesh.
Held against the single-process port, at the JAX package's tolerances
(``tests/test_multiprocess.py``): the synthetic meshed fit, the named
experiment through phase 1, the GC handoff and phase 2 (params and
metrics; the GC matrix exactly), a killed and resumed worker set (equal to
the uninterrupted multi-process run), the ``dryrun_multichip`` analog, and
a rank that fails alone ending the whole group at once.

On the CPU these runs check the launch, the group and gloo; NCCL groups
across several cards cannot be checked on a machine with one card.
"""

import dataclasses
import sys
import time
import unittest.mock

import numpy as np
import pytest
import torch

from vae_connexe_torch.configs import get_experiment, run_experiment
from vae_connexe_torch.models import CRVAE, ErrorVAE
from vae_connexe_torch.parallel.multiprocess import (
    dryrun_multichip,
    fit_inputs,
    launch_multiprocess_experiment,
    launch_multiprocess_fit,
)
from vae_connexe_torch.train import fit_phase1
from vae_connexe_torch.utils import load_gc, restore_checkpoint
from vae_connexe_torch.utils.tree import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

PAYLOAD = dict(p=4, hidden=16, ctx=12, enc_len=6, n_windows=64,
               batch_size=8, max_iter=24, check_every=8, lam=0.1, lr=5e-2,
               data_seed=5, init_seed=6, fit_seed=7)
OV_MP = {"t": 128,
         "phase1": {"max_iter": 8, "check_every": 4, "batch_size": 16},
         "phase2": {"max_iter": 6, "check_every": 3, "batch_size": 16}}


def test_multiprocess_fit_equals_single_process():
    """A (dp, ep) = (2, 2) fit run by two "hosts" of two ranks each equals
    the single-process fit on the same inputs."""
    leaves, loss, logs = launch_multiprocess_fit(
        num_processes=2, devices_per_process=2, n_ep=2, device="cpu",
        timeout=120, **PAYLOAD)
    for r, log in enumerate(logs):
        assert f"proc {r // 2}/2 rank {r}:" in log, log
        assert "(1 local / 4 global devices)" in log, log
        assert "backend gloo on cpu" in log, log
    model, params, windows, parents, cfg, gen = fit_inputs(PAYLOAD, "cpu")
    best, _, metrics = fit_phase1(model, params, windows, parents, cfg, gen)
    assert np.isclose(loss, metrics["loss"], rtol=1e-4)
    want = tree_leaves(best)
    assert len(leaves) == len(want)
    for a, b in zip(leaves, want):
        np.testing.assert_allclose(a, b.numpy(), atol=1e-4)


@pytest.fixture(scope="module")
def mp_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("mp")
    results, arrays, logs = launch_multiprocess_experiment(
        "lorenz96_crvae", num_processes=2, n_ep=2, seed=0, overrides=OV_MP,
        out_dir=str(out), device="cpu", timeout=120)
    return out, results, arrays, logs


def test_multiprocess_experiment_equals_single_process(mp_run, tmp_path):
    """``cli run lorenz96_crvae --processes 2 --ep 2``'s backend against
    ``run_experiment`` in one process with the same seed: the metrics, the
    params of both phases and the binary GC matrix."""
    out, results, arrays, logs = mp_run
    for r, log in enumerate(logs):
        assert f"proc {r}/2 rank {r}:" in log, log
    exp = get_experiment("lorenz96_crvae")
    ov = {"t": OV_MP["t"],
          "phase1": dataclasses.replace(exp.phase1, **OV_MP["phase1"]),
          "phase2": dataclasses.replace(exp.phase2, **OV_MP["phase2"])}
    sp = tmp_path / "sp"
    # The figures (t-SNE fits, seconds each) are left out, as on a machine
    # without matplotlib.
    with unittest.mock.patch.dict(sys.modules, {"matplotlib": None}):
        r_sp = run_experiment("lorenz96_crvae", seed=0, out_dir=str(sp),
                              overrides=ov, save_checkpoints=True,
                              verbose=False, device="cpu")
    assert results["mesh"] == {"dp": 1, "ep": 2}
    for phase in ("phase1", "phase2"):
        assert results[phase].keys() == r_sp[phase].keys()
        for k in results[phase]:
            assert np.isclose(results[phase][k], r_sp[phase][k], rtol=1e-3,
                              atol=1e-5), (phase, k)
    for k in results["gc"]:
        assert np.isclose(results["gc"][k], r_sp["gc"][k], atol=1e-6), k
    model = CRVAE(p=exp.p, hidden=exp.hidden)
    err = ErrorVAE(d=exp.p, hidden=exp.hidden)
    tmpl = model.init(torch.Generator(), "cpu")
    best = restore_checkpoint(str(sp / "ckpt_phase1"), tmpl)
    for i, leaf in enumerate(tree_leaves(best)):
        np.testing.assert_allclose(arrays[f"p1_{i}"], leaf.numpy(),
                                   atol=1e-4)
    ck2 = restore_checkpoint(str(sp / "ckpt_phase2"),
                             {"crvae": tmpl,
                              "error_vae": err.init(torch.Generator(),
                                                    "cpu")})
    for i, leaf in enumerate(tree_leaves(ck2["crvae"])):
        np.testing.assert_allclose(arrays[f"p2_{i}"], leaf.numpy(),
                                   atol=1e-4)
    for i, leaf in enumerate(tree_leaves(ck2["error_vae"])):
        np.testing.assert_allclose(arrays[f"err_{i}"], leaf.numpy(),
                                   atol=1e-4)
    np.testing.assert_array_equal(np.load(out / "GC_lorenz96_crvae.npy"),
                                  load_gc(str(sp / "ckpt_phase1")))


def test_multiprocess_experiment_kill_resume(mp_run, tmp_path):
    """Every rank killed after the step-4 snapshot of phase 1 (rank 0 wrote
    the gathered state), the set relaunched with ``resume=True``: the
    uninterrupted multi-process run, exactly."""
    _, want, want_arrays, _ = mp_run
    kw = dict(num_processes=2, n_ep=2, seed=0, overrides=OV_MP,
              out_dir=str(tmp_path / "kr"), checkpoint_every=4,
              device="cpu", timeout=120)
    with pytest.raises(RuntimeError, match="kill_at"):
        launch_multiprocess_experiment("lorenz96_crvae",
                                       kill_at={"phase1": 4}, **kw)
    assert (tmp_path / "kr" / "ckpt_mid_phase1" / "LATEST").read_text() == "4"
    got, arrays, _ = launch_multiprocess_experiment("lorenz96_crvae",
                                                    resume=True, **kw)
    assert got["phase1"] == want["phase1"]
    assert got["phase2"] == want["phase2"]
    assert arrays.keys() == want_arrays.keys()
    for k in arrays:
        np.testing.assert_array_equal(arrays[k], want_arrays[k])


def test_dryrun_multichip_and_a_failing_rank(tmp_path):
    """The ``dryrun_multichip`` analog runs one sharded step on a two-rank
    mesh; a rank that fails alone ends the group at once: the other rank's
    next collective fails and the launcher raises with both logs, long
    before the group's timeout."""
    logs = dryrun_multichip(2, device="cpu", timeout=60)
    assert all("dryrun_multichip OK" in log for log in logs), logs
    assert "mesh={'dp': 1, 'ep': 2}" in logs[0]
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="multiprocess run failed") as e:
        launch_multiprocess_experiment(
            "lorenz96_crvae", num_processes=2, n_ep=2, overrides=OV_MP,
            out_dir=str(tmp_path / "fail"), checkpoint_every=4,
            kill_at={"phase1": 4}, kill_ranks=[1], device="cpu",
            timeout=120)
    assert time.monotonic() - t0 < 60
    assert "kill_at[phase1]=4 reached" in str(e.value)
