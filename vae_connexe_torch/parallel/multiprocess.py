"""Multi-process runs: meshed training across OS processes (port of
``vae_connexe_tpu/parallel/multiprocess.py``).

JAX runs one controller process per host, each seeing the global device
set.  PyTorch runs one process per device: ``num_processes`` hosts times
``devices_per_process`` devices make that many ranks of one group, each
joining it with ``parallel/multihost.py::initialize_multihost`` and
building the same global mesh (``parallel/mesh.py::make_mesh``).  The
launchers here start every rank of one host as an OS process; on a real
multi-host run the worker body runs unchanged, one ``python -m
vae_connexe_torch.parallel.multiprocess '<payload json>'`` (or
``torchrun``) per rank.

Worker bodies:

- ``_worker_payload_fit``: a multi-chunk meshed ``fit_phase1`` on
  synthetic data drawn from the payload's seeds (``fit_inputs``), held
  against the single-process fit on the same inputs;
- ``_worker_payload_experiment``: a named crvae experiment through phase
  1, the GC handoff and phase 2, with ``run_experiment``'s generators
  (``utils/seeding.py::role_generators``), so it is comparable params for
  params to the single-process ``cli run``; checkpoints and resume compose
  (rank 0 writes the gathered state, every rank restores it; a killed
  worker set relaunched with ``resume=True`` equals the uninterrupted
  run); ``cli run <exp> --processes N``;
- ``_worker_payload_dryrun``: one full sharded phase-1 step on an n-rank
  (dp, ep) mesh (``dryrun_multichip``).

Ranks run on the card unless the payload names the CPU (``force_cpu``).
A rank that fails prints its traceback and exits non-zero; the launcher
then stops the other ranks at once and raises with every rank's log, and
every collective carries the group's timeout, so no rank waits past it.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import traceback

from vae_connexe_torch.parallel.mesh import _free_port


def fit_inputs(payload: dict, device):
    """(model, params, windows, parents, cfg, generator) of the synthetic
    fit a payload describes: windows N(0, 1) from a CPU generator seeded
    ``data_seed``, the init from ``init_seed``, the fit's generator on
    ``device`` seeded ``fit_seed``.  The single-process fit it is held
    against builds the same."""
    import torch

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.train.config import Phase1Config

    p = payload["p"]
    model = CRVAE(p=p, hidden=payload["hidden"], enc_len=payload["enc_len"])
    cfg = Phase1Config(lam=payload["lam"], lr=payload["lr"],
                       batch_size=payload["batch_size"],
                       max_iter=payload["max_iter"],
                       check_every=payload["check_every"])
    g = torch.Generator().manual_seed(payload["data_seed"])
    windows = torch.randn((payload["n_windows"], payload["ctx"], p),
                          generator=g).to(device)
    params = model.init(torch.Generator().manual_seed(payload["init_seed"]),
                        device)
    parents = torch.ones((p, p), device=device)
    gen = torch.Generator(device=device).manual_seed(payload["fit_seed"])
    return model, params, windows, parents, cfg, gen


def _leaves_np(tree) -> list:
    from vae_connexe_torch.utils.tree import tree_leaves

    return [x.detach().cpu().numpy() for x in tree_leaves(tree)]


def _where(mesh) -> str:
    import torch.distributed as dist

    from vae_connexe_torch.parallel.mesh import mesh_shape

    return (f"over mesh={mesh_shape(mesh)} (1 local / "
            f"{dist.get_world_size()} global devices)")


def _worker_payload_fit(payload: dict) -> None:
    """Body of one rank (after the group started)."""
    import numpy as np
    import torch.distributed as dist

    from vae_connexe_torch.parallel.mesh import make_mesh, world_device
    from vae_connexe_torch.train import fit_phase1

    mesh = make_mesh(n_dp=payload["n_dp"], n_ep=payload["n_ep"])
    model, params, windows, parents, cfg, gen = fit_inputs(payload,
                                                           world_device())
    best, _, metrics = fit_phase1(model, params, windows, parents, cfg, gen,
                                  mesh=mesh)
    if dist.get_rank() == 0:
        np.savez(payload["out_path"], loss=metrics["loss"],
                 **{f"leaf{i}": x for i, x in enumerate(_leaves_np(best))})
    print(f"proc {payload['process_id']}/{payload['num_processes']} rank "
          f"{dist.get_rank()}: fit_phase1 {cfg.max_iter} steps "
          f"{_where(mesh)} loss={metrics['loss']:.5f}", flush=True)


def _experiment_overrides(exp, overrides: dict | None):
    """``exp`` with a payload's JSON deltas: ``{"t": int, "phase1":
    {...}, "phase2": {...}}``."""
    import dataclasses

    ov = overrides or {}
    if "t" in ov:
        exp = dataclasses.replace(exp, t=int(ov["t"]))
    for phase in ("phase1", "phase2"):
        if phase in ov:
            exp = dataclasses.replace(exp, **{phase: dataclasses.replace(
                getattr(exp, phase), **ov[phase])})
    return exp


def _worker_payload_experiment(payload: dict) -> None:
    """A named crvae experiment on the global (dp, ep) mesh: phase 1, the
    GC handoff, phase 2, with ``run_experiment``'s generators.  Rank 0
    writes ``mp_results.json`` (phase metrics and GC metrics),
    ``GC_<exp>.npy`` and ``mp_params.npz`` (the best phase-1 / phase-2 /
    error-VAE leaves) under ``out_dir``.  ``kill_at`` ({phase: step}) makes
    every rank (or those of ``kill_ranks``) raise after that step's
    checkpoint landed (the stand-in for a preemption, as in the JAX
    package's tests)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from vae_connexe_torch.configs.experiments import (
        ROLES,
        _floats,
        _make_dataset,
        get_experiment,
    )
    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.evals import gc_metrics
    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.parallel.mesh import (
        make_mesh,
        mesh_shape,
        world_device,
    )
    from vae_connexe_torch.train import fit_phase1, fit_phase2
    from vae_connexe_torch.utils.seeding import role_generators

    exp = get_experiment(payload["experiment"])
    if exp.model_family != "crvae":
        raise ValueError(
            f"--processes supports the crvae family (two-phase meshed "
            f"trainer); {exp.name!r} is {exp.model_family!r}")
    exp = _experiment_overrides(exp, payload.get("overrides"))
    mesh = make_mesh(n_dp=payload["n_dp"], n_ep=payload["n_ep"])
    dev = world_device()
    rank0 = dist.get_rank() == 0
    out = pathlib.Path(payload["out_dir"])
    out.mkdir(parents=True, exist_ok=True)

    def gens(offset=0):
        return role_generators(payload["seed"], ROLES, ("init",), dev,
                               offset)

    series, truth = _make_dataset(exp, gens()["data"], dev)
    windows, _ = arrange_input(series, exp.context)
    g = gens()
    model = CRVAE(p=exp.p, hidden=exp.hidden)
    params = model.init(g["init"], dev)
    full = torch.ones((exp.p, exp.p), device=dev)

    def ckpt_kw(phase):
        if not (payload.get("checkpoint_every") or payload.get("resume")):
            return {}
        return {"checkpoint_dir": str(out / f"ckpt_mid_{phase}"),
                "checkpoint_every": payload.get("checkpoint_every") or 0,
                "resume": bool(payload.get("resume"))}

    def kill_cb(phase):
        at = (payload.get("kill_at") or {}).get(phase)
        ranks = payload.get("kill_ranks")
        if at is None or (ranks is not None
                          and dist.get_rank() not in ranks):
            return None

        def cb(step, state, metrics):
            if step >= at:
                raise RuntimeError(f"kill_at[{phase}]={at} reached (test kill)")
        return cb

    best, _, m1 = fit_phase1(model, params, windows, full, exp.phase1,
                             g["run"], mesh=mesh, verbose=rank0,
                             callback=kill_cb("phase1"), **ckpt_kw("phase1"))
    scores = model.gc(best, threshold=False)
    gc_est = model.gc(best, threshold=True)
    results = {"experiment": exp.name, "seed": payload["seed"],
               "processes": payload["num_processes"],
               "ranks": dist.get_world_size(), "mesh": mesh_shape(mesh),
               "phase1": m1,
               "gc": _floats(gc_metrics(truth, scores, exp.gc_threshold))}
    arrays = {f"p1_{i}": x for i, x in enumerate(_leaves_np(best))}
    if payload.get("run_phase2", True):
        mask = gc_est.to(torch.float32)
        err_model = ErrorVAE(d=exp.p, hidden=exp.hidden)
        best2, err2, _, m2 = fit_phase2(
            model, err_model, model.init(gens(1)["init"], dev),
            err_model.init(gens(2)["init"], dev), windows, mask, exp.phase2,
            g["p2"], mesh=mesh, verbose=rank0, callback=kill_cb("phase2"),
            **ckpt_kw("phase2"))
        results["phase2"] = m2
        arrays.update({f"p2_{i}": x for i, x in enumerate(_leaves_np(best2))})
        arrays.update({f"err_{i}": x
                       for i, x in enumerate(_leaves_np(err2))})
    # Every rank's recurrence-kernel launches over the run (this process
    # launched nothing else).
    from vae_connexe_torch.ops import cuda_gru

    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, dict(cuda_gru.LAUNCHES))
    results["launches"] = launches
    if rank0:
        np.save(out / f"GC_{exp.name}.npy", gc_est.cpu().numpy())
        np.savez(out / "mp_params.npz", **arrays)
        (out / "mp_results.json").write_text(json.dumps(results))
    print(f"proc {payload['process_id']}/{payload['num_processes']} rank "
          f"{dist.get_rank()}: experiment {exp.name} phase1 "
          f"{exp.phase1.max_iter} steps"
          + (f" + phase2 {exp.phase2.max_iter} steps"
             if payload.get("run_phase2", True) else "")
          + f" {_where(mesh)}", flush=True)


def _worker_payload_dryrun(payload: dict) -> None:
    """One full sharded phase-1 step (forward, backward, the gradient
    sums, SGD, the prox) on an n-rank (dp, ep) mesh at small shapes."""
    import torch
    import torch.distributed as dist

    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.parallel.mesh import (
        global_device_put,
        make_mesh,
        mesh_shape,
        world_device,
    )
    from vae_connexe_torch.parallel.sharded import make_sharded_phase1_step
    from vae_connexe_torch.train.config import Phase1Config

    n = dist.get_world_size()
    n_ep = 2 if n % 2 == 0 else 1
    mesh = make_mesh(n_dp=n // n_ep, n_ep=n_ep)
    dev = world_device()
    p, hidden, ctx = 2 * max(n_ep, 2), 16, 12
    batch_size = 4 * (n // n_ep)
    model = CRVAE(p=p, hidden=hidden, enc_len=6)
    cfg = Phase1Config(lam=0.1, lr=5e-2, batch_size=batch_size)
    parents = torch.ones((p, p), device=dev)
    step, param_shard, _ = make_sharded_phase1_step(model, cfg, mesh,
                                                    parents)
    params = global_device_put(model.init(torch.Generator().manual_seed(0),
                                          dev), param_shard)
    g = torch.Generator().manual_seed(1)
    batch = torch.randn((batch_size, ctx, p), generator=g).to(dev)
    eps = torch.randn((batch_size, hidden), generator=g).to(dev)
    _, metrics = step(params, batch, eps)
    loss = float(metrics["loss"])
    if not torch.isfinite(torch.tensor(loss)):
        raise FloatingPointError("sharded step produced a non-finite loss")
    print(f"dryrun_multichip OK rank {dist.get_rank()}: "
          f"mesh={mesh_shape(mesh)} on {dev} loss={loss:.4f}", flush=True)


_MODES = {"fit": _worker_payload_fit,
          "experiment": _worker_payload_experiment,
          "dryrun": _worker_payload_dryrun}


def worker_main(argv: list[str]) -> None:
    """Entry of ``python -m vae_connexe_torch.parallel.multiprocess
    <json>``: join the group as the payload's rank, run its mode, leave.
    A failure prints its traceback and exits with status 1 without
    waiting on the other ranks."""
    payload = json.loads(argv[0])
    from vae_connexe_torch.parallel.mesh import shutdown
    from vae_connexe_torch.parallel.multihost import initialize_multihost

    dpp = payload.get("devices_per_process", 1)
    rank = payload["process_id"] * dpp + payload.get("local_rank", 0)
    world = payload["num_processes"] * dpp
    try:
        if payload.get("force_cpu"):
            import torch

            torch.set_num_threads(1)
        initialize_multihost(
            coordinator_address=payload["coordinator_address"],
            num_processes=world, process_id=rank,
            device="cpu" if payload.get("force_cpu") else None,
            local_rank=rank, local_world=world,
            timeout=payload.get("timeout_s"))
        _MODES[payload.get("mode", "fit")](payload)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(1)
    shutdown()


def _run_workers(payload: dict, num_processes: int, devices_per_process: int,
                 timeout: float) -> list[str]:
    """Start ``num_processes * devices_per_process`` ranks on this host,
    each an OS process, wait, and return their logs (in rank order).  When
    a rank fails the others are stopped at once; raises with every log if
    any rank failed or the run outlived ``timeout``."""
    repo_root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ)
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    if payload.get("force_cpu"):
        env["OMP_NUM_THREADS"] = "1"
    logdir = tempfile.mkdtemp(prefix="vae_connexe_torch_mp_")
    procs, files = [], []
    for pid in range(num_processes):
        for local in range(devices_per_process):
            args = json.dumps({**payload, "process_id": pid,
                               "local_rank": local,
                               "devices_per_process": devices_per_process,
                               "num_processes": num_processes})
            f = open(os.path.join(logdir, f"rank{len(procs)}.log"), "w+")
            files.append(f)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "vae_connexe_torch.parallel.multiprocess", args],
                env=env, cwd=repo_root, stdout=f, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = []
    while True:
        codes = [p.poll() for p in procs]
        bad = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
        if bad or all(c == 0 for c in codes):
            failed = bad
            break
        if time.monotonic() > deadline:
            failed = [(i, "timeout") for i, c in enumerate(codes)
                      if c is None]
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    logs = []
    for f in files:
        f.seek(0)
        logs.append(f.read())
        f.close()
    if failed:
        raise RuntimeError(
            f"multiprocess run failed: {failed}\n" + "\n".join(
                f"--- rank {i} ---\n{log}" for i, log in enumerate(logs)))
    return logs


def launch_multiprocess_fit(num_processes: int = 2,
                            devices_per_process: int = 1,
                            n_dp: int | None = None, n_ep: int = 2,
                            p: int = 4, hidden: int = 16, ctx: int = 12,
                            enc_len: int = 6, n_windows: int = 64,
                            batch_size: int = 8, max_iter: int = 24,
                            check_every: int = 8, lam: float = 0.1,
                            lr: float = 5e-2, data_seed: int = 5,
                            init_seed: int = 6, fit_seed: int = 7,
                            port: int | None = None, timeout: float = 600.0,
                            *, device=None):
    """Start ``num_processes * devices_per_process`` ranks running the
    meshed ``fit_phase1`` over one global (dp, ep) mesh; returns
    (best-params leaves, final loss, logs).  ``device``: ``"cpu"`` runs
    the ranks on the CPU over gloo; default the card(s)."""
    n_total = num_processes * devices_per_process
    if n_dp is None:
        n_dp = n_total // n_ep
    if port is None:
        port = _free_port()
    out_path = os.path.join(tempfile.mkdtemp(prefix="vae_connexe_mp_"),
                            "fit.npz")
    payload = dict(mode="fit", coordinator_address=f"localhost:{port}",
                   force_cpu=_is_cpu(device), n_dp=n_dp, n_ep=n_ep, p=p,
                   hidden=hidden, ctx=ctx, enc_len=enc_len,
                   n_windows=n_windows, batch_size=batch_size,
                   max_iter=max_iter, check_every=check_every, lam=lam,
                   lr=lr, data_seed=data_seed, init_seed=init_seed,
                   fit_seed=fit_seed, out_path=out_path,
                   timeout_s=min(timeout, 300.0))
    logs = _run_workers(payload, num_processes, devices_per_process, timeout)
    import numpy as np
    with np.load(out_path) as data:
        loss = float(data["loss"])
        leaves = [data[f"leaf{i}"] for i in range(len(data.files) - 1)]
    os.unlink(out_path)
    return leaves, loss, logs


def _is_cpu(device) -> bool:
    if device is None:
        from vae_connexe_torch._device import resolve_device

        resolve_device(None)      # raises without a card
        return False
    return str(device) == "cpu"


def launch_multiprocess_experiment(experiment: str, num_processes: int = 2,
                                   devices_per_process: int = 1,
                                   n_dp: int | None = None, n_ep: int = 1,
                                   seed: int = 0,
                                   overrides: dict | None = None,
                                   run_phase2: bool = True,
                                   out_dir: str | None = None,
                                   checkpoint_every: int | None = None,
                                   resume: bool = False,
                                   kill_at: dict | None = None,
                                   port: int | None = None,
                                   timeout: float = 1800.0, *, device=None,
                                   kill_ranks: list | None = None):
    """Run a named crvae experiment as ``num_processes *
    devices_per_process`` ranks over one global (dp, ep) mesh: phase 1, the
    GC handoff, phase 2.  The ``cli run <exp> --processes N`` backend.

    Returns ``(results, arrays, logs)``: the metrics dict rank 0 wrote
    (``run_experiment``'s generators, so directly comparable; with every
    rank's B1/B2 launch counts under ``launches``), the saved
    best-params arrays (``p1_<i>`` / ``p2_<i>`` / ``err_<i>`` leaves in
    field order) and the ranks' logs.  ``overrides``: JSON-able config
    deltas, ``{"t": int, "phase1": {...}, "phase2": {...}}``.
    ``checkpoint_every`` / ``resume``: mid-phase snapshots under
    ``out_dir/ckpt_mid_phase{1,2}``.  ``kill_at``: ``{"phase1": step}``
    makes every rank (or only the ranks of ``kill_ranks``) raise after
    that step's checkpoint landed.
    ``device``: ``"cpu"`` for gloo CPU ranks; default the card(s).
    """
    n_total = num_processes * devices_per_process
    if n_dp is None:
        n_dp = n_total // n_ep
    if port is None:
        port = _free_port()
    if out_dir is None:
        out_dir = tempfile.mkdtemp(prefix="vae_connexe_mpexp_")
    payload = dict(mode="experiment",
                   coordinator_address=f"localhost:{port}",
                   force_cpu=_is_cpu(device), n_dp=n_dp, n_ep=n_ep,
                   experiment=experiment, seed=seed, overrides=overrides,
                   run_phase2=run_phase2, out_dir=str(out_dir),
                   checkpoint_every=checkpoint_every, resume=resume,
                   kill_at=kill_at, kill_ranks=kill_ranks,
                   timeout_s=min(timeout, 300.0))
    logs = _run_workers(payload, num_processes, devices_per_process, timeout)
    import numpy as np
    out = pathlib.Path(out_dir)
    results = json.loads((out / "mp_results.json").read_text())
    with np.load(out / "mp_params.npz") as data:
        arrays = {k: np.asarray(data[k]) for k in data.files}
    return results, arrays, logs


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = 300.0) -> list[str]:
    """One full sharded phase-1 step on an ``n_devices``-rank (dp, ep) mesh
    (ep = 2 when n is even), one OS process a rank; returns the ranks'
    logs.  On the card by default (ranks beyond the card count share a
    card over gloo); on the CPU only when ``device="cpu"``."""
    payload = dict(mode="dryrun", coordinator_address=f"localhost:"
                   f"{_free_port()}", force_cpu=_is_cpu(device),
                   timeout_s=min(timeout, 300.0))
    return _run_workers(payload, n_devices, 1, timeout)


if __name__ == "__main__":
    worker_main(sys.argv[1:])
