"""Command line of the port: run experiments, evaluate and export their
checkpoints, sample from or serve generator artifacts.

Subcommands:
  list       show the experiments
  run        run a named experiment end to end (train, evaluate, artifacts)
  discover   Granger-causal discovery on YOUR data (.npy/.csv/...)
  sweep      multi-seed phase-1 causal-discovery sweep
  eval       rescore / generate from a checkpoint
  export     checkpoint -> generator artifact
  generate   sample from an artifact
  serve      HTTP serving daemon for artifacts

Examples:
  python -m vae_connexe_torch.cli list
  python -m vae_connexe_torch.cli run lorenz96_crvae --out-dir out --save-checkpoints
  python -m vae_connexe_torch.cli export lorenz96_crvae out/ckpt_phase2 --out g.vcxt
  python -m vae_connexe_torch.cli export lorenz96_crvae out/ckpt_phase2 --out g16.vcxt \
      --serve-dtype bfloat16 --platforms cuda cpu
  python -m vae_connexe_torch.cli run lorenz96_crvae --out-of-core --out-dir out
  python -m vae_connexe_torch.cli serve g.vcxt --port 8799
  python -m vae_connexe_torch.cli discover my_series.csv --seeds 8 --out-dir out/
  python -m vae_connexe_torch.cli run henon6d_win --out-dir out --save-checkpoints
  python -m vae_connexe_torch.cli export henon6d_win out/ckpt_win --out w.vcxt
  python -m vae_connexe_torch.cli generate w.vcxt --context ctx.npy
  python -m vae_connexe_torch.cli sweep --p 10 --seeds 8 --iters 1000
  python -m vae_connexe_torch.cli run lorenz96_crcsrae --out-dir out --save-checkpoints
  python -m vae_connexe_torch.cli run csrae_binarized --out-dir out --save-checkpoints
  python -m vae_connexe_torch.cli eval csrae_binarized out/ckpt_csrae --generate 8
  python -m vae_connexe_torch.cli run vrae_demo --debug-nans
  python -m vae_connexe_torch.cli run lorenz96_crvae --processes 2 --ep 2
  torchrun --nproc-per-node 2 -m vae_connexe_torch.cli run lorenz96_xl --mesh --ep 2

Everything runs on the card unless ``--device cpu`` is given.  Meshes:
one process a device.  ``run --processes N`` starts N ranks itself
(``parallel/multiprocess.py``); ``--mesh`` makes this process one rank of
the group ``torchrun`` started (its environment), or of a world of one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def _mesh(args, n_ep: int = 1, n_sp: int = 1):
    """The mesh of ``--mesh`` (None without it): this process joins the
    group ``torchrun``'s environment describes, or starts a world of one,
    and builds the (dp, ep[, sp]) mesh over it."""
    if not args.mesh:
        return None
    import os

    import torch.distributed as dist

    from vae_connexe_torch.parallel import initialize_multihost, make_mesh
    from vae_connexe_torch.parallel.mesh import mesh_shape

    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        initialize_multihost(device=args.device)
    mesh = make_mesh(n_ep=n_ep, n_sp=n_sp, device=args.device)
    print(f"mesh: {mesh_shape(mesh)}", file=sys.stderr)
    return mesh


def _mesh_device(mesh, device):
    """The device a meshed command runs on: its rank's."""
    if mesh is None:
        return device
    from vae_connexe_torch.parallel.mesh import world_device

    return world_device()


def _print_json(mesh, obj, **kw) -> None:
    """Print the command's JSON once: on rank 0 of a mesh."""
    from vae_connexe_torch.parallel.mesh import is_writer

    if is_writer(mesh):
        print(json.dumps(obj, **kw))


def _cmd_list(args):
    from vae_connexe_torch.configs import EXPERIMENTS

    for name, exp in sorted(EXPERIMENTS.items()):
        print(f"{name:20s} family={exp.model_family:6s} dataset={exp.dataset:14s} "
              f"p={exp.p} hidden={exp.hidden} {exp.notes}")


def _cmd_run(args):
    from vae_connexe_torch.configs import get_experiment, run_experiment

    if args.debug_nans:
        from vae_connexe_torch.utils import enable_nan_debugging

        enable_nan_debugging()
    if args.processes:
        # N cooperating OS processes, one rank a device, over one global
        # (dp, ep) mesh.
        from vae_connexe_torch.parallel.multiprocess import (
            launch_multiprocess_experiment,
        )

        unsupported = [flag for flag, on in (
            ("--mesh", args.mesh), ("--out-of-core", args.out_of_core),
            ("--save-checkpoints", args.save_checkpoints),
            ("--artifacts-every", bool(args.artifacts_every)),
            ("--sp", args.sp > 1)) if on]
        if unsupported:
            sys.exit(f"--processes implies a meshed fit and composes with "
                     f"--ep/--iters/--checkpoint-every/--resume/--no-phase2; "
                     f"{' '.join(unsupported)} not supported multi-process")
        if (args.checkpoint_every or args.resume) and not args.out_dir:
            sys.exit("--checkpoint-every/--resume require --out-dir")
        overrides = None
        if args.iters is not None:
            overrides = {"phase1": {"max_iter": args.iters},
                         "phase2": {"max_iter": args.iters}}
        results, _, _ = launch_multiprocess_experiment(
            args.experiment, num_processes=args.processes,
            devices_per_process=args.devices_per_process or 1,
            n_ep=args.ep, seed=args.seed, overrides=overrides,
            run_phase2=not args.no_phase2, out_dir=args.out_dir,
            checkpoint_every=args.checkpoint_every, resume=args.resume,
            device=args.device)
        print(json.dumps(results, indent=2, default=str))
        return
    overrides = {}
    if args.iters is not None:
        exp = get_experiment(args.experiment)
        overrides["phase1"] = dataclasses.replace(exp.phase1,
                                                  max_iter=args.iters)
        overrides["phase2"] = dataclasses.replace(exp.phase2,
                                                  max_iter=args.iters)
        overrides["win"] = dataclasses.replace(
            exp.win, stage1_epochs=max(1, args.iters // 10),
            stage2_epochs=max(1, args.iters // 20))
    mesh = _mesh(args, n_ep=args.ep, n_sp=args.sp)
    results = run_experiment(args.experiment, seed=args.seed,
                             out_dir=args.out_dir, overrides=overrides or None,
                             run_phase2=not args.no_phase2,
                             save_checkpoints=args.save_checkpoints,
                             artifacts_every=args.artifacts_every,
                             mesh=mesh,
                             checkpoint_every=args.checkpoint_every,
                             resume=args.resume, verbose=not args.quiet,
                             out_of_core=args.out_of_core,
                             device=_mesh_device(mesh, args.device))
    _print_json(mesh, results, indent=2, default=str)


def _cmd_sweep(args):
    """Multi-seed phase-1 sweep on a Lorenz-96 series; per-seed AUROC and
    the stability selection's metrics against the circulant truth."""
    import torch

    from vae_connexe_torch._device import resolve_device
    from vae_connexe_torch.data import arrange_input, lorenz96, lorenz96_truth
    from vae_connexe_torch.evals import auroc, gc_metrics, stability_selection
    from vae_connexe_torch.models import CRVAE
    from vae_connexe_torch.parallel import sweep_phase1
    from vae_connexe_torch.train import Phase1Config

    mesh = _mesh(args)
    dev = resolve_device(_mesh_device(mesh, args.device))
    series = lorenz96(torch.Generator(device=dev).manual_seed(args.seed),
                      p=args.p, t=args.t, device=dev)
    windows, _ = arrange_input(series, args.context)
    model = CRVAE(p=args.p, hidden=args.hidden)
    cfg = Phase1Config(lam=args.lam, lr=5e-2, max_iter=args.iters,
                       batch_size=args.batch)
    out = sweep_phase1(model, windows, torch.ones((args.p, args.p),
                                                  device=dev), cfg,
                       range(args.seeds), mesh=mesh)
    truth = lorenz96_truth(args.p, dev)
    aurocs = [float(auroc(truth, out["gc_scores"][i]))
              for i in range(args.seeds)]
    min_frac = "auto" if args.min_frac == "auto" else float(args.min_frac)
    votes, _, min_frac = stability_selection(out["gc_scores"],
                                             min_frac=min_frac)
    stab = gc_metrics(truth, votes, min_frac - 1e-9)
    _print_json(mesh, {
        "seeds": args.seeds,
        "aurocs": aurocs,
        "auroc_mean": sum(aurocs) / len(aurocs),
        "mean_loss": [float(x) for x in out["mean_loss"]],
        "stability_min_frac": min_frac,
        "stability_selection": {k: float(v) for k, v in stab.items()},
    }, indent=2)


_LOW_CONFIDENCE = (
    "WARNING: low discovery confidence ({conf:.2f} < 0.5) — the seed "
    "ensemble rules out only {pct:.0f}% of candidate edges ({off}/{cand} "
    "off-diagonal edges selected). Either the system is genuinely dense or "
    "the lag-window estimator cannot discriminate (typical for smooth, "
    "densely sampled flows). Treat the graph as exploratory; try --diff "
    "(differenced series), a larger --lam, or a longer --context.")


def _cmd_discover(args):
    """Granger-causal discovery on a user-supplied series file."""
    import pathlib

    import numpy as np

    from vae_connexe_torch.data.io import load_series
    from vae_connexe_torch.discover import discover

    mesh = _mesh(args, n_ep=args.ep)
    shape = tuple(args.shape) if args.shape else None
    series, names = load_series(args.data, shape=shape,
                                delimiter=args.delimiter)
    threshold = args.threshold if args.threshold == "auto" \
        else float(args.threshold)
    min_frac = args.min_frac if args.min_frac == "auto" \
        else float(args.min_frac)
    res = discover(series, context=args.context, hidden=args.hidden,
                   enc_len=args.enc_len,
                   lam=args.lam, lr=args.lr, max_iter=args.iters,
                   batch_size=args.batch, seeds=args.seeds, seed=args.seed,
                   threshold=threshold, min_frac=min_frac,
                   standardize=not args.no_standardize, diff=args.diff,
                   family=args.family, prox=args.prox, latent=args.latent,
                   generate=args.generate, phase2_iters=args.phase2_iters,
                   names=names, mesh=mesh, verbose=not args.quiet,
                   log_fn=lambda *a: print(*a, file=sys.stderr),
                   device=_mesh_device(mesh, args.device))

    summary = {
        "data": args.data,
        "shape": list(series.shape),
        "variables": names,
        "family": args.family,
        "seeds": args.seeds,
        "threshold": res.threshold,
        "confidence": res.confidence,
        "n_edges": int(res.gc.sum()),
        "edges": [{"cause": c, "effect": e, "score": s}
                  for c, e, s in res.edges()],
        "metrics": res.metrics,
    }
    if res.confidence is not None and res.confidence < 0.5:
        p_vars = res.gc.shape[0]
        off = int(res.gc.sum()) - int(res.gc.diagonal().sum())
        print(_LOW_CONFIDENCE.format(conf=res.confidence,
                                     pct=100 * res.confidence, off=off,
                                     cand=p_vars * (p_vars - 1)),
              file=sys.stderr)
    from vae_connexe_torch.parallel.mesh import is_writer

    if args.out_dir and is_writer(mesh):
        out = pathlib.Path(args.out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stem = pathlib.Path(args.data).stem
        np.save(out / f"GC_{stem}.npy", res.gc)
        np.save(out / f"GC_scores_{stem}.npy", res.scores)
        if res.votes is not None:
            np.save(out / f"GC_votes_{stem}.npy", res.votes)
        if res.samples is not None:
            np.save(out / f"generated_{stem}.npy", res.samples)
        from vae_connexe_torch.evals.viz import FigureWriter, discovery_heatmap

        figs = FigureWriter()
        figs.draw(discovery_heatmap, res.scores, res.gc,
                  path=str(out / f"discovery_{stem}.png"), names=names,
                  threshold=res.threshold)
        figs.report()
        with open(out / f"discovery_{stem}.json", "w") as f:
            json.dump(summary, f, indent=2)
        summary["artifacts"] = str(out)
    _print_json(mesh, summary, indent=2)


def _cmd_eval(args):
    """Restore a checkpoint (crvae: ``ckpt_phase1`` and its GC companion;
    win: ``ckpt_win``; vrae: ``ckpt_vrae``; csrae: ``ckpt_csrae``),
    rescore (the csrae family: its reconstruction metrics; the vrae family
    has no graph to score), and optionally generate, without training."""
    import numpy as np
    import torch

    from vae_connexe_torch._device import resolve_device
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.configs.experiments import (
        _make_dataset,
        _sweep,
        csrae_eval_metrics,
        make_csrae_inputs,
        vrae_model,
    )
    from vae_connexe_torch.evals import gc_metrics
    from vae_connexe_torch.models import CRVAE, WInCRVAE
    from vae_connexe_torch.utils import load_gc, restore_checkpoint

    exp = get_experiment(args.experiment)
    dev = resolve_device(args.device)
    results = {"experiment": args.experiment, "checkpoint": args.checkpoint}
    series, truth = _make_dataset(
        exp, torch.Generator(device=dev).manual_seed(args.seed), dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    init = torch.Generator().manual_seed(0)
    if exp.model_family == "crvae":
        model = CRVAE(p=exp.p, hidden=exp.hidden)
        params = restore_checkpoint(args.checkpoint, model.init(init, dev))
        gc = torch.tensor(load_gc(args.checkpoint), dtype=torch.float32,
                          device=dev)
        scores = model.gc(params, parents=gc, threshold=False)
        if args.generate:
            roll = model.rollout(params, gen, args.generate, parents=gc)
    elif exp.model_family == "win":
        model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                         tau=exp.tau)
        params = restore_checkpoint(args.checkpoint, model.init(init, dev))
        scores = model.granger_matrix(params, threshold=False)
        if args.generate:
            ctx = (series[None, : 2 * exp.tau] if series.ndim == 2
                   else series[:1, : 2 * exp.tau])
            ctx = ctx.expand(args.generate, -1, -1)
            roll = model.generate(params, ctx, gen, 20)
    elif exp.model_family == "vrae":
        model = vrae_model(exp)
        params = restore_checkpoint(args.checkpoint, model.init(init, dev))
        truth = None   # no causal graph for the plain VRAE
        if args.generate:
            with torch.no_grad():
                roll = model.sample(params, gen, args.generate, exp.t)
    elif exp.model_family == "csrae":
        x, model = make_csrae_inputs(exp, series)
        params = restore_checkpoint(args.checkpoint, model.init(init, dev))
        truth = None   # no causal graph for the CS-RAE
        results.update(csrae_eval_metrics(
            model, params, x,
            torch.Generator(device=dev).manual_seed(args.seed)))
        if args.generate:
            with torch.no_grad():
                roll = model.sample(params, gen, args.generate)
    else:
        sys.exit(f"eval does not support the {exp.model_family!r} family")
    if truth is not None:
        results["gc"] = {k: float(v) for k, v in
                         gc_metrics(truth, scores, exp.gc_threshold).items()}
        results["threshold_sweep"] = _sweep(truth, scores)
    if args.generate:
        results["generated_shape"] = list(roll.shape)
        if args.out:
            np.save(args.out, roll.cpu().numpy())
            results["saved"] = args.out
    print(json.dumps(results, indent=2))


def _cmd_export(args):
    """Export a checkpoint as a generator artifact (crvae: ``ckpt_phase2``;
    win: ``ckpt_win``, context-conditioned)."""
    import pathlib

    import torch

    from vae_connexe_torch._device import resolve_device
    from vae_connexe_torch.configs import get_experiment
    from vae_connexe_torch.models import CRVAE, ErrorVAE, WInCRVAE
    from vae_connexe_torch.serving import export_generator, export_win_generator
    from vae_connexe_torch.utils import restore_checkpoint

    exp = get_experiment(args.experiment)
    if exp.model_family not in ("crvae", "win"):
        sys.exit(f"export supports the crvae and win families; "
                 f"{args.experiment!r} is {exp.model_family!r}")
    dev = resolve_device(args.device)
    g = torch.Generator().manual_seed(0)
    if exp.model_family == "crvae":
        model = CRVAE(p=exp.p, hidden=exp.hidden)
        err_model = ErrorVAE(d=exp.p, hidden=exp.hidden)
        target = {"crvae": model.init(g, dev),
                  "error_vae": err_model.init(g, dev)}
        ckpt = restore_checkpoint(args.checkpoint, target)
        blob = export_generator(model, err_model, ckpt["crvae"],
                                ckpt["error_vae"], batch=args.batch,
                                length=args.length,
                                platforms=args.platforms,
                                serve_dtype=args.serve_dtype,
                                kernel=args.serve_kernel)
    else:
        if args.serve_kernel != "lax":
            sys.exit(f"--serve-kernel {args.serve_kernel!r} is not supported "
                     f"for the win family (context-conditioned export has no "
                     f"fused kernel); use the default 'lax'")
        model = WInCRVAE(d=exp.p, hidden=exp.hidden, latent=exp.latent,
                         tau=exp.tau)
        params = restore_checkpoint(args.checkpoint, model.init(g, dev))
        blob = export_win_generator(model, params, batch=args.batch,
                                    length=args.length or 21,
                                    platforms=args.platforms,
                                    serve_dtype=args.serve_dtype)
    pathlib.Path(args.out).write_bytes(blob)
    print(json.dumps({"artifact": args.out, "bytes": len(blob),
                      "batch": args.batch,
                      "platforms": args.platforms or [dev.type],
                      "serve_dtype": args.serve_dtype or "float32"},
                     indent=2))


def _cmd_serve(args):
    """Run the HTTP serving daemon on one or more artifacts."""
    from vae_connexe_torch.server import GeneratorServer

    arts = args.artifact if len(args.artifact) > 1 else args.artifact[0]
    srv = GeneratorServer(arts, host=args.host, port=args.port,
                          device=args.device)
    print(json.dumps({"serving": args.artifact, "host": srv.host,
                      "port": srv.port, "batch": srv.meta["batch"],
                      "routes": sorted(srv._artifacts),
                      "serve_dtype": srv.meta.get("serve_dtype", "float32"),
                      "warmup_s": round(srv._warmup_s, 3)}), flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        srv.shutdown()


def _cmd_generate(args):
    """Sample from an artifact."""
    import numpy as np

    from vae_connexe_torch.serving import load_generator

    fn, meta = load_generator(args.artifact, args.device)
    if meta["kind"] == "win_conditioned_generator":
        if not args.context:
            sys.exit("this artifact is context-conditioned; pass --context "
                     "ctx.npy of shape (batch, >=tau, p)")
        ctx = np.load(args.context)
        samples = fn(args.seed, ctx[:, -meta["tau"]:, :])
    else:
        samples = fn(args.seed)
    result = {"artifact": args.artifact, "meta": meta, "seed": args.seed,
              "shape": list(samples.shape)}
    if args.out:
        np.save(args.out, samples)
        result["saved"] = args.out
    print(json.dumps(result, indent=2))


def _device_arg(p):
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vae_connexe_torch",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("list", help="list experiments").set_defaults(fn=_cmd_list)

    p_run = sub.add_parser("run", help="run a named experiment")
    p_run.add_argument("experiment")
    p_run.add_argument("--seed", type=int, default=0)
    p_run.add_argument("--out-dir", default=None)
    p_run.add_argument("--iters", type=int, default=None,
                       help="override phase iteration counts (smoke runs)")
    p_run.add_argument("--no-phase2", action="store_true")
    p_run.add_argument("--save-checkpoints", action="store_true",
                       help="write ckpt_phase1 (+ GC companion) and "
                            "ckpt_phase2 to --out-dir")
    p_run.add_argument("--checkpoint-every", type=int, default=None,
                       dest="checkpoint_every", metavar="N",
                       help="snapshot the running phase's whole state every "
                            "N steps under --out-dir; a killed run restarts "
                            "with --resume, bitwise equal to the "
                            "uninterrupted run")
    p_run.add_argument("--resume", action="store_true",
                       help="restore the latest mid-phase snapshot under "
                            "--out-dir and continue (finished phases are "
                            "pure restores)")
    p_run.add_argument("--quiet", action="store_true")
    _device_arg(p_run)
    p_run.add_argument("--mesh", action="store_true",
                       help="crvae family: train both phases sharded over a "
                            "(dp, ep[, sp]) mesh of ranks, this process one "
                            "of them (torchrun's group, or a world of one); "
                            "composes with --checkpoint-every/--resume and "
                            "--out-of-core")
    p_run.add_argument("--ep", type=int, default=1,
                       help="ep (head-parallel) mesh size for --mesh and "
                            "--processes; must divide p")
    p_run.add_argument("--sp", type=int, default=1,
                       help="sp (sequence-parallel) mesh size for --mesh: "
                            "the decode recurrence's time axis split over "
                            "sp ranks, its state sent rank to rank")
    p_run.add_argument("--processes", type=int, default=None, metavar="N",
                       help="run the experiment as N cooperating OS "
                            "processes, one rank a device, over one global "
                            "(dp, ep) mesh: phase 1, the GC handoff, phase "
                            "2; composes with --ep, --iters, "
                            "--checkpoint-every/--resume, --no-phase2")
    p_run.add_argument("--devices-per-process", type=int, default=None,
                       dest="devices_per_process", metavar="D",
                       help="ranks a process for --processes (default 1; "
                            "PyTorch runs one device a rank)")
    p_run.add_argument("--out-of-core", action="store_true",
                       dest="out_of_core",
                       help="crvae family: stream both phases' batches from "
                            "the series on disk through the native window "
                            "loader (bit for bit the in-memory run)")
    p_run.add_argument("--artifacts-every", type=int, default=None,
                       dest="artifacts_every", metavar="N",
                       help="crvae family, with --out-dir: every N phase-2 "
                            "steps save a compensated sample with its PCA "
                            "and trajectory figures")
    p_run.add_argument("--debug-nans", action="store_true", dest="debug_nans",
                       help="stop at the first NaN/Inf a training step makes "
                            "(autograd anomaly detection, the B1/B2 backward "
                            "included; each step's loss and updated "
                            "parameters checked, FloatingPointError naming "
                            "the step)")
    p_run.set_defaults(fn=_cmd_run)

    p_sw = sub.add_parser("sweep", help="multi-seed causal-discovery sweep")
    p_sw.add_argument("--p", type=int, default=10)
    p_sw.add_argument("--t", type=int, default=2048)
    p_sw.add_argument("--context", type=int, default=20)
    p_sw.add_argument("--hidden", type=int, default=64)
    p_sw.add_argument("--batch", type=int, default=256)
    p_sw.add_argument("--lam", type=float, default=0.1)
    p_sw.add_argument("--iters", type=int, default=1000)
    p_sw.add_argument("--seeds", type=int, default=8)
    p_sw.add_argument("--seed", type=int, default=0, help="data seed")
    p_sw.add_argument("--min-frac", default="0.5", dest="min_frac",
                      help="stability-selection vote threshold in [0,1], or "
                           "'auto' (largest vote-spectrum gap, clamped to "
                           "[0.5, 0.95])")
    _device_arg(p_sw)
    p_sw.add_argument("--mesh", action="store_true",
                      help="split the seed axis over the mesh's dp ranks")
    p_sw.set_defaults(fn=_cmd_sweep)

    p_d = sub.add_parser(
        "discover",
        help="Granger-causal discovery on YOUR time series "
             "(.npy/.npz/.csv/.tsv/.txt/raw-f32)")
    p_d.add_argument("data", help="series file: rows = time steps, columns "
                                  "= variables; (T, p) or (N, T, p)")
    p_d.add_argument("--context", type=int, default=20,
                     help="lag window length (how far back causes may act)")
    p_d.add_argument("--hidden", type=int, default=64)
    p_d.add_argument("--enc-len", type=int, default=None, dest="enc_len",
                     help="encoder read length per window "
                          "(default: context // 2)")
    p_d.add_argument("--lam", type=float, default=0.1,
                     help="group-lasso strength; larger = sparser graph")
    p_d.add_argument("--lr", type=float, default=None,
                     help="learning rate (default 5e-2)")
    p_d.add_argument("--family", choices=("crvae", "win"), default="crvae",
                     help="causal parameterisation: crvae = GRU input-"
                          "weight column groups; win = explicit per-head "
                          "W_in matrices")
    p_d.add_argument("--prox", choices=("row", "element"), default=None,
                     help="win family: sparsity groups (default row)")
    p_d.add_argument("--latent", type=int, default=32,
                     help="win family: latent width")
    p_d.add_argument("--iters", type=int, default=2000)
    p_d.add_argument("--batch", type=int, default=256)
    p_d.add_argument("--seeds", type=int, default=1,
                     help=">1: multi-seed sweep + stability-selection "
                          "voting instead of a single-run threshold")
    p_d.add_argument("--seed", type=int, default=0)
    p_d.add_argument("--threshold", default="auto",
                     help="score threshold (seeds=1): float or 'auto'")
    p_d.add_argument("--min-frac", default="auto", dest="min_frac",
                     help="vote threshold (seeds>1): float in [0,1] or 'auto'")
    p_d.add_argument("--no-standardize", action="store_true",
                     dest="no_standardize",
                     help="skip per-variable z-scoring of the input")
    p_d.add_argument("--diff", action="store_true",
                     help="first-difference the series along time before "
                          "standardizing (for smooth densely sampled flows "
                          "where discovery reads confidently dense)")
    p_d.add_argument("--generate", type=int, default=0, metavar="BATCH",
                     help="also train phase 2 on the selected graph and "
                          "sample BATCH synthetic rollouts")
    p_d.add_argument("--phase2-iters", type=int, default=None,
                     dest="phase2_iters")
    p_d.add_argument("--shape", type=int, nargs="+", default=None,
                     help="shape for raw float32 files, e.g. --shape 8192 20")
    p_d.add_argument("--delimiter", default=None,
                     help="text-file delimiter override")
    p_d.add_argument("--out-dir", default=None,
                     help="write GC/scores/votes .npy, the discovery "
                          "heatmap and a JSON summary here")
    p_d.add_argument("--quiet", action="store_true")
    _device_arg(p_d)
    p_d.add_argument("--mesh", action="store_true",
                     help="shard the fit (crvae: batch over dp, heads over "
                          "ep) and the seed sweep (seeds over dp)")
    p_d.add_argument("--ep", type=int, default=1)
    p_d.set_defaults(fn=_cmd_discover)

    p_e = sub.add_parser("eval", help="evaluate / generate from a checkpoint")
    p_e.add_argument("experiment", help="experiment name (model geometry)")
    p_e.add_argument("checkpoint", help="ckpt_phase1 (crvae), ckpt_win "
                                        "(win), ckpt_vrae or ckpt_csrae from "
                                        "run --save-checkpoints")
    p_e.add_argument("--seed", type=int, default=0)
    p_e.add_argument("--generate", type=int, default=0, metavar="BATCH",
                     help="also sample BATCH free-running rollouts")
    p_e.add_argument("--out", default=None, help=".npy path for samples")
    _device_arg(p_e)
    p_e.set_defaults(fn=_cmd_eval)

    p_x = sub.add_parser("export", help="export a phase-2 checkpoint as a "
                                        "generator artifact")
    p_x.add_argument("experiment", help="experiment name (model geometry)")
    p_x.add_argument("checkpoint", help="ckpt_phase2 (crvae) or ckpt_win "
                                        "(win) from run --save-checkpoints")
    p_x.add_argument("--out", required=True, help="artifact path (.vcxt)")
    p_x.add_argument("--batch", type=int, default=64,
                     help="rollouts per call (baked into the artifact)")
    p_x.add_argument("--length", type=int, default=None,
                     help="rollout length override")
    p_x.add_argument("--serve-dtype", choices=["float32", "bfloat16"],
                     default=None,
                     help="bfloat16: bf16 weights and carries through the "
                          "rollout kernels' bf16 instantiations")
    p_x.add_argument("--serve-kernel", choices=["auto", "lax", "fused"],
                     default="lax",
                     help="kept for the reference's signature: every value "
                          "serves through the CUDA rollout kernels")
    p_x.add_argument("--platforms", nargs="+", default=None,
                     choices=["cuda", "cpu"],
                     help="devices the artifact may run on (default: the "
                          "--device it is exported on)")
    _device_arg(p_x)
    p_x.set_defaults(fn=_cmd_export)

    p_g = sub.add_parser("generate", help="sample from an artifact")
    p_g.add_argument("artifact", help="artifact path from export")
    p_g.add_argument("--seed", type=int, default=0)
    p_g.add_argument("--out", default=None, help=".npy path for samples")
    p_g.add_argument("--context", default=None,
                     help=".npy context windows (batch, >=tau, p) for "
                          "context-conditioned (win-family) artifacts")
    _device_arg(p_g)
    p_g.set_defaults(fn=_cmd_generate)

    p_s = sub.add_parser("serve", help="HTTP serving daemon for artifacts "
                                       "(GET /healthz /artifacts "
                                       "/meta[/<name>], POST "
                                       "/generate[/<name>] with optional "
                                       "n_samples)")
    p_s.add_argument("artifact", nargs="+",
                     help="artifact path(s); the first is the default "
                          "route, each is also served at "
                          "/generate/<file-stem>")
    p_s.add_argument("--host", default="127.0.0.1")
    p_s.add_argument("--port", type=int, default=8799)
    _device_arg(p_s)
    p_s.set_defaults(fn=_cmd_serve)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
