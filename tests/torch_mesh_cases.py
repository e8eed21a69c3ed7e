"""The rank side of the port's mesh tests (run by ``tests/torch_ranks.py``
in gloo CPU ranks; imports no JAX).

Each function runs every case of one test module in one rank group and
has rank 0 write ``results.pt`` under the output directory: the JAX-held
cases' outputs (their inputs come from ``inputs.pt``, written by the test
from the JAX package's draws) and, for the port-against-itself cases, the
meshed and the single-process results side by side.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from vae_connexe_torch.convert import from_numpy
from vae_connexe_torch.models import CRVAE, CRVAEParams, ErrorVAE
from vae_connexe_torch.models.error_vae import ErrorVAEParams
from vae_connexe_torch.models.gmm_prior import GMMPrior
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.optim.adam import adam_init
from vae_connexe_torch.parallel.mesh import (
    gather_tree,
    global_device_put,
    make_mesh,
)
from vae_connexe_torch.utils.tree import tree_leaves

CPU = "cpu"


def _np(tree) -> list:
    return [x.detach().numpy().copy() for x in tree_leaves(tree)]


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


def _save(out, res: dict) -> None:
    if dist.get_rank() == 0:
        torch.save(res, out / "results.pt")


# ---------------- test_torch_port_parallel.py ----------------

def parallel_cases(out) -> None:
    """Four ranks: the sharded steps on a (2, 2) mesh from JAX's inputs;
    meshed fits (dp and ep), a killed and resumed meshed fit, phase 2, the
    sweep's and fit_many's seed axes, sharded serving and a streamed
    meshed fit, each beside the single-process result."""
    from vae_connexe_torch.parallel.sharded import (
        make_sharded_phase1_step,
        make_sharded_phase2_step,
    )
    from vae_connexe_torch.train import Phase1Config, Phase2Config

    inp = torch.load(out / "inputs.pt")
    cfg = inp["cfg"]
    p, hidden, enc_len = cfg["p"], cfg["hidden"], cfg["enc_len"]
    model = CRVAE(p=p, hidden=hidden, enc_len=enc_len)
    err_model = ErrorVAE(d=p, hidden=cfg["err_hidden"])
    params = from_numpy(CRVAEParams, inp["params"], CPU)
    err_params = from_numpy(ErrorVAEParams, inp["err_params"], CPU)
    prior = from_numpy(GMMPrior, inp["prior"], CPU)
    parents = torch.ones((p, p))
    res = {}

    mesh22 = make_mesh(n_dp=2, n_ep=2)
    p1 = dict(lam=cfg["lam"], lr=cfg["lr"], batch_size=cfg["batch"],
              lam_ridge=cfg["lam_ridge"])
    for reg in ("kl", "cs"):
        extra = ({} if reg == "kl" else
                 dict(latent_reg="cs", lambda_cs=cfg["lambda_cs"],
                      gmm_components=cfg["k"]))
        step, shard, _ = make_sharded_phase1_step(
            model, Phase1Config(**p1, **extra), mesh22, parents)
        local = global_device_put(params, shard)
        if reg == "kl":
            new, met = step(local, inp["batch"], inp["eps"])
            new_prior = None
        else:
            new, new_prior, met = step(local, prior, inp["batch"],
                                       inp["eps"])
        res[f"step1_{reg}"] = (_np(gather_tree(new, shard)),
                               _np(new_prior), _floats(met))
        step2, shard, _ = make_sharded_phase2_step(
            model, err_model,
            Phase2Config(lr=cfg["lr"], batch_size=cfg["batch"],
                         lam_ridge=cfg["lam_ridge"], **extra),
            mesh22, parents)
        local = global_device_put(params, shard)
        opt = adam_init(err_params)
        if reg == "kl":
            new, new_err, _, met = step2(local, err_params, opt,
                                         inp["batch"], inp["eps2"],
                                         inp["eps_err"])
            new_prior = None
        else:
            new, new_prior, new_err, _, met = step2(
                local, prior, err_params, opt, inp["batch"], inp["eps2"],
                inp["eps_err"])
        res[f"step2_{reg}"] = (_np(gather_tree(new, shard)), _np(new_err),
                               _np(new_prior), _floats(met))

    _fits(out, res, model, err_model, params, err_params, parents, inp,
          mesh22)
    _seed_axes(res, inp)
    _serving(res, model, err_model, params, err_params)
    _save(out, res)


def _fits(out, res, model, err_model, params, err_params, parents, inp,
          mesh22) -> None:
    from vae_connexe_torch.train import (
        Phase1Config,
        Phase2Config,
        fit_phase1,
        fit_phase1_streaming,
        fit_phase2,
        fit_phase2_streaming,
    )

    windows = inp["windows"]
    cfg = Phase1Config(lam=0.1, lr=5e-2, max_iter=12, check_every=4,
                       batch_size=16)
    mesh41 = make_mesh(n_dp=4, n_ep=1)
    single = fit_phase1(model, params, windows, parents, cfg,
                        torch.Generator().manual_seed(2))
    res["fit1_single"] = (_np(single[0]), single[2])
    for name, mesh in (("22", mesh22), ("41", mesh41)):
        best, state, met = fit_phase1(model, params, windows, parents, cfg,
                                      torch.Generator().manual_seed(2),
                                      mesh=mesh)
        res[f"fit1_{name}"] = (_np(best), met, int(state.step))
        all_met = [None] * dist.get_world_size()
        dist.all_gather_object(all_met, met)
        res[f"fit1_{name}_every_rank"] = all_met
    # Killed after the step-8 snapshot, resumed: the uninterrupted fit.
    ck = str(out / "ckpt")

    def kill(step, state, metrics):
        if step >= 8:
            raise KeyboardInterrupt

    try:
        fit_phase1(model, params, windows, parents, cfg,
                   torch.Generator().manual_seed(2), mesh=mesh22,
                   checkpoint_dir=ck, checkpoint_every=4, callback=kill)
    except KeyboardInterrupt:
        pass
    best, state, met = fit_phase1(model, params, windows, parents, cfg,
                                  torch.Generator().manual_seed(99),
                                  mesh=mesh22, checkpoint_dir=ck,
                                  checkpoint_every=4, resume=True)
    res["fit1_resumed"] = (_np(best), met, int(state.step))
    # Phase 2 at (2, 2).
    cfg2 = Phase2Config(lr=5e-2, max_iter=8, check_every=4, batch_size=16)
    got = fit_phase2(model, err_model, params, err_params, windows, parents,
                     cfg2, torch.Generator().manual_seed(4), mesh=mesh22)
    want = fit_phase2(model, err_model, params, err_params, windows, parents,
                      cfg2, torch.Generator().manual_seed(4))
    res["fit2"] = ((_np(got[0]), _np(got[1]), got[3]),
                   (_np(want[0]), _np(want[1]), want[3]))
    # Streamed and meshed: each rank gathers its dp slice of each batch.
    from vae_connexe_torch.data import arrange_input
    from vae_connexe_torch.data.native_loader import NativeWindowLoader

    series = inp["series"]
    ctx = windows.shape[1]
    loader = NativeWindowLoader.from_array(series.numpy())
    mem_windows, _ = arrange_input(series, ctx)
    got = fit_phase1_streaming(model, params, loader, ctx, parents, cfg,
                               torch.Generator().manual_seed(5), mesh=mesh22)
    want = fit_phase1(model, params, mem_windows, parents, cfg,
                      torch.Generator().manual_seed(5), mesh=mesh22)
    res["stream1"] = ((_np(got[0]), got[2]), (_np(want[0]), want[2]))
    got = fit_phase2_streaming(model, err_model, params, err_params, loader,
                               ctx, parents, cfg2,
                               torch.Generator().manual_seed(6), mesh=mesh22)
    want = fit_phase2(model, err_model, params, err_params, mem_windows,
                      parents, cfg2, torch.Generator().manual_seed(6),
                      mesh=mesh22)
    res["stream2"] = ((_np(got[0]) + _np(got[1]), got[3]),
                      (_np(want[0]) + _np(want[1]), want[3]))
    loader.close()


def _seed_axes(res, inp) -> None:
    """The sweep's seeds (3, padded to 4) and fit_many's (4) over dp=4."""
    from vae_connexe_torch.models.crvae_win import WInCRVAE
    from vae_connexe_torch.parallel.seed_sweep import sweep_phase1
    from vae_connexe_torch.train import Phase1Config, WInTrainConfig
    from vae_connexe_torch.train.win_trainer import WInTrainer
    from vae_connexe_torch.utils.tree import stack_trees

    mesh41 = make_mesh(n_dp=4, n_ep=1)
    p = 4
    model = CRVAE(p=p, hidden=8, enc_len=6)
    cfg = Phase1Config(lam=0.1, lr=5e-2, max_iter=5, batch_size=8)
    windows = inp["windows"]
    ones = torch.ones((p, p))
    got = sweep_phase1(model, windows, ones, cfg, [0, 1, 2], mesh=mesh41)
    want = sweep_phase1(model, windows, ones, cfg, [0, 1, 2])
    res["sweep"] = ({k: v.numpy() for k, v in got.items()},
                    {k: v.numpy() for k, v in want.items()})
    wmodel = WInCRVAE(d=p, hidden=8, latent=4, tau=3)
    trainer = WInTrainer(wmodel, WInTrainConfig(batch_size=8,
                                                stage1_epochs=2,
                                                stage2_epochs=1))
    wwin = inp["win_windows"]
    inits = [wmodel.init(torch.Generator().manual_seed(10 + s), CPU)
             for s in range(4)]

    def gens():
        return [torch.Generator().manual_seed(20 + s) for s in range(4)]

    got = trainer.fit_many(stack_trees(inits), wwin, gens(), mesh=mesh41)
    want = trainer.fit_many(stack_trees(inits), wwin, gens())
    res["fit_many"] = ((_np(got[0]), {k: v.numpy() for k, v in got[1].items()}),
                       (_np(want[0]),
                        {k: v.numpy() for k, v in want[1].items()}))


def _serving(res, model, err_model, params, err_params) -> None:
    from vae_connexe_torch.parallel.serve import make_sharded_generator
    from vae_connexe_torch.train import generate_with_compensation

    mesh = make_mesh(n_dp=2, n_ep=2)
    parents = torch.ones((model.p, model.p))
    for dtype in (None, "bfloat16"):
        gen = make_sharded_generator(model, err_model, mesh, 8,
                                     parents=parents, dtype=dtype)
        got = gen(params, err_params, torch.Generator().manual_seed(7))
        want = generate_with_compensation(model, err_model, params,
                                          err_params,
                                          torch.Generator().manual_seed(7),
                                          8, parents=parents, dtype=dtype)
        res[f"serve_{dtype}"] = (got.numpy(), want.numpy())
    try:
        make_sharded_generator(model, err_model, mesh, 6)
    except ValueError as e:
        res["serve_indivisible"] = str(e)


# ---------------- test_torch_port_seq_parallel.py ----------------

def seq_cases(out) -> None:
    """Four ranks: ``seq_sharded_gru_heads`` forward and gradients at sp =
    4 and sp = 2 (a (2, 1, 2) mesh, with and without the batch over dp)
    on JAX's inputs; ``seq_sharded_gru``; sp fits beside the
    single-process fits (phase 1 and phase 2)."""
    from vae_connexe_torch.parallel.seq_parallel import (
        seq_sharded_gru,
        seq_sharded_gru_heads,
    )

    inp = torch.load(out / "inputs.pt")
    res = {}
    meshes = {4: make_mesh(n_dp=1, n_ep=1, n_sp=4),
              2: make_mesh(n_dp=2, n_ep=1, n_sp=2)}
    for n_sp, batch_axis in ((4, None), (2, None), (2, "dp")):
        mesh = meshes[n_sp]
        d = _axis(mesh, "dp")
        leaves = [inp["heads"][k].clone().requires_grad_(True)
                  for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
        x, h0 = inp["x"], inp["h0"]
        w_out, w_h = inp["w_out"], inp["w_h"]
        if batch_axis is not None:
            b = x.shape[0] // 2
            x, h0 = x[d * b:(d + 1) * b], h0[:, d * b:(d + 1) * b]
            w_out, w_h = w_out[:, d * b:(d + 1) * b], w_h[:, d * b:(d + 1) * b]
        x = x.clone().requires_grad_(True)
        h0 = h0.clone().requires_grad_(True)
        outs, h_t = seq_sharded_gru_heads(GRUParams(*leaves), x, h0, mesh,
                                          batch_axis=batch_axis)
        loss = (outs * w_out).sum() + (h_t * w_h).sum()
        grads = torch.autograd.grad(loss, leaves + [x, h0])
        key = f"sp{n_sp}_{batch_axis}"
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, (
            outs.detach().numpy(), h_t.detach().numpy(),
            [g.numpy() for g in grads]))
        res[key] = per_rank
    # seq_sharded_gru: one GRU as a one-head stack, at sp = 4.
    single = [inp["heads"][k][0].clone().requires_grad_(True)
              for k in ("w_ih", "w_hh", "b_ih", "b_hh")]
    outs, h_t = seq_sharded_gru(GRUParams(*single), inp["x"],
                                inp["h0"][0], meshes[4])
    res["single"] = (outs.detach().numpy(), h_t.detach().numpy())
    _sp_fits(res, inp, meshes[2])
    _save(out, res)


def _axis(mesh, name):
    from vae_connexe_torch.parallel.mesh import axis_index

    return axis_index(mesh, name)


def _sp_fits(res, inp, mesh) -> None:
    """fit_phase1 and fit_phase2 on a (2, 1, 2) mesh: the decoder through
    the sp pipeline, the batch over dp."""
    from vae_connexe_torch.train import (
        Phase1Config,
        Phase2Config,
        fit_phase1,
        fit_phase2,
    )

    p = 4
    model = CRVAE(p=p, hidden=8, enc_len=4)
    params = model.init(torch.Generator().manual_seed(1), CPU)
    windows = inp["windows"]
    ones = torch.ones((p, p))
    cfg = Phase1Config(lam=0.1, lr=5e-2, max_iter=6, check_every=3,
                       batch_size=8)
    got = fit_phase1(model, params, windows, ones, cfg,
                     torch.Generator().manual_seed(2), mesh=mesh)
    want = fit_phase1(model, params, windows, ones, cfg,
                      torch.Generator().manual_seed(2))
    res["sp_fit1"] = ((_np(got[0]), got[2]), (_np(want[0]), want[2]))
    err = ErrorVAE(d=p, hidden=8)
    eparams = err.init(torch.Generator().manual_seed(3), CPU)
    cfg2 = Phase2Config(lr=5e-2, max_iter=4, check_every=2, batch_size=8)
    got = fit_phase2(model, err, params, eparams, windows, ones, cfg2,
                     torch.Generator().manual_seed(4), mesh=mesh)
    want = fit_phase2(model, err, params, eparams, windows, ones, cfg2,
                      torch.Generator().manual_seed(4))
    res["sp_fit2"] = ((_np(got[0]), _np(got[1]), got[3]),
                      (_np(want[0]), _np(want[1]), want[3]))

