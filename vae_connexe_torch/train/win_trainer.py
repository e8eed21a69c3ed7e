"""Two-stage trainer of the explicit-W_in CRVAE (port of
``vae_connexe_tpu/train/win_trainer.py``).

Stage I, causal discovery: Adam on every leaf except W_in, which has no
Adam moments; W_in takes an ISTA step a batch, a gradient step of
``lr_prox`` (default ``lr``) then ``PROX_FNS[prox_groups]`` (row groups or
element-wise L1).  Stage II, generation with error compensation: the
support is frozen by ``prune`` (sub-threshold entries hard-zeroed), then
W_in is either frozen or, with ``update_w_in_stage2``, takes gradient
steps masked by its pre-update support at the prox's granularity; the
loss adds the error VAE's KL / Z_e.

An epoch is one permutation of the windows, the remainder dropped (n =
(N // bs) * bs), then consecutive batches.  The draws come from each
fit's ``torch.Generator``: at each epoch's start the permutation, then at
each step eps_z (B, Z) and, in stage II, the error VAE's eps_e (B, Z//2)
(the order of the reference's ``k_z``/``k_e`` split).  JAX's threefry keys
give other numbers, so fits match the JAX package draw for draw only
when the draws are passed in (``step_stage1``/``step_stage2`` take them).

Every step runs on parameters stacked on a leading seed axis:
``fit_many`` trains S inits at once, the seeds folded into B1/B2's heads
(``WInCRVAE.forward_stacked``): the encoder is one S-head launch on each
seed's own batch, the decoder one S * D-head launch on the per-head
``x_sel``, and in stage II the error VAE's encoder and decoder one S-head
launch each: 2 B1 + 2 B2 launches a stage-I step and 4 + 4 a stage-II
step, at any S.  Adam, the ISTA step, the prune and the support mask act
element by element over the stacked leaves; one backward of the sum of
the seeds' losses gives each seed its own gradient.  ``fit`` is the same
loop at S = 1, so seed s of ``fit_many`` follows ``fit`` with seed s's
generators (to rounding: the kernels sum in another order at S * D heads
than at D).  The host reads the metrics once a block of
``epochs_per_dispatch`` epochs, never inside the step loop.

``fit_many(mesh=)`` (``parallel/mesh.py``) splits the seed axis over dp,
as the JAX package's shards it: each rank trains its slice of the seeds
(still 2 + 2 / 4 + 4 launches a step) and the stacked results are
gathered over dp, so every rank returns every seed's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch.losses.kl import kl_gaussian, kl_gaussian_logsigma
from vae_connexe_torch.models.crvae_win import WInCRVAE, WInCRVAEParams
from vae_connexe_torch.models.error_vae import ErrorVAEParams
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.optim.adam import AdamState, adam_init, adam_update
from vae_connexe_torch.optim.prox import PROX_FNS
from vae_connexe_torch.train.config import WInTrainConfig
from vae_connexe_torch.utils import debug
from vae_connexe_torch.utils.layers import Dense
from vae_connexe_torch.utils.tree import (
    stack_trees,
    tree_leaves,
    tree_map,
    tree_unflatten,
    unstack_tree,
)


@dataclasses.dataclass(frozen=True)
class AdamLeaves:
    """The leaves Adam updates: every ``WInCRVAEParams`` leaf but w_in."""

    enc: GRUParams
    fc_mu: Dense
    fc_logsig: Dense
    z2h: Dense
    heads: GRUParams
    readout: Dense
    err: ErrorVAEParams


def adam_leaves(params: WInCRVAEParams) -> AdamLeaves:
    return AdamLeaves(**{f.name: getattr(params, f.name)
                         for f in dataclasses.fields(AdamLeaves)})


def _with_w_in(rest: AdamLeaves, w_in: torch.Tensor) -> WInCRVAEParams:
    return WInCRVAEParams(w_in=w_in, **{f.name: getattr(rest, f.name)
                                        for f in dataclasses.fields(rest)})


@dataclasses.dataclass
class WInTrainState:
    params: WInCRVAEParams
    opt_state: AdamState       # moments of ``adam_leaves(params)``
    generator: object          # a torch.Generator; a list of them, one a
                               # seed, when the leaves carry a seed axis
    step: int


class WInTrainer:
    def __init__(self, model: WInCRVAE, cfg: WInTrainConfig):
        self.model = model
        self.cfg = cfg
        self.prox = PROX_FNS[cfg.prox_groups]

    def init_state(self, params: WInCRVAEParams, generator) -> WInTrainState:
        """Zero Adam moments for every leaf but w_in, and step 0."""
        return WInTrainState(params=params,
                             opt_state=adam_init(adam_leaves(params)),
                             generator=generator, step=0)

    # ---------------- one step, on seed-stacked parameters ----------------

    def _loss(self, params, x_past, x_cur, eps_z, eps_e, stage):
        """Per-seed loss (S,) and its parts: mean squared error + the
        log-sigma KL (mean), plus KL(error VAE) / Z_e in stage II."""
        recon, mu, logsig, mu_e, logvar_e = self.model.forward_stacked(
            params, x_past, x_cur, eps_z, stage, eps_e)
        recon_loss = torch.mean((recon - x_cur) ** 2, dim=(1, 2, 3))
        kl = kl_gaussian_logsigma(mu, logsig, "mean", keep=1)
        loss = recon_loss + kl
        if stage == 2:
            loss = loss + kl_gaussian(mu_e, logvar_e, keep=1) / mu_e.shape[-1]
        return loss, {"recon": recon_loss, "kl": kl}

    def _update(self, stage: int, params: WInCRVAEParams, opt: AdamState,
                batch: torch.Tensor, eps_z: torch.Tensor,
                eps_e: Optional[torch.Tensor]):
        """One update of S stacked seeds on batch (S, B, 2 tau, D):
        returns (params, Adam state, metrics of (S,) tensors)."""
        cfg, tau = self.cfg, self.model.tau
        with torch.enable_grad():
            live = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, aux = self._loss(live, batch[:, :, :tau],
                                   batch[:, :, tau:2 * tau], eps_z, eps_e,
                                   stage)
            debug.check_finite("the loss", loss)
            # Stage I leaves the error VAE out of the loss: its gradients
            # are zeros, as JAX's, so its Adam moments stay zero and its
            # leaves unchanged.
            grads = tree_unflatten(params, torch.autograd.grad(
                loss.sum(), tree_leaves(live), materialize_grads=True))
        with torch.no_grad():
            rest, opt = adam_update(adam_leaves(grads), opt,
                                    adam_leaves(params), cfg.lr)
            lr_prox = cfg.lr if cfg.lr_prox is None else cfg.lr_prox
            w_in = params.w_in
            if stage == 1:
                w_in = self.prox(w_in - lr_prox * grads.w_in, cfg.lam, lr_prox)
            elif cfg.update_w_in_stage2:
                # Masked gradient step on the frozen support, at the
                # prox's granularity.
                w_in = w_in - lr_prox * grads.w_in * self._support_mask(w_in)
        metrics = {"loss": loss.detach(), "recon": aux["recon"].detach(),
                   "kl": aux["kl"].detach()}
        return _with_w_in(rest, w_in), opt, metrics

    def _draws(self, generators, b: int, stage: int, dev):
        """Each seed's eps_z (B, Z), then in stage II its eps_e (B, Z//2),
        from its own generator -> stacked (S, B, .) on ``dev``."""
        m = self.model
        eps_z, eps_e = [], []
        for g in generators:
            eps_z.append(torch.randn((b, m.latent), generator=g,
                                     device=g.device))
            if stage == 2:
                eps_e.append(torch.randn((b, m.err_vae.latent), generator=g,
                                         device=g.device))
        return (torch.stack(eps_z).to(dev),
                torch.stack(eps_e).to(dev) if eps_e else None)

    def _step(self, stage: int, state: WInTrainState, batch: torch.Tensor,
              eps_z=None, eps_e=None):
        """One step of a single (unstacked) state on batch (B, 2 tau, D);
        the draws are passed in or drawn from ``state.generator``."""
        if eps_z is None or (stage == 2 and eps_e is None):
            dz, de = self._draws([state.generator], batch.shape[0], stage,
                                 batch.device)
            eps_z = dz[0] if eps_z is None else eps_z
            eps_e = (de[0] if de is not None else None) if eps_e is None \
                else eps_e
        one = lambda t: t[None]   # noqa: E731
        params, opt, metrics = self._update(
            stage, tree_map(one, state.params),
            AdamState(state.opt_state.count, tree_map(one, state.opt_state.mu),
                      tree_map(one, state.opt_state.nu)),
            batch[None], eps_z.to(batch.device)[None],
            None if eps_e is None else eps_e.to(batch.device)[None])
        first = lambda t: t[0]    # noqa: E731
        return WInTrainState(
            params=tree_map(first, params),
            opt_state=AdamState(opt.count, tree_map(first, opt.mu),
                                tree_map(first, opt.nu)),
            generator=state.generator, step=state.step + 1), \
            {k: v[0] for k, v in metrics.items()}

    def step_stage1(self, state: WInTrainState, batch: torch.Tensor,
                    eps_z: Optional[torch.Tensor] = None):
        """One stage-I step: (new state, metrics of 0-d tensors)."""
        return self._step(1, state, batch, eps_z)

    def step_stage2(self, state: WInTrainState, batch: torch.Tensor,
                    eps_z: Optional[torch.Tensor] = None,
                    eps_e: Optional[torch.Tensor] = None):
        """One stage-II step: (new state, metrics of 0-d tensors)."""
        return self._step(2, state, batch, eps_z, eps_e)

    # ---------------- support ----------------

    def _support_mask(self, w_in: torch.Tensor) -> torch.Tensor:
        """Nonzero-structure mask at the prox's granularity: per element for
        L1, per row for row groups (a row with one surviving element must
        not revive its pruned siblings under element-wise prox)."""
        thr = self.cfg.prune_threshold
        if self.cfg.prox_groups == "element":
            mask = w_in.abs() > thr
        else:
            mask = torch.linalg.vector_norm(w_in, dim=-1, keepdim=True) > thr
        return mask.to(w_in.dtype)

    def prune(self, params: WInCRVAEParams) -> WInCRVAEParams:
        """Stage-I -> stage-II handoff: hard-zero sub-threshold W_in
        entries."""
        mask = (params.w_in.abs() > self.cfg.prune_threshold).to(
            params.w_in.dtype)
        return dataclasses.replace(params, w_in=params.w_in * mask)

    # ---------------- the epoch loop ----------------

    def _run_stage(self, stage, state, windows, epochs, epochs_per_dispatch,
                   verbose=False, log_fn=print, label=""):
        """``epochs`` epochs of the stacked ``state``; returns (state, the
        last epoch's mean metrics as (S,) tensors, read once a block)."""
        bs = self.cfg.batch_size
        n_win = windows.shape[0]
        n_batches = n_win // bs
        gens = state.generator
        params, opt = state.params, state.opt_state
        m = {}
        done = 0
        while done < epochs:
            k = min(epochs_per_dispatch, epochs - done)
            for epoch in range(done, done + k):
                perm = torch.stack([
                    torch.randperm(n_win, generator=g, device=g.device)
                    for g in gens]).to(windows.device)
                sums = None
                for i in range(n_batches):
                    batch = windows[perm[:, i * bs:(i + 1) * bs]]
                    eps_z, eps_e = self._draws(gens, bs, stage,
                                               windows.device)
                    with debug.at_step(f"stage{stage} epoch {epoch} batch "
                                       f"{i}"):
                        params, opt, met = self._update(stage, params, opt,
                                                        batch, eps_z, eps_e)
                        debug.check_finite(
                            "the metrics and updated parameters", met, params)
                    sums = met if sums is None else {
                        key: sums[key] + v for key, v in met.items()}
                if sums is not None:
                    m = {key: v / n_batches for key, v in sums.items()}
            done += k
            if verbose:
                log_fn(f"[{label} epoch={done}] " + " ".join(
                    f"{key}={float(v[0]):.5f}" for key, v in m.items()))
        return (WInTrainState(params=params, opt_state=opt, generator=gens,
                              step=state.step + epochs * n_batches), m)

    def _fit_stacked(self, params_stack, windows, generators, e1, e2,
                     epochs_per_dispatch, verbose=False, log_fn=print):
        state = self.init_state(params_stack, list(generators))
        state, m1 = self._run_stage(1, state, windows, e1,
                                    epochs_per_dispatch, verbose, log_fn,
                                    "stage1")
        stage1_params = state.params
        state = dataclasses.replace(state, params=self.prune(state.params))
        state, m2 = self._run_stage(2, state, windows, e2,
                                    epochs_per_dispatch, verbose, log_fn,
                                    "stage2")
        return state.params, m2 or m1, stage1_params

    def fit(self, params: WInCRVAEParams, windows: torch.Tensor,
            generator: torch.Generator, stage1_epochs: int | None = None,
            stage2_epochs: int | None = None, epochs_per_dispatch: int = 25,
            verbose: bool = False, log_fn=print, return_stage1: bool = False):
        """Epoch loop over shuffled minibatches of windows (N, 2 tau, D) on
        the device the fit runs on.  Returns (params after stage II, last
        metrics as floats), or with ``return_stage1=True`` also the
        pre-prune stage-I params."""
        cfg = self.cfg
        e1 = cfg.stage1_epochs if stage1_epochs is None else stage1_epochs
        e2 = cfg.stage2_epochs if stage2_epochs is None else stage2_epochs
        out, m, s1 = self._fit_stacked(stack_trees([params]), windows,
                                       [generator], e1, e2,
                                       epochs_per_dispatch, verbose, log_fn)
        metrics = {k: float(v[0]) for k, v in m.items()}
        if return_stage1:
            return unstack_tree(out, 0), metrics, unstack_tree(s1, 0)
        return unstack_tree(out, 0), metrics

    def fit_many(self, params_stack: WInCRVAEParams, windows: torch.Tensor,
                 generators, stage1_epochs: int | None = None,
                 stage2_epochs: int | None = None,
                 epochs_per_dispatch: int = 25, mesh=None):
        """Train S inits at once, their seeds folded into the kernels'
        heads.  ``params_stack`` has every leaf stacked on axis 0 (S, ...);
        ``generators`` is one run generator a seed (JAX: ``keys``).  Seed s
        follows ``fit(params[s], windows, generators[s])``.  ``mesh``: the
        seed axis over dp (S must divide by dp); every rank gets every
        seed's results.  Returns (params_stack after stage II, {metric:
        (S,) last value})."""
        cfg = self.cfg
        e1 = cfg.stage1_epochs if stage1_epochs is None else stage1_epochs
        e2 = cfg.stage2_epochs if stage2_epochs is None else stage2_epochs
        generators = list(generators)
        group = None
        if mesh is not None:
            from vae_connexe_torch.parallel.mesh import (
                axis_group,
                axis_index,
                axis_size,
                check_mesh,
            )

            check_mesh(mesh)
            n_dp, s = axis_size(mesh, "dp"), len(generators)
            if s % n_dp:
                raise ValueError(
                    f"{s} seeds not divisible by the dp mesh size {n_dp} — "
                    f"pad the seed count or shrink dp")
            k, d = s // n_dp, axis_index(mesh, "dp")
            params_stack = tree_map(lambda t: t[d * k:(d + 1) * k],
                                    params_stack)
            generators = generators[d * k:(d + 1) * k]
            group = axis_group(mesh, "dp")
        out, m, _ = self._fit_stacked(params_stack, windows, generators, e1,
                                      e2, epochs_per_dispatch)
        if group is not None:
            from vae_connexe_torch.parallel.collectives import cat_gather

            out = tree_map(lambda t: cat_gather(t, group), out)
            m = {key: cat_gather(v, group) for key, v in m.items()}
        return out, m
