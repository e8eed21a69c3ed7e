"""Mesh-sharded training steps (port of
``vae_connexe_tpu/parallel/sharded.py``).

The JAX steps are jitted over a (dp, ep) mesh and XLA inserts the
collectives.  Here each rank runs the step on what it holds:

- its dp slice of the batch (and of every batch-shaped draw);
- its p / ep decoder heads, their readout rows and parents-mask rows;
- replicated copies of the encoder, the fc layers, the GMM prior, the
  ErrorVAE and its Adam state.

The loss is computed on local data and local heads through
``model.forward`` (on the card B1/B2 on the rank's heads), and its terms
are counted once (``RankLayout``): recon is the rank's share of each
variable's mean over B and T, summed over its heads; the ridge is counted
on the dp-index-0 ranks, the KL or CS term (the encoder's own share) on
the ep-index-0 ranks.  Then the gradients are summed in rank order
(``parallel/collectives.py::ordered_sum``): the encoder's, the fc layers'
and the prior's over every rank (the ranks of one sp index when the mesh
has sp: the sp pipeline has summed the sp line already), the heads' and
the ErrorVAE's over dp only; the scalar terms over every rank.  SGD, the
mask projection and the prox then run locally (a head's column groups
live on one rank), Adam too.

A mesh of one rank runs the same arithmetic as the unmeshed step, bit for
bit: its sums are of one part and its batch share is the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vae_connexe_torch.models.crvae import CRVAE, CRVAEParams
from vae_connexe_torch.ops.gru import GRUParams
from vae_connexe_torch.parallel import collectives as coll
from vae_connexe_torch.parallel.mesh import (
    Sharding,
    axis_group,
    check_mesh,
    axis_index,
    axis_size,
    batch_sharding,
    head_sharding,
)
from vae_connexe_torch.train.config import Phase1Config
from vae_connexe_torch.utils.layers import Dense
from vae_connexe_torch.utils.tree import tree_leaves


def crvae_param_spec() -> CRVAEParams:
    """The mesh axis each CRVAEParams leaf's leading axis is split over:
    ``"ep"`` for the heads and readout, None (replicated) for the rest
    (JAX's PartitionSpec tree)."""
    rep2 = Dense(w=None, b=None)
    return CRVAEParams(
        enc=GRUParams(w_ih=None, w_hh=None, b_ih=None, b_hh=None),
        fc_mu=rep2, fc_std=rep2,
        heads=GRUParams(w_ih="ep", w_hh="ep", b_ih="ep", b_hh="ep"),
        readout=Dense(w="ep", b="ep"))


def _named(mesh, spec_tree):
    """The spec tree's names as ``Sharding``s of ``mesh``."""
    def walk(t):
        if dataclasses.is_dataclass(t):
            return type(t)(**{f.name: walk(getattr(t, f.name))
                              for f in dataclasses.fields(t)})
        return Sharding(mesh, t)
    return walk(spec_tree)


def crvae_param_sharding(mesh) -> CRVAEParams:
    """CRVAEParams of ``Sharding``s: heads and readout over ep."""
    return _named(mesh, crvae_param_spec())


def phase1_state_sharding(mesh, with_prior: bool):
    """A ``Phase1State`` of shardings: params and best_params heads over
    ep, everything else (prior, best loss, generator, step) replicated.  A
    ``global_device_put``/``gather_tree`` target."""
    from vae_connexe_torch.train.crvae_trainer import Phase1State

    param_shard = crvae_param_sharding(mesh)
    rep = Sharding(mesh, None)
    return Phase1State(params=param_shard, prior=(rep if with_prior else None),
                       best_params=param_shard, best_loss=rep, generator=rep,
                       step=rep)


def phase2_state_sharding(mesh, with_prior: bool):
    """A ``Phase2State`` of shardings: CRVAE params over ep, the error
    VAE, its Adam state and the prior replicated."""
    from vae_connexe_torch.train.crvae_trainer import Phase2State

    param_shard = crvae_param_sharding(mesh)
    rep = Sharding(mesh, None)
    return Phase2State(params=param_shard, err_params=rep, err_opt=rep,
                       prior=(rep if with_prior else None),
                       best_params=param_shard, best_loss=rep, generator=rep,
                       step=rep)


def check_mesh_divisibility(mesh, p: int, batch_size: int) -> None:
    """Fail fast with actionable messages: the stacked head axis must
    divide by ep, the batch by dp."""
    check_mesh(mesh)
    n_ep, n_dp = axis_size(mesh, "ep"), axis_size(mesh, "dp")
    if p % n_ep:
        raise ValueError(
            f"p={p} decoder heads not divisible by the ep mesh size {n_ep} — "
            f"choose n_ep dividing p")
    if batch_size % n_dp:
        raise ValueError(
            f"batch_size={batch_size} not divisible by the dp mesh size "
            f"{n_dp} — choose a batch divisible by dp")


def check_sp_compat(mesh, t_dec: int) -> None:
    """Validate a mesh with an sp axis for sequence-parallel training: the
    decode length must divide by sp, and ep must be 1 (the sp pipeline
    runs the decode with replicated heads)."""
    n_sp = axis_size(mesh, "sp")
    if n_sp <= 1:
        return
    if axis_size(mesh, "ep") > 1:
        raise ValueError(
            f"sp={n_sp} and ep={axis_size(mesh, 'ep')} cannot both exceed 1: "
            f"the sp pipeline runs the decode with replicated head params, "
            f"which contradicts an ep-sharded head axis (documented won't-fix "
            f"— the axes' natural domains are disjoint; see "
            f"docs/parallelism.md 'sp × ep'); use ep for many-heads configs "
            f"OR sp for long-decode configs")
    if t_dec % n_sp:
        raise ValueError(
            f"decode length {t_dec} (window length - enc_len) not divisible "
            f"by the sp mesh size {n_sp} — pick a context so (context - "
            f"enc_len) divides by sp, or a dividing sp size")


@dataclasses.dataclass(frozen=True)
class RankLayout:
    """What a meshed step needs of its mesh: this rank's share of the batch
    and of the heads, which terms it counts, and its reduction groups."""

    mesh: object
    p: int
    batch: int            # the global batch

    @property
    def n_dp(self) -> int:
        return axis_size(self.mesh, "dp")

    @property
    def n_ep(self) -> int:
        return axis_size(self.mesh, "ep")

    @property
    def local_batch(self) -> int:
        return self.batch // self.n_dp

    @property
    def cols(self) -> slice:
        """The variables of this rank's heads."""
        k = self.p // self.n_ep
        e = axis_index(self.mesh, "ep")
        return slice(e * k, (e + 1) * k)

    @property
    def batch_scale(self) -> float:
        """This rank's share of a mean over the batch."""
        return self.local_batch / self.batch

    @property
    def count_heads(self) -> bool:
        """The ridge (a function of the heads alone) is counted on one
        rank of each dp line."""
        return axis_index(self.mesh, "dp") == 0

    @property
    def count_latent(self) -> bool:
        """The latent term (the encoder's own share) is counted on one
        rank of each ep line."""
        return axis_index(self.mesh, "ep") == 0

    def local(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's slice of a batch-shaped tensor given whole (leading
        axis the global batch) or already sliced (the local batch)."""
        if x is None or x.shape[0] == self.local_batch:
            return x
        if x.shape[0] != self.batch:
            raise ValueError(
                f"a batch-shaped input has leading axis {x.shape[0]}: "
                f"expected the batch {self.batch} or this rank's dp slice "
                f"{self.local_batch}")
        return batch_sharding(self.mesh).local(x)

    def heads_of(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a (p, ...) tensor (the parents mask)."""
        return head_sharding(self.mesh).local(x)

    def group(self, name: str):
        return axis_group(self.mesh, name)


def reduce_crvae_grads(layout: RankLayout, params: CRVAEParams, grads,
                       extra_rep=()):
    """Sum ``grads`` (CRVAEParams' leaves in field order, then the leaves of
    ``extra_rep``, e.g. the prior's) over the mesh: replicated leaves over
    every rank of this rank's sp index, head leaves over dp."""
    flags = _head_flags(params)
    n = len(flags)
    rep = [g for g, h in zip(grads[:n], flags) if not h] + list(grads[n:])
    heads = [g for g, h in zip(grads[:n], flags) if h]
    rep = coll.ordered_sum_flat(rep, layout.group("rep"))
    heads = coll.ordered_sum_flat(heads, layout.group("dp"))
    it_rep, it_heads = iter(rep), iter(heads)
    out = [next(it_heads) if h else next(it_rep) for h in flags]
    return out + list(it_rep)


def _head_flags(params: CRVAEParams) -> list[bool]:
    """Per leaf of CRVAEParams (field order): split over ep or not."""
    spec = crvae_param_spec()
    return ([False] * len(tree_leaves(params.enc))
            + [False] * len(tree_leaves(params.fc_mu))
            + [False] * len(tree_leaves(params.fc_std))
            + [spec.heads.w_ih == "ep"] * len(tree_leaves(params.heads))
            + [spec.readout.w == "ep"] * len(tree_leaves(params.readout)))


def reduce_scalars(layout: RankLayout, values: dict, group: str = "rep"):
    """{name: 0-d tensor} summed over ``group`` in one collective."""
    names = list(values)
    total = coll.ordered_sum(torch.stack([values[k].reshape(())
                                          for k in names]),
                             layout.group(group))
    return {k: total[i] for i, k in enumerate(names)}


def make_sharded_phase1_step(model: CRVAE, cfg: Phase1Config, mesh,
                             parents: torch.Tensor):
    """Explicit-batch phase-1 step over ``mesh``.

    Returns (step, crvae param sharding, batch sharding).  The step is
    ``step(params, batch, eps) -> (params, metrics)`` for KL configs, or
    ``step(params, prior, batch, eps) -> (params, prior, metrics)`` when
    ``cfg.latent_reg == 'cs'``: ``params`` is this rank's part
    (``global_device_put(params, param sharding)``), ``batch`` (B, T, p)
    and ``eps`` (B, H) the global draws or this rank's dp slices; the
    returned params are this rank's part, the metrics global (the same on
    every rank).  ``parents`` is the whole (p, p) mask.
    """
    from vae_connexe_torch.train.crvae_trainer import _phase1_update

    check_mesh_divisibility(mesh, model.p, cfg.batch_size)
    param_shard = crvae_param_sharding(mesh)
    batch_shard = batch_sharding(mesh)
    layout = RankLayout(mesh, model.p, cfg.batch_size)
    parents_l = layout.heads_of(parents)

    def update(params, prior, batch, eps):
        batch, eps = layout.local(batch), layout.local(eps)
        return _phase1_update(model, cfg, params, prior, parents_l, batch,
                              eps.to(batch.device), layout=layout)

    if cfg.latent_reg == "cs":
        def step_cs(params, prior, batch, eps):
            return update(params, prior, batch, eps)
        return step_cs, param_shard, batch_shard

    def step_kl(params, batch, eps):
        params, _, metrics = update(params, None, batch, eps)
        return params, metrics
    return step_kl, param_shard, batch_shard


def make_sharded_phase2_step(model: CRVAE, err_model, cfg, mesh,
                             parents: torch.Tensor, err_opt=None):
    """Explicit-batch phase-2 step over ``mesh``: pruned-CRVAE SGD and the
    masked projection (heads over ep, batch over dp) plus Adam on the
    replicated error VAE against the detached residuals, whose columns are
    gathered over ep.

    Returns (step, crvae param sharding, batch sharding).  Signature for KL
    configs: ``step(params, err_params, err_opt_state, batch, eps,
    eps_err) -> (params, err_params, err_opt_state, metrics)``; cs configs
    take and return the replicated prior after ``params``.  ``err_opt``:
    None for the written-out Adam at ``cfg.lr_error`` (``optim/adam.py``),
    or a callable ``(grads, opt_state, params) -> (params, opt_state)``.
    Inputs and outputs as in ``make_sharded_phase1_step``.
    """
    from vae_connexe_torch.train.crvae_trainer import (
        Phase2State,
        _phase2_update,
    )

    check_mesh_divisibility(mesh, model.p, cfg.batch_size)
    param_shard = crvae_param_sharding(mesh)
    batch_shard = batch_sharding(mesh)
    layout = RankLayout(mesh, model.p, cfg.batch_size)
    parents_l = layout.heads_of(parents)

    def update(params, prior, err_params, err_opt_state, batch, eps,
               eps_err):
        batch, eps, eps_err = (layout.local(batch), layout.local(eps),
                               layout.local(eps_err))
        state = Phase2State(params=params, err_params=err_params,
                            err_opt=err_opt_state, prior=prior,
                            best_params=params, best_loss=None,
                            generator=None, step=0)
        return _phase2_update(model, err_model, cfg, state, parents_l, batch,
                              eps.to(batch.device),
                              eps_err.to(batch.device), layout=layout,
                              err_opt=err_opt)

    if getattr(cfg, "latent_reg", "kl") == "cs":
        def step_cs(params, prior, err_params, err_opt_state, batch, eps,
                    eps_err):
            return update(params, prior, err_params, err_opt_state, batch,
                          eps, eps_err)
        return step_cs, param_shard, batch_shard

    def step_kl(params, err_params, err_opt_state, batch, eps, eps_err):
        params, _, err_params, err_opt_state, metrics = update(
            params, None, err_params, err_opt_state, batch, eps, eps_err)
        return params, err_params, err_opt_state, metrics
    return step_kl, param_shard, batch_shard


class MeshCheckpointer:
    """``TrainCheckpointer`` for a meshed fit: every rank gathers the state
    whole (``gather_tree`` over ``state_sharding``), rank 0 writes it, and
    a barrier holds every rank until it has landed; a restore reads the
    whole state on every rank and keeps this rank's part, so the
    directory must be one that every rank sees.  The generator's state is
    the same on every rank (every rank draws the same)."""

    def __init__(self, path: str, every: int, mesh, state_sharding):
        from vae_connexe_torch.utils.checkpoint import TrainCheckpointer

        self.base = TrainCheckpointer(path, every)
        self.mesh, self.sharding = mesh, state_sharding

    def _due(self, step: int, final: bool) -> bool:
        last, every = self.base._last_saved, self.base.every
        return final or (every > 0 and step - (last or 0) >= every)

    def maybe_save(self, state, metrics: dict, final: bool) -> bool:
        from vae_connexe_torch.parallel.mesh import (
            gather_tree,
            is_writer,
            world_device,
        )

        step = int(state.step)
        due = self._due(step, final)
        if due and step != self.base._last_saved:
            whole = gather_tree(state, self.sharding)
            if is_writer(self.mesh):
                self.base.save(whole, metrics)
            self.base._last_saved = step
            import torch.distributed as dist

            coll.barrier(dist.group.WORLD, world_device())
        return due

    def restore(self, template):
        from vae_connexe_torch.parallel.mesh import (
            gather_tree,
            global_device_put,
        )

        restored = self.base.restore(gather_tree(template, self.sharding))
        if restored is None:
            return None
        state, metrics = restored
        return global_device_put(state, self.sharding), metrics
