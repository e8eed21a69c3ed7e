"""Meshes and the rank-local shardings (port of
``vae_connexe_tpu/parallel/mesh.py``).

The JAX package's mesh is single-controller: one program over every
device, with ``NamedSharding`` layouts and collectives that XLA inserts.
The port runs one process per device: this process is one rank of a
``torch.distributed`` group, and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the whole group with
dims ``("dp", "ep")``, or ``("dp", "ep", "sp")`` when ``n_sp > 1``, built
from process groups this module makes, each with a timeout.  Ranks are laid
out as ``arange(world).reshape(dims)``: rank = (dp index * n_ep + ep index)
* n_sp + sp index.

Axes:

- ``dp``: data parallel: each rank holds its slice of the batch;
- ``ep``: head parallel: each rank holds p / ep decoder heads, their
  readout rows and the matching parents-mask rows;
- ``sp``: sequence parallel (``parallel/seq_parallel.py``).

Everything else (the encoder, ``fc_mu``/``fc_std``, the GMM prior, the
ErrorVAE and its Adam state) is replicated: every rank holds a copy.

A sharding here (``Sharding``) describes a rank-local slice of the leading
axis and has the op that takes it (``local``) and the one that puts the
slices back together (``gather``); ``global_device_put`` and
``gather_tree`` apply them to a whole tree (checkpoints, ``best_params``
and the GC read need the gathered tree).

The group: ``torchrun`` or ``parallel/multiprocess.py`` start it
(``parallel/multihost.py::initialize_multihost``); with no group,
``make_mesh`` starts a world of one itself on a free localhost port.
Backends: NCCL when each rank has its own card, gloo when the caller names
the CPU, and gloo with CUDA tensors when ranks share one card (NCCL refuses
two ranks on one device; ``parallel/collectives.py`` stages the ops gloo
cannot run on CUDA tensors through the host).  The choice is written to
stderr on every rank; nothing falls back silently.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys
from typing import Optional

import torch
import torch.distributed as dist

from vae_connexe_torch._device import resolve_device
from vae_connexe_torch.parallel import collectives as coll
from vae_connexe_torch.utils.tree import tree_map

AXES = ("dp", "ep", "sp")
# Seconds every collective and the group's start may wait on a peer.
DEFAULT_TIMEOUT_S = 300.0

# This process's rank: its device, the backend and the timeout.
_WORLD: dict = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def choose_backend(device: torch.device, local_world: int = 1) -> str:
    """gloo on the CPU; on CUDA, NCCL when each of the ``local_world``
    ranks of this host has a card of its own, else gloo (the ranks share
    a card, which NCCL refuses)."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if local_world <= torch.cuda.device_count() else "gloo"


def rank_device(device=None, local_rank: int = 0) -> torch.device:
    """This rank's device: the CPU when named, else card ``local_rank``
    modulo the cards of the host (ranks beyond the card count share)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init_world(device=None, *, init_method: Optional[str] = None,
               world_size: int = 1, rank: int = 0, local_rank: int = 0,
               local_world: Optional[int] = None,
               timeout: Optional[float] = None) -> torch.device:
    """Start this process's rank of the group: pick and log the backend,
    bind the card, ``init_process_group`` with the timeout.  Returns the
    rank's device."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already running in this "
                           "process")
    dev = rank_device(device, local_rank)
    local_world = world_size if local_world is None else local_world
    backend = choose_backend(dev, local_world)
    timeout = DEFAULT_TIMEOUT_S if timeout is None else float(timeout)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if init_method is None:
        init_method = f"tcp://localhost:{_free_port()}"
    why = ("the CPU" if dev.type != "cuda" else
           "one card a rank" if backend == "nccl" else
           f"{local_world} ranks share {torch.cuda.device_count()} card(s); "
           f"NCCL refuses two ranks on one device")
    print(f"[vae_connexe_torch] rank {rank}/{world_size}: backend {backend} "
          f"on {dev} ({why}), timeout {timeout:g} s", file=sys.stderr,
          flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    _WORLD.update(device=dev, backend=backend, timeout=timeout,
                  local_rank=local_rank)
    return dev


def world_device() -> torch.device:
    """The device of this process's rank (``init_world``)."""
    if "device" not in _WORLD:
        raise RuntimeError("no process group: call make_mesh or "
                           "initialize_multihost first")
    return _WORLD["device"]


def shutdown() -> None:
    """Destroy the group (the meshes built on it go with it)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _WORLD.clear()


def make_mesh(n_dp: int | None = None, n_ep: int = 1, n_sp: int = 1,
              devices: list | None = None, device=None, *,
              timeout: Optional[float] = None):
    """Build a (dp, ep) mesh, or (dp, ep, sp) when ``n_sp > 1``, over every
    rank of the group.  Defaults: every rank on dp.

    ``devices``: the group's devices, one a rank (default: the group's size
    times this rank's device).  With no group yet this process starts a
    world of one on ``device`` (default ``cuda``; ``"cpu"`` names the CPU)
    with ``timeout`` seconds for every collective.
    """
    if not dist.is_initialized():
        if device is None and devices:
            device = devices[0]
        init_world(device, timeout=timeout)
    world = dist.get_world_size()
    devices = devices if devices is not None else [world_device()] * world
    if n_ep < 1 or n_sp < 1:
        raise ValueError(f"n_ep/n_sp must be >= 1, got {n_ep}/{n_sp}")
    if n_dp is None:
        if len(devices) % (n_ep * n_sp):
            raise ValueError(
                f"cannot infer n_dp: {len(devices)} devices not divisible by "
                f"n_ep*n_sp={n_ep * n_sp}; pass n_dp explicitly or choose "
                f"factors dividing the device count")
        n_dp = len(devices) // (n_ep * n_sp)
    if n_dp * n_ep * n_sp > len(devices):
        raise ValueError(
            f"mesh ({n_dp} dp × {n_ep} ep × {n_sp} sp) = "
            f"{n_dp * n_ep * n_sp} devices, but only {len(devices)} "
            f"available — reduce the mesh or provision more devices "
            f"(one process a device: start more ranks with --processes, "
            f"torchrun or launch_multiprocess_*)")
    if n_dp * n_ep * n_sp != world:
        raise ValueError(
            f"mesh ({n_dp} dp × {n_ep} ep × {n_sp} sp) = "
            f"{n_dp * n_ep * n_sp} ranks, but the group has {world}: a "
            f"port mesh covers every rank of the group (one process a "
            f"device)")
    names = AXES if n_sp > 1 else AXES[:2]
    dims = (n_dp, n_ep, n_sp)[:len(names)]
    return _build_mesh(dims, names)


def _build_mesh(dims, names):
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size()
    rank = dist.get_rank()
    layout = torch.arange(world).reshape(dims)
    td = datetime.timedelta(seconds=_WORLD.get("timeout", DEFAULT_TIMEOUT_S))
    groups = {}
    # Every rank makes every subgroup, in the same order.
    for i, name in enumerate(names):
        lines = layout.movedim(i, -1).reshape(-1, dims[i])
        for line in lines.tolist():
            g = dist.new_group(line, timeout=td)
            if rank in line:
                groups[name] = g
    if len(names) == 3:
        # The ranks that share an sp index: (dp, ep) lines.
        lines = layout.permute(2, 0, 1).reshape(dims[2], -1)
        for line in lines.tolist():
            g = dist.new_group(line, timeout=td)
            if rank in line:
                groups["rep"] = g
    else:
        groups["rep"] = dist.new_group(list(range(world)), timeout=td)
    dev_type = world_device().type
    try:
        mesh = DeviceMesh.from_group([groups[n] for n in names], dev_type,
                                     mesh=layout, mesh_dim_names=names)
    except (TypeError, ValueError, NotImplementedError):
        # A torch whose from_group takes one group only: the DeviceMesh
        # makes its own groups; the collectives here use this module's.
        mesh = DeviceMesh(dev_type, layout, mesh_dim_names=names)
    mesh._vcx_groups = groups
    mesh._vcx_coord = {n: int((layout == rank).nonzero()[0, i])
                       for i, n in enumerate(names)}
    return mesh


def check_mesh(mesh) -> None:
    """Raise ``TypeError`` unless ``mesh`` is a mesh of ``make_mesh``."""
    if not hasattr(mesh, "_vcx_groups"):
        raise TypeError(
            f"expected a mesh of parallel.mesh.make_mesh (a DeviceMesh over "
            f"this process's group), got {type(mesh).__name__}")


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name`` (1 when the mesh lacks it), as
    JAX's ``mesh.shape.get(name, 1)``."""
    names = mesh.mesh_dim_names
    return int(mesh.shape[names.index(name)]) if name in names else 1


def mesh_shape(mesh) -> dict:
    """{axis name: size}, JAX's ``mesh.shape``."""
    return {n: int(s) for n, s in zip(mesh.mesh_dim_names, mesh.shape)}


def axis_index(mesh, name: str) -> int:
    """This rank's index along ``name`` (0 when the mesh lacks it)."""
    return mesh._vcx_coord.get(name, 0)


def axis_group(mesh, name: str):
    """The process group of this rank's line along ``name``; ``"rep"`` is
    the ranks that share this rank's sp index (every rank without sp)."""
    return mesh._vcx_groups[name]


def mesh_size(mesh) -> int:
    return int(mesh.mesh.numel())


def is_writer(mesh) -> bool:
    """True on the rank that writes files (rank 0); always without a
    mesh."""
    return mesh is None or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A rank-local layout of a tensor's leading axis: split over
    ``axes`` (a mesh axis name, or every axis of the mesh: ``"all"``), or
    replicated (``axes=None``)."""

    mesh: object
    axes: Optional[str] = None

    def _count_index(self) -> tuple[int, int]:
        if self.axes is None:
            return 1, 0
        if self.axes == "all":
            return mesh_size(self.mesh), dist.get_rank()
        return axis_size(self.mesh, self.axes), axis_index(self.mesh,
                                                           self.axes)

    def _group(self):
        return (dist.group.WORLD if self.axes == "all"
                else axis_group(self.mesh, self.axes))

    def local(self, x):
        """This rank's slice of ``x`` (a tensor; anything else passes)."""
        n, i = self._count_index()
        if n == 1 or not isinstance(x, torch.Tensor):
            return x
        if x.shape[0] % n:
            raise ValueError(
                f"leading axis {x.shape[0]} not divisible by the "
                f"{self.axes} mesh size {n}")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    def gather(self, x):
        """The whole tensor from every rank's slice (a collective over the
        axis: every rank of it must call)."""
        n, _ = self._count_index()
        if n == 1 or not isinstance(x, torch.Tensor):
            return x
        return coll.cat_gather(x, self._group())


def batch_sharding(mesh) -> Sharding:
    """Split the leading (batch/window) axis over dp, replicate the rest."""
    return Sharding(mesh, "dp")


def head_sharding(mesh) -> Sharding:
    """Split a leading stacked-head axis over ep."""
    return Sharding(mesh, "ep")


def replicated(mesh) -> Sharding:
    return Sharding(mesh, None)


def shard_batch(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's dp slice of a (N, ...) tensor."""
    return batch_sharding(mesh).local(x)


def _broadcast_prefix(tree, shard_tree):
    """``shard_tree`` (a prefix: one ``Sharding`` stands for a subtree)
    spread over ``tree``'s leaves."""
    if isinstance(shard_tree, Sharding):
        return tree_map(lambda _: shard_tree, tree)
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{
            f.name: _broadcast_prefix(getattr(tree, f.name),
                                      getattr(shard_tree, f.name))
            for f in dataclasses.fields(tree)})
    if type(tree) is tuple:
        return tuple(_broadcast_prefix(t, s) for t, s in zip(tree,
                                                             shard_tree))
    raise TypeError(f"no sharding for a {type(tree).__name__}")


def _map_with(fn, tree, shard_tree):
    """``fn(leaf, sharding)`` over the tensors of ``tree``; generators,
    ints and None pass through."""
    if isinstance(shard_tree, Sharding) and not dataclasses.is_dataclass(
            tree) and type(tree) is not tuple:
        return fn(tree, shard_tree) if isinstance(tree, torch.Tensor) else tree
    if tree is None:
        return None
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map_with(fn, getattr(tree, f.name),
                              _sub(shard_tree, f.name))
            for f in dataclasses.fields(tree)})
    if type(tree) is tuple:
        return tuple(_map_with(fn, t, _sub(shard_tree, i))
                     for i, t in enumerate(tree))
    return tree


def _sub(shard_tree, key):
    if isinstance(shard_tree, Sharding):
        return shard_tree
    if isinstance(key, int):
        return shard_tree[key]
    return getattr(shard_tree, key)


def global_device_put(tree, shard_tree):
    """This rank's part of ``tree`` under ``shard_tree``, which may be a
    prefix (one ``Sharding`` for a whole subtree).  Every rank holds the
    whole tree to start from (every rank draws the same inits from the
    same seeds), so no data moves."""
    return _map_with(lambda x, s: s.local(x), tree, shard_tree)


def gather_tree(tree, shard_tree):
    """The whole tree from every rank's part (the inverse of
    ``global_device_put``): a collective, every rank of the mesh calls it
    and gets the same tree."""
    return _map_with(lambda x, s: s.gather(x), tree, shard_tree)


def shard_crvae_params(params, mesh):
    """CRVAE params: the stacked-head leaves (heads, readout) split over ep,
    the encoder and the fc layers replicated; anything else replicated."""
    from vae_connexe_torch.models.crvae import CRVAEParams

    if isinstance(params, CRVAEParams):
        ep = head_sharding(mesh)
        return dataclasses.replace(params,
                                   heads=tree_map(ep.local, params.heads),
                                   readout=tree_map(ep.local, params.readout))
    return params


def world_info() -> dict:
    """{rank, world, device, backend} of this process (for logs)."""
    return {"rank": dist.get_rank(), "world": dist.get_world_size(),
            "device": str(world_device()), "backend": _WORLD["backend"],
            "pid": os.getpid()}
