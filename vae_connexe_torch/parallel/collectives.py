"""The collectives of the port's meshes, one place for the backend rules.

Every reduction of a meshed step sums in rank order: the parts are
all-gathered and added left to right (``ordered_sum``), so two meshed runs
of the same mesh agree bit for bit whatever the backend's own reduction
algorithm, and a group of one rank returns its input's values unchanged.

Two ranks that share one card cannot use NCCL (it refuses two ranks on one
device), so they run gloo with CUDA tensors.  Gloo reduces and broadcasts
CUDA tensors itself, but its all-gather and its point-to-point send and
receive take host pointers: those ops are staged through a pinned host
copy (``STAGED`` counts them by op), and the compute stays on the card;
a staged all-gather over a group of one rank is skipped (its result is
its input).  On the CPU, and over NCCL, nothing is staged.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

# Ops gloo runs on CUDA tensors itself; every other op is staged through
# the host when gloo carries CUDA tensors.
GLOO_CUDA_OPS = frozenset({"all_reduce", "broadcast"})

# Staged calls by op since the last ``reset_staged``, and their bytes and
# host seconds (the copies, the transfer and any wait on the peer).
STAGED = {"all_gather": 0, "send": 0, "recv": 0}
STAGED_BYTES = dict.fromkeys(STAGED, 0)
STAGED_S = dict.fromkeys(STAGED, 0.0)


def reset_staged() -> None:
    for counts in (STAGED, STAGED_BYTES, STAGED_S):
        for k in counts:
            counts[k] = 0


def _count(op: str, t: torch.Tensor, t0: float) -> None:
    STAGED[op] += 1
    STAGED_BYTES[op] += t.numel() * t.element_size()
    STAGED_S[op] += time.perf_counter() - t0


def group_size(group) -> int:
    return dist.get_world_size(group)


def _staged(t: torch.Tensor, group, op: str) -> bool:
    return (t.is_cuda and op not in GLOO_CUDA_OPS
            and dist.get_backend(group) == "gloo")


def _host(t: torch.Tensor) -> torch.Tensor:
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in group-rank order, on
    ``t``'s device."""
    t = t.contiguous()
    if _staged(t, group, "all_gather"):
        if group_size(group) == 1:
            # Staging a group of one would copy to the host and back.
            return [t]
        t0 = time.perf_counter()
        host = _host(t)
        parts = [torch.empty_like(host) for _ in range(group_size(group))]
        dist.all_gather(parts, host, group=group)
        out = [q.to(t.device) for q in parts]
        _count("all_gather", t, t0)
        return out
    parts = [torch.empty_like(t) for _ in range(group_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def ordered_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, added in group-rank order: the same
    bits on every rank and in every run."""
    parts = all_gather(t, group)
    out = parts[0]
    for q in parts[1:]:
        out = out + q
    return out


def ordered_sum_flat(tensors, group) -> list[torch.Tensor]:
    """``ordered_sum`` of several tensors through one flat buffer (one
    collective); returns tensors shaped as the inputs."""
    tensors = list(tensors)
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1) for t in tensors])
    total = ordered_sum(flat, group)
    out, at = [], 0
    for t in tensors:
        out.append(total[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def cat_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order."""
    return torch.cat(all_gather(t, group), dim=dim)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of group rank ``src`` on every rank (in place on the others)."""
    if group_size(group) == 1:
        return t
    t = t.contiguous()
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def send(t: torch.Tensor, dst: int, group) -> None:
    """Blocking send of ``t`` to group rank ``dst``."""
    t = t.contiguous()
    peer = dist.get_global_rank(group, dst)
    if _staged(t, group, "send"):
        t0 = time.perf_counter()
        dist.send(_host(t), peer, group=group)
        _count("send", t, t0)
        return
    dist.send(t, peer, group=group)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """Blocking receive from group rank ``src`` of a tensor shaped like
    ``like``, returned on ``like``'s device."""
    peer = dist.get_global_rank(group, src)
    if _staged(like, group, "recv"):
        t0 = time.perf_counter()
        host = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        dist.recv(host, peer, group=group)
        out = host.to(like.device)
        _count("recv", like, t0)
        return out
    out = torch.empty_like(like)
    dist.recv(out, peer, group=group)
    return out


def barrier(group, device) -> None:
    """Every rank of ``group`` reached this point (a one-element
    all-reduce on ``device``, which NCCL and gloo both run)."""
    if group_size(group) > 1:
        dist.all_reduce(torch.zeros(1, device=device), group=group)
