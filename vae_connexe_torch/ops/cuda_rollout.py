"""Whole-rollout serving kernels (port of ``vae_connexe_tpu/ops/pallas_rollout.py``).

``crvae_free_run_fused`` and ``errvae_sample_fused`` keep the JAX entry
points' signatures and layouts.  On a CUDA tensor each launches a
hand-written kernel from ``csrc/rollout.cu`` (built at first use, see
``_build.py``) and adds one to its count in ``LAUNCHES`` and one to its
route's in ``ROUTE_LAUNCHES``; on a CPU tensor it runs its plain PyTorch
version below, the per-step loop of ``CRVAE._free_run`` /
``ErrorVAE.sample``.  There is no fallback from a kernel to the plain
version or from one route to the other: a CUDA input launches or raises.

``rollout_route`` picks the route from the shapes and the card's limits
before any launch, and each wrapper caches its plan per (shapes, device):
``"resident"`` where every weight of a block fits its shared memory (K1's
heads spread over a thread-block cluster; the weights go in torch's layout,
untransposed), else ``"streamed"``: a block for each (batch tile of M
rows, head), which streams its head's weights from L2 through a ring of
shared-memory chunks and feeds each to all M rows (``stream_tile`` picks
M; the wrapper packs the weights as float32 (P, Kp, 3, Hp), see
``pack_streamed``, once for as long as the weight tensors live unchanged,
and allocates the state and x scratch); one
launch a time step on the current stream, the steps after the first
programmatic dependent launches.  Shapes that neither route takes raise.

Each kernel has a float32 and a bfloat16 version, chosen by the weights'
dtype (bf16 serving, JAX's ``dtype=bfloat16``): in bf16 the weights stay
bf16 (on the resident route its own body, on the tensor cores: bf16
weights and state rows in shared memory, ``mma.sync`` with float32 sums,
tiles of a multiple of 16 rows and no k split, sized by
``mma_smem_bytes``; the streamed route widens them to float32 as it packs
them, see ``csrc/rollout.cu``), the kernels round x0, h0 and the noise to
bf16 as they read them, the products are accumulated and the gates
computed in float32, each step's new state and emitted x are rounded to
bf16, and the output is float32.  The plain versions do the same casts
in PyTorch.  Each instantiation has its own counts (``crvae_free_run_bf16``,
``errvae_sample_bf16``).  Sums are taken in another order than the plain
versions' ``einsum``, so the two agree to float32 rounding in float32 and
to a bf16 rounding step in bf16 (``chip_smoke.py`` states the tolerances
and checks them on the card).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import weakref
from typing import NamedTuple

import torch

from vae_connexe_torch.ops.cuda_gru import (
    FWD_TILES,
    fit_tile,
    fwd_step_cost,
    fwd_units,
    fwd_weight_stride,
)
from vae_connexe_torch.ops.gru import GRUParams, gru_cell, gru_step_heads
from vae_connexe_torch.utils.layers import Dense, dense

# Kernel launches per wrapper and storage type, and per wrapper, type and
# route, counted where the kernel is launched.
LAUNCHES = {"crvae_free_run": 0, "errvae_sample": 0,
            "crvae_free_run_bf16": 0, "errvae_sample_bf16": 0}
ROUTE_LAUNCHES = {f"{k}_{r}": 0 for k in LAUNCHES
                  for r in ("resident", "streamed")}

# Batch tiles of the streamed kernels, widest first (rollout.cu
# kStreamTiles); the input rows of a weight chunk (kStreamChunk).
STREAM_TILES = (32, 16, 8, 4)
STREAM_CHUNK = 8
# Hopper's cluster sizes: at most 8 blocks portably, 16 where the kernel
# allows a non-portable size.
PORTABLE_CLUSTER, MAX_CLUSTER = 8, 16
# Threads of a resident block (rollout.cu kResidentThreads): at 128
# registers a thread they fill an SM's 65,536, so an SM holds one block.
RESIDENT_THREADS = 512
# The k splits the resident kernels are instantiated for: lanes that share
# a thread tile's inputs (rollout.cu res_thread_tile).
SPLITS = (4, 2)
# A block whose gate tiles hold at most this many lanes at B1's split of 2
# (6 warps) is bound by its step's chain of loads and multiply-adds, which
# a split of 4 halves; a fuller block keeps the split of 2, whose fewer
# exchanges and loads win there (tools/torch_rollout_tiles.py).
SPLIT4_MAX_LANES = 192
# The bf16 resident body (rollout.cu mma_body): threads of a block (24
# warps, one block an SM); an item's rows and units (16 x 8, an mma's m and
# n) and an mma's k; its batch tiles, widest first.
MMA_THREADS = 768
MMA_ROWS, MMA_UNITS, MMA_K = 16, 8, 16
MMA_TILES = (128, 112, 96, 80, 64, 48, 32, 16)
# mma_step_cost's terms, in microseconds of an H100 (fitted to
# tools/torch_rollout_tiles.py --bf16 on one, 700 W: K1 at p=20 on 7-block
# clusters, K2 at d=20, H=64 and d=40, H=128, B=3072): a step's fixed part;
# an item's update and bookkeeping; each k16 of its product; each k of a
# readout dot; all but the fixed part spread over the block's warps.
MMA_STEP_US, MMA_ITEM_US, MMA_K16_US, MMA_DOT_US = 1.2, 0.99, 0.284, 4.66e-4
# An H100's SMs sit in graphics processing clusters of 16 or more, and a
# thread-block cluster never spans two: the card held 30, 22, 17, 15, 15, 7
# and 7 clusters of 4, 5, 6, 7, 8, 10 and 16 one-block-an-SM blocks
# (cudaOccupancyMaxActiveClusters, tools/torch_rollout_tiles.py --bf16).
GPC_SMS = 16


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def serve_dtype(dtype, arg: str = "serving dtype") -> torch.dtype:
    """The storage type of a serving ``dtype`` argument: None, "float32" or
    ``torch.float32`` -> float32; "bfloat16" or ``torch.bfloat16`` ->
    bfloat16 (JAX's ``dtype=jnp.bfloat16``).  Anything else raises, naming
    the argument ``arg``."""
    if dtype in (None, "float32", torch.float32):
        return torch.float32
    if dtype in ("bfloat16", torch.bfloat16):
        return torch.bfloat16
    raise ValueError(f"{arg} must be float32 or bfloat16, got {dtype!r}")


def cast_weights(group, dtype: torch.dtype):
    """A ``GRUParams`` or ``Dense`` with every leaf cast to ``dtype``."""
    return type(group)(*(getattr(group, f.name).to(dtype)
                         for f in dataclasses.fields(group)))


def _weights_dtype(*groups) -> torch.dtype:
    """The one storage type of the kernel's weight groups (float32 or
    bfloat16)."""
    types = {getattr(g, f.name).dtype for g in groups
             for f in dataclasses.fields(g)}
    if len(types) != 1 or not types <= {torch.float32, torch.bfloat16}:
        raise ValueError(f"rollout kernel: weights of types {sorted(map(str, types))}; "
                         f"it takes all float32 or all bfloat16")
    return types.pop()


def _carries(dtype: torch.dtype):
    """The rounding of a carry (x0, h0, the noise, each step's state and
    emitted x) as float32: none in float32, to the nearest bf16 in bf16."""
    if dtype == torch.float32:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float32)


def _as_f32(group):
    return group if _weights_dtype(group) == torch.float32 else \
        cast_weights(group, torch.float32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def mma_dims(d: int, hidden: int) -> tuple[int, int, int]:
    """(Kx, Kh, Hu) of the bf16 resident body: the input and state widths
    rounded up to an mma's k, the units of a gate to an item's (rollout.cu
    ``mma_kx``, ``mma_kh``, ``mma_units``)."""
    return (_round_up(d, MMA_K), _round_up(hidden, MMA_K),
            _round_up(hidden, MMA_UNITS))


def mma_ld(n: int) -> int:
    """Row stride (bf16 elements) of the bf16 body's rows of ``n`` elements
    (a multiple of 16): 8 past it, so that rows start 4 words apart modulo
    8 and an ldmatrix phase's 8 rows meet in disjoint banks (rollout.cu
    ``mma_ld``)."""
    return n + 8


def mma_smem_bytes(heads: int, bt: int, d: int, hidden: int, outs: int,
                   noise: bool) -> int:
    """Shared memory of a bf16 resident block (rollout.cu
    ``mma_smem_bytes``), each region rounded up to 16 bytes: each head's
    3 x Hu weight rows [W_ih | W_hh] at ``mma_ld(Kx + Kh)`` bf16, its four
    bias rows of Hu floats, the readout rows and biases, two buffers of x
    rows (``mma_ld(Kx)`` bf16) and of each head's state rows
    (``mma_ld(Kh)``).  ``noise``: K1's block, its readout rows float32 (H
    rounded up to 4) and two buffers of the noise columns (float32); else
    K2's, its readout rows bf16 at ``mma_ld(Kh)``, ``outs`` rounded up to
    8 (the readout mma's B operand)."""
    kx, kh, hu = mma_dims(d, hidden)
    r16 = lambda n: _round_up(n, 16)    # noqa: E731
    ro = (heads * outs * _round4(hidden) * 4 if noise
          else _round_up(outs, MMA_UNITS) * mma_ld(kh) * 2)
    return (r16(heads * 3 * hu * mma_ld(kx + kh) * 2) + r16(heads * 4 * hu * 4)
            + r16(ro) + r16(heads * outs * 4)
            + r16(2 * bt * mma_ld(kx) * 2)
            + r16(2 * heads * bt * mma_ld(kh) * 2)
            + (2 * heads * outs * bt * 4 if noise else 0))


def mma_items(heads: int, bt: int, hidden: int) -> int:
    """Items of a bf16 resident block's step: 16 rows x 8 units of one
    head, each a warp's in turn."""
    return heads * (bt // MMA_ROWS) * (mma_dims(1, hidden)[2] // MMA_UNITS)


def stream_dims(d: int, hidden: int) -> tuple[int, int]:
    """(Dp, Hp) of the streamed body: the input width rounded up to a
    weight chunk, the hidden width to 32 (rollout.cu ``stream_dp``,
    ``stream_hp``)."""
    return _round_up(d, STREAM_CHUNK), _round_up(hidden, 32)


def stream_shape(m: int) -> tuple[int, int, int]:
    """(rows, units, split) of a streamed thread tile at a batch tile of
    ``m`` rows: rows x units x the 3 gates over 1 / split of the weight
    chunks; 4 x 1 split 4 ways at 4 rows, 4 x 2 split 2 ways at 8, 8 x 2
    from 16 (rollout.cu ``stream_rows``, ``stream_units``,
    ``stream_split``)."""
    if m >= 16:
        return 8, 2, 1
    return (4, 2, 2) if m == 8 else (4, 1, 4)


def stream_threads(m: int, hidden: int) -> int:
    """Threads of a streamed block of ``m`` rows: a thread tile a thread,
    times the split."""
    rows, units, split = stream_shape(m)
    return split * (m // rows) * (stream_dims(1, hidden)[1] // units)


def stream_max_threads(m: int) -> int:
    """The most threads the thread tile at ``m`` rows is compiled for
    (rollout.cu ``stream_max_threads``): 512 at 64 accumulators a thread,
    else 1024."""
    rows, units, _ = stream_shape(m)
    return 1024 if rows * units <= 8 else 512


def stream_smem_bytes(m: int, d: int, hidden: int, outs: int) -> int:
    """Dynamic shared memory of a streamed block of ``m`` rows and ``outs``
    readout columns a head, float32 in both storage types: the ring's
    barriers, the ring of weight chunks (two rounds of the split's chunks,
    at least 4), the tile of [x | h], the readout rows (4 floats past H),
    the gate and readout biases (rollout.cu ``stream_smem_bytes``)."""
    dp, hp = stream_dims(d, hidden)
    stages = max(4, 2 * stream_shape(m)[2])
    return 4 * (16 + stages * STREAM_CHUNK * 3 * hp + (dp + hp) * m
                + outs * (hidden + 4) + _round_up(6 * hidden + outs, 4))


def stream_scratch_bytes(m: int, heads: int, batch: int, d: int,
                         hidden: int) -> int:
    """Bytes of the streamed route's scratch: the state (heads, Hp, Bp) and
    two x buffers (2, Dp, Bp), float32, Bp = batch rounded up to ``m``."""
    dp, hp = stream_dims(d, hidden)
    return 4 * _round_up(batch, m) * (heads * hp + 2 * dp)


def stream_tile(batch: int, heads: int, d: int, hidden: int, outs: int,
                budget: int, n_sm: int) -> int:
    """Batch tile M of the streamed kernels: the widest of
    ``STREAM_TILES`` whose block fits ``budget`` bytes of shared memory and
    its instantiation's threads, and whose ``heads`` x ceil(batch / M)
    blocks a step still give every one of the ``n_sm`` SMs a block; the
    narrowest that fits when none does (a small batch: every tile is then
    one block a head, and a narrower one wastes fewer rows).  A wider tile
    feeds each weight chunk it loads from L2 to more rows; below one block
    an SM it only idles SMs.  Raises ValueError, naming the bytes, when
    even the narrowest tile does not fit."""
    fitting = [m for m in STREAM_TILES
               if stream_smem_bytes(m, d, hidden, outs) <= budget
               and stream_threads(m, hidden) <= stream_max_threads(m)]
    if not fitting:
        m = STREAM_TILES[-1]
        raise ValueError(
            f"rollout kernel: the streamed body's smallest tile ({m} rows) "
            f"at D={d}, H={hidden} needs "
            f"{stream_smem_bytes(m, d, hidden, outs)} bytes of shared "
            f"memory (over the device's {budget}) and "
            f"{stream_threads(m, hidden)} threads")
    for m in fitting:
        if heads * -(-batch // m) >= n_sm:
            return m
    return fitting[-1]


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def resident_smem_bytes(heads: int, bt: int, d: int, hidden: int, outs: int,
                        noise: bool, elem: int = 4) -> int:
    """Shared memory of a resident block of ``heads`` heads with weights of
    ``elem`` bytes.  float32 (rollout.cu ``resident_smem_floats``): each
    head's W_ih^T and W_hh^T at B1's row stride, the readout rows and
    biases, two buffers of x (d columns) and of every head's state, and two
    of the noise columns.  bf16 (``elem`` 2): ``mma_smem_bytes``."""
    if elem == 2:
        return mma_smem_bytes(heads, bt, d, hidden, outs, noise)
    ld_row = fwd_units(hidden) + 1
    weights = _round4((d + hidden) * fwd_weight_stride(hidden))
    return 4 * (heads * weights + _round4(heads * outs * ld_row)
                + _round4(heads * outs) + 2 * d * bt
                + 2 * heads * ld_row * bt
                + (2 * heads * outs * bt if noise else 0))


def gate_threads(heads: int, bt: int, hidden: int, split: int) -> int:
    """Threads of a resident block's gate tiles (rollout.cu
    ``gate_threads``): B1's tiles of 4 rows x 2 units over ``heads`` heads
    of ``bt`` rows, each shared by ``split`` lanes."""
    return fwd_units(hidden) // 2 * (heads * bt // 4) * split


def resident_split(heads: int, bt: int, hidden: int) -> int | None:
    """The k split of a float32 resident block of ``heads`` heads of ``bt``
    rows: 4 where its gate tiles at a split of 2 hold at most
    ``SPLIT4_MAX_LANES`` lanes, else 2; None when they do not fit the block
    even at 2.  (The bf16 body splits no k: its plans hold 0.)"""
    lanes = gate_threads(heads, bt, hidden, 2)
    if lanes > RESIDENT_THREADS:
        return None
    return 4 if lanes <= SPLIT4_MAX_LANES else 2


class RolloutPlan(NamedTuple):
    """A rollout kernel's launch plan.  ``cluster``: blocks of a K1
    cluster (1 for K2 and the streamed route); ``heads_per_block``: heads
    of the fullest block; ``bt``: rows of a batch tile (M on the streamed
    route); ``split``: lanes a resident thread tile's k is split over (0 on
    the streamed route); ``smem``: dynamic shared memory of a block in
    bytes.  Streamed route only: ``blocks``, blocks a step (heads x
    tiles); ``scratch``, bytes of its state and x scratch
    (``stream_scratch_bytes``)."""
    route: str
    cluster: int
    heads_per_block: int
    bt: int
    split: int
    threads: int
    smem: int
    blocks: int = 0
    scratch: int = 0


def mma_step_cost(bt: int, heads: int, d: int, hidden: int, outs: int,
                  batch: int, k1: bool) -> float:
    """A bf16 resident block's step in microseconds (``MMA_*_US``) at a
    tile of ``bt`` rows of which ``min(bt, batch)`` are live: the items of
    its live 16-row tiles and its readout (K1: a dot over H a row and
    column; K2: an mma item a 16-row tile and 8 outputs), spread over its
    warps, and the step's fixed part."""
    kx, kh, _ = mma_dims(d, hidden)
    live = min(bt, batch)
    rows = _round_up(live, MMA_ROWS)
    readout = (heads * outs * live * hidden * MMA_DOT_US if k1
               else rows // MMA_ROWS * -(-outs // MMA_UNITS) * MMA_K16_US
               * kh / MMA_K)
    work = (mma_items(heads, rows, hidden)
            * (MMA_ITEM_US + MMA_K16_US * (kx + kh) / MMA_K) + readout)
    return MMA_STEP_US + work / (MMA_THREADS // 32)


def clusters_held(cluster: int, n_sm: int) -> int:
    """Clusters of ``cluster`` one-block-an-SM blocks the card holds at
    once: ``GPC_SMS // cluster`` in each of ``n_sm // GPC_SMS`` graphics
    processing clusters, less one (an H100 held one fewer at each size
    from 4 to 16 but 6, where it held two more)."""
    return max(1, (n_sm // GPC_SMS) * (GPC_SMS // cluster) - 1)


def _mma_tile(batch: int, heads: int, d: int, hidden: int, outs: int,
              noise: bool, held: int, optin: int):
    """(cost, tile) of a bf16 resident block of ``heads`` heads of ``outs``
    readout columns (``noise``: K1's block, else K2's), or None when no
    tile fits ``optin`` bytes: the tile of ``MMA_TILES`` with the least
    rounds of tiles over the ``held`` blocks or clusters the card holds at
    once times ``mma_step_cost``, the narrower on a tie."""
    def cost(bt):
        tiles = -(-batch // bt)
        return -(-tiles // held) * mma_step_cost(bt, heads, d, hidden, outs,
                                                 batch, noise)

    fitting = [bt for bt in reversed(MMA_TILES)
               if mma_smem_bytes(heads, bt, d, hidden, outs, noise) <= optin]
    return min(((cost(bt), bt) for bt in fitting), default=None)


def _mma_cluster(batch: int, heads: int, hidden: int, limits):
    """(cluster, heads a block, tile) of K1's bf16 resident kernel, or None
    when no block fits: over every cluster size up to the largest, with
    the fewest heads a block it needs, and each tile, the least
    ``_mma_tile`` cost on ``clusters_held`` clusters; the fewer heads a
    block on a tie."""
    optin, n_sm, largest = limits[0], limits[2], limits[5]
    best = None
    for hpb in range(1, heads + 1):
        cluster = -(-heads // hpb)
        if cluster > largest or cluster * (hpb - 1) >= heads:
            continue                  # too large, or fewer heads suffice
        got = _mma_tile(batch, hpb, heads, hidden, 1, True,
                        clusters_held(cluster, n_sm), optin)
        if got is not None and (best is None or got[0] < best[0]):
            best = (got[0], cluster, hpb, got[1])
    return None if best is None else best[1:]


def _cluster_tile(batch: int, heads: int, d: int, hidden: int, cluster: int,
                  limits) -> int | None:
    """Batch tile of K1's float32 resident kernel on clusters of
    ``cluster`` blocks, or None when no tile fits: the widest tile of
    ``FWD_TILES`` that fits a block and still gives every cluster the card
    holds at once a tile (a wider tile feeds each scheduler more warps),
    else the narrowest that fits.  The card is taken to hold one cluster
    for every ``cluster`` of its SMs (an SM holds one resident block)."""
    optin, n_sm = limits[0], limits[2]
    hpb = -(-heads // cluster)
    fitting = [bt for bt in FWD_TILES
               if resident_smem_bytes(hpb, bt, d, hidden, 1, True) <= optin
               and resident_split(hpb, bt, hidden) is not None]
    for bt in fitting:
        if -(-batch // bt) >= n_sm // cluster:
            return bt
    return fitting[-1] if fitting else None


@functools.cache
def rollout_route(kind: str, heads: int, batch: int, d: int, hidden: int,
                  limits, elem: int = 4) -> RolloutPlan:
    """The route and plan of a rollout at these shapes on a card of
    ``limits`` = (opt-in shared memory of a block, shared memory of an SM,
    SMs, threads of an SM, portable cluster size, largest cluster size),
    chosen before any launch, for weights of ``elem`` bytes (4 float32, 2
    bfloat16: the resident route stages half the bytes).

    ``kind``: ``"crvae"`` (K1, ``heads`` heads over an input of d = heads
    columns, one output each) or ``"errvae"`` (K2, one head, d outputs).
    ``"resident"`` where every weight of a block fits its shared memory.
    float32: K1 on a cluster of the fewest heads per block that a portable
    cluster holds (else a larger, non-portable one), the heads spread
    evenly over as few blocks as that needs; K2 on one block a tile, its
    tile by B1's cost model (``fwd_step_cost``), a tie to the narrower
    tile; the k split of a block by ``resident_split``.  bf16: the
    tensor-core body, K1's cluster, heads a block and tile by
    ``_mma_cluster``, K2's tile by ``_mma_tile``.  Else ``"streamed"``,
    one head a block, at ``stream_tile``'s tile.  Raises ValueError when
    neither route fits.
    """
    optin, _, n_sm, _, portable, largest = limits
    threads = RESIDENT_THREADS if elem == 4 else MMA_THREADS
    if kind == "crvae":
        if d != heads:
            raise ValueError(f"crvae rollout: input width {d} != heads {heads}")
        if elem == 2:
            picked = _mma_cluster(batch, heads, hidden, limits)
            if picked is not None:
                cluster, hpb, bt = picked
                return RolloutPlan(
                    "resident", cluster, hpb, bt, 0, threads,
                    mma_smem_bytes(hpb, bt, d, hidden, 1, True))
        else:
            for cap in (portable, largest):
                hpb = -(-heads // min(cap, heads))
                cluster = -(-heads // hpb)  # as few blocks as hpb a block needs
                bt = _cluster_tile(batch, heads, d, hidden, cluster, limits)
                if bt is not None:
                    return RolloutPlan(
                        "resident", cluster, hpb, bt,
                        resident_split(hpb, bt, hidden), threads,
                        resident_smem_bytes(hpb, bt, d, hidden, 1, True))
    elif kind == "errvae":
        if heads != 1:
            raise ValueError(f"errvae rollout: {heads} heads, expected 1")
        if elem == 2:     # one block an SM
            got = _mma_tile(batch, 1, d, hidden, d, False, n_sm, optin)
            bt = None if got is None else got[1]
        else:
            # Narrowest first: a tie goes to the narrower tile, whose step
            # (the chain a small batch waits on) is shorter.
            tiles = [n for n in sorted(FWD_TILES)
                     if resident_split(1, n, hidden) is not None]
            bt = fit_tile(
                batch, 1, hidden, tiles,
                lambda n: resident_smem_bytes(1, n, d, hidden, d, False),
                lambda *_: RESIDENT_THREADS,
                lambda n, *rest: fwd_step_cost(n, d, hidden, *rest),
                (*limits[:3], RESIDENT_THREADS))    # one block an SM
        if bt is not None:
            return RolloutPlan(
                "resident", 1, 1, bt,
                resident_split(1, bt, hidden) if elem == 4 else 0, threads,
                resident_smem_bytes(1, bt, d, hidden, d, False, elem))
    else:
        raise ValueError(f"unknown rollout kind {kind!r}")
    outs = 1 if kind == "crvae" else d
    try:
        m = stream_tile(batch, heads, d, hidden, outs, optin, n_sm)
    except ValueError as e:
        least = resident_smem_bytes(1, 4 if elem == 4 else MMA_ROWS, d,
                                    hidden, 1, False, elem)
        raise ValueError(
            f"{kind} rollout: at {heads} heads, D={d}, H={hidden} neither "
            f"route fits the device's {optin} bytes of shared memory a "
            f"block: one head's weights need {least} resident; {e}") from None
    return RolloutPlan("streamed", 1, 1, m, 0, stream_threads(m, hidden),
                       stream_smem_bytes(m, d, hidden, outs),
                       heads * -(-batch // m),
                       stream_scratch_bytes(m, heads, batch, d, hidden))


@functools.cache
def device_limits(device: torch.device) -> tuple[int, ...]:
    """``rollout_route``'s limits, read from ``device`` once."""
    from vae_connexe_torch.ops._build import rollout_library

    out = (ctypes.c_int * 4)()
    rc = rollout_library().vcx_device_limits(device.index or 0, out)
    if rc != 0:
        raise RuntimeError(f"cannot read the limits of {device} (cuda {rc})")
    return (*out, PORTABLE_CLUSTER, MAX_CLUSTER)


def max_active_clusters(device: torch.device, plan: RolloutPlan, heads: int,
                        hidden: int, elem: int = 4) -> int:
    """How many clusters of K1's resident kernel (bf16 weights at ``elem``
    2) ``device`` holds at once under ``plan``
    (``cudaOccupancyMaxActiveClusters``)."""
    from vae_connexe_torch.ops._build import rollout_library

    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = rollout_library().vcx_crvae_max_clusters(
            heads, hidden, plan.cluster, plan.bt, plan.split, int(elem == 2),
            ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed (cuda {rc})")
    return out.value


@functools.cache
def _plan(kind: str, heads: int, batch: int, d: int, hidden: int,
          device: torch.device, elem: int = 4) -> tuple[RolloutPlan, int]:
    """(plan, clusters to launch: K1's resident route, else 0) of a rollout
    on ``device`` with weights of ``elem`` bytes.  A block is checked
    against the kernel's own sizing.  K1's resident clusters are the fewer
    of the batch tiles and what the card holds at once, and a card that
    holds none raises before any launch."""
    from vae_connexe_torch.ops._build import rollout_library

    plan = rollout_route(kind, heads, batch, d, hidden, device_limits(device),
                         elem)
    if plan.route == "streamed":
        got = (ctypes.c_longlong * 2)()
        rollout_library().vcx_streamed_block(
            plan.bt, d, hidden, 1 if kind == "crvae" else d, got)
        if tuple(got) != (plan.smem, plan.threads):
            raise RuntimeError(f"csrc/rollout.cu sizes a streamed block as "
                               f"{tuple(got)}, cuda_rollout as "
                               f"{(plan.smem, plan.threads)}")
        return plan, 0
    outs = 1 if kind == "crvae" else d
    got = (ctypes.c_longlong * 2)()
    rollout_library().vcx_resident_block(plan.heads_per_block, plan.bt, d,
                                         hidden, outs, kind == "crvae",
                                         int(elem == 2), got)
    if tuple(got) != (plan.smem, plan.threads):
        raise RuntimeError(f"csrc/rollout.cu sizes a resident block as "
                           f"{tuple(got)}, cuda_rollout as "
                           f"{(plan.smem, plan.threads)}")
    if kind == "errvae":
        return plan, 0
    active = max_active_clusters(device, plan, heads, hidden, elem)
    if active < 1:
        raise RuntimeError(f"crvae rollout: {device} holds no cluster of "
                           f"{plan.cluster} blocks of {plan.smem} bytes")
    return plan, min(active, -(-batch // plan.bt))


def _check(device: torch.device, what: str,
           dtype: torch.dtype = torch.float32, **expected) -> None:
    """Each ``name=(tensor, shape)`` lies on ``device``, has exactly
    ``shape`` (the kernel reads it by that shape) and is of ``dtype`` if
    it is a weight (``w_*``, ``b_*``, ``ro_*``), else float32."""
    for name, (t, shape) in expected.items():
        want = dtype if name.startswith(("w_", "b_", "ro_")) else torch.float32
        if t.device != device or t.dtype != want:
            raise ValueError(f"{what}: {name} is {t.dtype} on {t.device}; "
                             f"the kernel takes {want} on {device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def _launch(fn_name: str, device: torch.device, tensors, ints) -> None:
    """Call one C entry point of the rollout library on ``device``'s current
    stream with the tensors' data pointers, then ``ints`` (Python ints and
    ctypes values); raise on the CUDA error it returns."""
    from vae_connexe_torch.ops._build import rollout_library

    lib = rollout_library()
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in tensors]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, *ints, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.vcx_error_string(rc).decode()} (cuda {rc})")


def pack_streamed(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """The streamed kernels' weights: (P, 3H, D) and (P, 3H, H) in torch's
    layout (or one head's (3H, D), (3H, H)) -> float32 (P, Kp, 3, Hp), row
    k holding the gates r, z, n of every unit: W_ih^T's D rows, zero rows
    to Dp, W_hh^T's H rows, zero rows to Kp = Dp + Hp; units past H zero
    (``stream_dims``).  bf16 weights are widened exactly (see rollout.cu's
    note).  Two copies on the weights' device; at D = 40 or 128 and H = 128
    nothing is padded."""
    if w_ih.dim() == 2:
        w_ih, w_hh = w_ih[None], w_hh[None]
    p, g, d = w_ih.shape
    hidden = g // 3
    dp, hp = stream_dims(d, hidden)
    padded = dp > d or hp > hidden
    w = (torch.zeros if padded else torch.empty)(
        (p, dp + hp, 3, hp), device=w_ih.device, dtype=torch.float32)
    w[:, :d, :, :hidden] = w_ih.reshape(p, 3, hidden, d).permute(0, 3, 1, 2)
    w[:, dp:dp + hidden, :, :hidden] = \
        w_hh.reshape(p, 3, hidden, hidden).permute(0, 3, 1, 2)
    return w


# pack_streamed's result for each pair of weight tensors a streamed rollout
# was called with: a served model passes the same tensors at every call,
# and at a small batch packing them again costs as much as the rollout
# (K2 at d=40, H=128, B=1: 0.31 ms a call against 0.19 on an H100,
# PERF.md).  An entry is used while both tensors' version counters (bumped
# by every in-place write) and storage are unchanged, and goes when either
# tensor is freed.
_PACKED: dict = {}


def _packed_weights(w_ih: torch.Tensor, w_hh: torch.Tensor) -> torch.Tensor:
    """``pack_streamed(w_ih, w_hh)``, packed again only when the weights
    change."""
    try:
        stamp = (w_ih._version, w_hh._version, w_ih.data_ptr(),
                 w_hh.data_ptr())
    except RuntimeError:        # inference tensors keep no version counter
        return pack_streamed(w_ih, w_hh)
    key = (id(w_ih), id(w_hh))
    hit = _PACKED.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    if hit is None:
        for w in (w_ih, w_hh):
            weakref.finalize(w, _PACKED.pop, key, None)
    packed = pack_streamed(w_ih, w_hh)
    _PACKED[key] = (stamp, packed)
    return packed


def _stream_scratch(plan: RolloutPlan, heads: int, batch: int, d: int,
                    hidden: int, device: torch.device):
    """The streamed route's state (heads, Hp, Bp) and x (2, Dp, Bp)
    scratch, float32; the x buffers' pad columns zero (the kernel never
    writes them, and the padded weight rows meet them)."""
    dp, hp = stream_dims(d, hidden)
    bp = _round_up(batch, plan.bt)
    x = (torch.zeros if dp > d else torch.empty)(
        (2, dp, bp), device=device, dtype=torch.float32)
    return torch.empty((heads, hp, bp), device=device,
                       dtype=torch.float32), x


# --------------------------------------------------------------------------
# K1: CRVAE free run, p heads; the emitted x feeds every head's next step.
# --------------------------------------------------------------------------

def crvae_free_run_plain(heads: GRUParams, readout: Dense, x0: torch.Tensor,
                         h0_shared: torch.Tensor, noise: torch.Tensor,
                         noise_scale: float) -> torch.Tensor:
    """Plain PyTorch version of K1: ``CRVAE._free_run``'s per-step loop, in
    the weights' storage type (bf16: the carries rounded to bf16, the
    products and gates in float32; float32 output)."""
    rnd = _carries(_weights_dtype(heads, readout))
    heads, readout = _as_f32(heads), _as_f32(readout)
    p = heads.w_ih.shape[0]
    h = rnd(h0_shared).expand(p, *h0_shared.shape)
    x = rnd(x0)
    noise = rnd(noise)
    outs = []
    for t in range(noise.shape[1]):
        h = rnd(gru_step_heads(heads, x, h))                  # (p, B, H)
        out = torch.einsum("pbh,poh->pbo", h, readout.w) + readout.b[:, None, :]
        x = rnd(out[..., 0].T + noise_scale * noise[:, t])    # (B, p)
        outs.append(x)
    return torch.stack(outs, dim=1)


def crvae_free_run_fused(heads: GRUParams, readout: Dense, x0: torch.Tensor,
                         h0_shared: torch.Tensor, noise: torch.Tensor,
                         noise_scale: float) -> torch.Tensor:
    """Whole CRVAE free run in one kernel (K1).

    heads: stacked, already masked GRUParams (p, 3H, D); readout: stacked
    Dense (p, 1, H)/(p, 1), all float32 or all bfloat16 (the kernel's bf16
    instantiation); x0 (B, D); h0_shared (B, H), the one state every head
    starts from; noise (B, T, D), all three float32.  Returns (B, T, D)
    float32, D = p.
    """
    dtype = _weights_dtype(heads, readout)
    if x0.device.type == "cpu":
        return crvae_free_run_plain(heads, readout, x0, h0_shared, noise,
                                    noise_scale)
    dev = x0.device
    p, hidden = heads.w_ih.shape[0], heads.hidden
    b, t_len = noise.shape[:2]
    g = 3 * hidden
    _check(dev, "crvae_free_run", dtype, w_ih=(heads.w_ih, (p, g, p)),
           w_hh=(heads.w_hh, (p, g, hidden)), b_ih=(heads.b_ih, (p, g)),
           b_hh=(heads.b_hh, (p, g)), ro_w=(readout.w, (p, 1, hidden)),
           ro_b=(readout.b, (p, 1)), x0=(x0, (b, p)),
           h0=(h0_shared, (b, hidden)), noise=(noise, (b, t_len, p)))
    half = dtype == torch.bfloat16
    plan, launch = _plan("crvae", p, b, p, hidden, dev, 2 if half else 4)
    out = torch.empty((b, t_len, p), device=dev, dtype=torch.float32)
    inputs = (x0.contiguous(), h0_shared.contiguous(), noise.contiguous())
    biases = (heads.b_ih.contiguous(), heads.b_hh.contiguous(),
              readout.w.contiguous(), readout.b.contiguous())
    if plan.route == "resident":
        tensors = (*inputs, heads.w_ih.contiguous(), heads.w_hh.contiguous(),
                   *biases, out)
        tail = (plan.cluster, plan.bt, plan.split, launch)
    else:
        tensors = (*inputs, _packed_weights(heads.w_ih, heads.w_hh), *biases,
                   out, *_stream_scratch(plan, p, b, p, hidden, dev))
        tail = (plan.bt,)
    name = "crvae_free_run_bf16" if half else "crvae_free_run"
    _launch(f"vcx_crvae_free_run_{plan.route}{'_bf16' if half else ''}", dev,
            tensors, (b, t_len, p, hidden, ctypes.c_float(noise_scale), *tail))
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}_{plan.route}"] += 1
    return out


# --------------------------------------------------------------------------
# K2: ErrorVAE free run, one GRU + readout, from x0 = 0.
# --------------------------------------------------------------------------

def errvae_sample_plain(dec: GRUParams, out: Dense, h0: torch.Tensor,
                        d: int, t_len: int) -> torch.Tensor:
    """Plain PyTorch version of K2: ``ErrorVAE.sample``'s per-step loop, in
    the weights' storage type as ``crvae_free_run_plain``."""
    rnd = _carries(_weights_dtype(dec, out))
    dec, out = _as_f32(dec), _as_f32(out)
    h = rnd(h0)
    x = torch.zeros((h0.shape[0], d), device=h0.device, dtype=torch.float32)
    outs = []
    for _ in range(t_len):
        h = rnd(gru_cell(dec, x, h))
        x = rnd(dense(out, h))
        outs.append(x)
    return torch.stack(outs, dim=1)


def errvae_sample_fused(dec: GRUParams, out: Dense, h0: torch.Tensor,
                        d: int, t_len: int) -> torch.Tensor:
    """Whole ErrorVAE free run in one kernel (K2): from x0 = 0, roll
    ``t_len`` steps.  Weights all float32 or all bfloat16 (the bf16
    instantiation); h0 (B, H) float32.  Returns (B, t_len, D) float32; the
    caller prepends the reference's leading zero step."""
    dtype = _weights_dtype(dec, out)
    if h0.device.type == "cpu":
        return errvae_sample_plain(dec, out, h0, d, t_len)
    dev = h0.device
    b, hidden = h0.shape
    g = 3 * hidden
    _check(dev, "errvae_sample", dtype, w_ih=(dec.w_ih, (g, d)),
           w_hh=(dec.w_hh, (g, hidden)), b_ih=(dec.b_ih, (g,)),
           b_hh=(dec.b_hh, (g,)), ro_w=(out.w, (d, hidden)),
           ro_b=(out.b, (d,)), h0=(h0, (b, hidden)))
    half = dtype == torch.bfloat16
    plan, _ = _plan("errvae", 1, b, d, hidden, dev, 2 if half else 4)
    res = torch.empty((b, t_len, d), device=dev, dtype=torch.float32)
    biases = (dec.b_ih.contiguous(), dec.b_hh.contiguous(),
              out.w.contiguous(), out.b.contiguous())
    if plan.route == "resident":
        tensors = (h0.contiguous(), dec.w_ih.contiguous(),
                   dec.w_hh.contiguous(), *biases, res)
    else:
        tensors = (h0.contiguous(), _packed_weights(dec.w_ih, dec.w_hh),
                   *biases, res, *_stream_scratch(plan, 1, b, d, hidden, dev))
    name = "errvae_sample_bf16" if half else "errvae_sample"
    _launch(f"vcx_errvae_sample_{plan.route}{'_bf16' if half else ''}", dev,
            tensors, (b, t_len, d, hidden, plan.bt,
                      *((plan.split,) if plan.route == "resident" else ())))
    LAUNCHES[name] += 1
    ROUTE_LAUNCHES[f"{name}_{plan.route}"] += 1
    return res
