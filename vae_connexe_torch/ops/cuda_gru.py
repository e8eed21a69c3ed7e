"""Stacked-head GRU recurrence kernels (port of ``vae_connexe_tpu/ops/pallas_gru.py``).

``fused_gru_scan_heads`` (forward) and ``gru_scan_heads_fused`` (forward and
backward, differentiable) keep the JAX entry points' contract: stacked
``GRUParams`` with leading axis P, x (B, T, D) shared or (P, B, T, D) per
head, h0 (P, B, H) or broadcastable to it; they return
(outs (P, B, T, H), h_T (P, B, H)).

On a CUDA tensor the forward launches B1 and the backward B2, both from
``csrc/gru.cu`` (built at first use, see ``_build.py``), and each adds one to
its count in ``LAUNCHES``.  On a CPU tensor they run their plain versions,
``gru_scan_heads`` under autograd.  There is no fallback from a kernel to
its plain version: a CUDA input launches or raises.  ``recurrence_route``
picks, from the shapes and the card's limits before any launch, the kernels
that stage both weights in shared memory or, where they do not fit a block
together (hidden 128 on an H100), their wide variants: B1 and B2's chain
project the input of every step first and walk time on thread-block
clusters that split W_hh's units (``wide_fwd_plan``, ``wide_chain_plan``);
each variant has its own count.
Shapes that neither fits raise.  Each kernel's plan (variant and batch
tile) is chosen once per (shapes, device) and cached (``_fwd_plan``,
``_bwd_plan``).

The backward is a ``torch.autograd.Function`` whose forward is B1.  h0 is
broadcast to (P, B, H) outside it, so autograd sums dh0 over a broadcast
h0 such as (P, 1, H) or one z shared by every head.  B2 runs in two
phases, each with its plain version here: ``bwd_chain`` (the serial dh
chain, writing the gate gradients gh (P, B, T, 4H) and dh0) and
``bwd_wgrad`` (dW, db and dx from gh, parallel over B*T).  The weight
gradients are written as partials over fixed chunks of B*T and summed here
in a fixed order, so a step is deterministic.  The kernels run in float32
and sum in another order than ``einsum``; ``chip_smoke.py`` states the
tolerances.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vae_connexe_torch.ops.gru import GRUParams, gru_scan_heads

# Kernel launches per wrapper and variant, counted where the kernel is
# launched.
LAUNCHES = {"gru_forward": 0, "gru_backward": 0, "gru_forward_wide": 0,
            "gru_backward_wide": 0}

# Batch tiles: B1's (csrc/gru_fwd.cuh: any multiple of 4 rows up to 32);
# the forward body that B3 runs (csrc/gru_tile.cuh, ``cuda_step``); and the
# backward chain's (csrc/gru_bwd.cuh, launch_chain()), which adds the other
# multiples of 4 to the latter.
FWD_TILES = (32, 28, 24, 20, 16, 12, 8, 4)
TILES = (32, 16, 8, 4, 2, 1)
CHAIN_TILES = (32, 28, 24, 20, 16, 12, 8, 4, 2, 1)
MAX_THREADS = 512         # gru_tile.cuh kMaxThreads, gru_fwd.cuh kFwdMaxThreads
BLOCK_RESERVED = 1024     # shared memory the runtime keeps per block


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def rows_per_thread(bt: int) -> int:
    """Rows each thread computes (gru_tile.cuh ``rows_per_thread``)."""
    return 1 if bt <= 4 else bt // 4


def block_threads(bt: int, hidden: int) -> int:
    return hidden * (bt // rows_per_thread(bt))


def fwd_smem_bytes(bt: int, d: int, hidden: int) -> int:
    """Shared memory of a block of gru_tile.cuh's forward body, which B3's
    forward launches run (``fwd_smem_floats``): W_ih^T and W_hh^T padded to
    3H + 1, both biases, the state and input of the tile."""
    g1 = 3 * hidden + 1
    return 4 * (d * g1 + hidden * g1 + 6 * hidden + bt * hidden + bt * d)


def _round4(n: int) -> int:
    return (n + 3) // 4 * 4


def chain_smem_bytes(bt: int, d: int, hidden: int) -> int:
    """Shared memory of a backward chain block (gru_bwd.cuh
    ``chain_smem_floats``): both weights transposed, padded to rows of a
    multiple of 4, both biases, two buffers of the step's h_prev and x rows
    (padded likewise), the step's gate gradients and two buffers of douts
    rows."""
    g1, dp, hp = 3 * hidden + 1, _round4(d), _round4(hidden)
    head = _round4((dp + hp) * g1 + 6 * hidden)
    return 4 * (head + 2 * bt * (hp + dp) + bt * _round4(3 * hidden)
                + 2 * bt * hidden)


def chain_step_loads(bt: int, d: int, hidden: int) -> float:
    """Shared-memory loads a chain thread issues per step (gru_bwd.cuh
    ``chain_preacts`` and the d h_prev walk): per k of x and h_prev three
    weights and a quarter of a float4 per row; per gate one weight and a
    quarter of a float4 per row.  The chain is bound by these loads, so a
    tile of more rows per thread is cheaper per row."""
    rpt = rows_per_thread(bt)
    return ((_round4(d) + _round4(hidden)) * (3 + rpt / 4)
            + _round4(3 * hidden) * (1 + rpt / 4))


# B1 and B2's chain on wide shapes (csrc/gru_wide.cuh): the input
# projection, then the walk on clusters of WIDE_CLUSTER blocks that split
# W_hh's units.  Tiles: 16 to 64 rows, a warp a (16 rows, 16 units) item,
# at most 256 threads a chain block, 512 a forward block.
WIDE_CLUSTER = 2
WIDE_TILES = (64, 48, 32, 16)
WIDE_MAX_THREADS = 256
# Registers a thread of the walk may take (``__launch_bounds__(256, 1)``).
WIDE_REGS = 255
# The walk's cost model (``wide_step_cost``), fitted to the sweep of
# ``tools/torch_gru_bwd_tiles.py --wide`` on an H100 (every tile at
# lorenz96_scaled's and lorenz96_xl's heads and the one-head encoder; the
# fit picks the fastest at the first two and one within 2% at the third):
# the products' multiply-adds (counted as float32 ones; the tensor cores
# run each as three TF32 passes) an SM retires a cycle, the warps below
# which it retires them slower, and a step's cycles outside the products
# (gate math, loads, the cluster barrier).
WIDE_FMA_PER_CYCLE = 120
WIDE_SAT_WARPS = 4
WIDE_STEP_CYCLES = 10500


def wide_hpad(hidden: int) -> int:
    """Units of the wide walks: H rounded up to 16 a block of the cluster
    (gru_wide.cuh ``wide_hpad``); pad units have zero weights."""
    q = 16 * WIDE_CLUSTER
    return -(-hidden // q) * q


def wide_units(hidden: int) -> int:
    """Units each block of a cluster owns (``wide_units``)."""
    return wide_hpad(hidden) // WIDE_CLUSTER


def wide_chain_threads(bt: int, hidden: int) -> int:
    """Threads of a wide chain block: a warp a (16 rows, 16 units) item
    (``wide_threads``)."""
    return 32 * (wide_units(hidden) // 16) * (bt // 16)


def wide_chain_smem_bytes(bt: int, hidden: int) -> int:
    """Shared memory of a wide chain block (``wide_smem_floats``): the
    block's W_hh rows (3U of H' + 4 floats) and b_hh, two buffers of h_prev
    rows, the step's gate gradients (3U + 4 a row) and the d h_prev
    partials (a slot of U + 4 a row for each block of the cluster, two
    buffers)."""
    u, ks = wide_units(hidden), wide_hpad(hidden) + 4
    return 4 * (3 * u * ks + 3 * u + 2 * bt * ks + bt * (3 * u + 4)
                + 2 * WIDE_CLUSTER * bt * (u + 4))


def wide_blocks_per_sm(bt: int, hidden: int, limits) -> int:
    """Wide chain blocks an SM holds at once, by shared memory, threads and
    registers (0: the block does not fit)."""
    optin, smem_sm, _, threads_sm = limits
    need = wide_chain_smem_bytes(bt, hidden)
    threads = wide_chain_threads(bt, hidden)
    if (need > optin or threads > WIDE_MAX_THREADS or bt % 16 or bt > 64
            or bt < 16):
        return 0
    return min(smem_sm // (need + BLOCK_RESERVED), threads_sm // threads,
               65536 // (threads * WIDE_REGS))


def _cluster_step_cost(bt: int, hidden: int, blocks: int, per_sm: int,
                       n_sm: int, fma_row: int, fixed: float) -> float:
    """Cycles of one step of a wide walk over the whole grid: rounds of the
    clusters the card holds at once, each as long as its busiest SM's
    multiply-adds (``fma_row`` a row) at the rate its warps reach, plus the
    step's ``fixed`` cycles."""
    warps = wide_chain_threads(bt, hidden) // 32
    busy = min(per_sm, math.ceil(blocks / n_sm))
    held = max(1, n_sm * per_sm // WIDE_CLUSTER)
    rounds = math.ceil(blocks // WIDE_CLUSTER / held)
    eff = min(1.0, busy * warps / WIDE_SAT_WARPS)
    return rounds * (busy * bt * fma_row / (WIDE_FMA_PER_CYCLE * eff)
                     + fixed)


def wide_step_cost(bt: int, hidden: int, blocks: int, per_sm: int,
                   n_sm: int) -> float:
    """Cycles of one step of the wide chain (``_cluster_step_cost``): the
    hidden half and d h_prev, 6 U H' multiply-adds a row."""
    return _cluster_step_cost(
        bt, hidden, blocks, per_sm, n_sm,
        6 * wide_units(hidden) * wide_hpad(hidden), WIDE_STEP_CYCLES)


def _cluster_plan(batch: int, heads: int, per_sm_fn, cost_fn,
                  limits) -> int | None:
    """The cheapest batch tile of ``WIDE_TILES`` by ``cost_fn(bt, blocks,
    per_sm, SMs)`` among those ``per_sm_fn(bt)`` fits, the first on a tie
    (the wider tile), or None; a tile of twice the batch or more only idles
    threads and is not taken unless it is the narrowest."""
    best = None
    for bt in WIDE_TILES:
        if bt > min(WIDE_TILES) and bt >= 2 * batch:
            continue
        per_sm = per_sm_fn(bt)
        if per_sm < 1:
            continue
        blocks = heads * math.ceil(batch / bt) * WIDE_CLUSTER
        cost = cost_fn(bt, blocks, per_sm, limits[2])
        if best is None or cost < best[0]:
            best = (cost, bt)
    return None if best is None else best[1]


def wide_chain_plan(batch: int, heads: int, hidden: int,
                    limits) -> int | None:
    """The wide chain's batch tile at these shapes on a card of ``limits``
    (by ``wide_step_cost``), or None when no block fits (hidden above 132
    on an H100)."""
    return _cluster_plan(
        batch, heads, lambda bt: wide_blocks_per_sm(bt, hidden, limits),
        lambda bt, *rest: wide_step_cost(bt, hidden, *rest), limits)


# B1's wide forward (csrc/gru_wide.cuh ``gru_fwd_wide_body``): the chain's
# clusters, staged W_hh rows and warp items (``wide_chain_threads``), one
# product a step; tiles of up to 512 threads (``__launch_bounds__(512,
# 1)``: 128 registers a thread above 256 threads).  The cost model's fixed
# cycles a step, with the chain's rate: the sweep of
# ``tools/torch_gru_fwd_tiles.py --wide`` on an H100 put the walk within 2%
# of the model at lorenz96_scaled's and lorenz96_xl's heads and the
# one-head encoder, and the model's tile was the fastest at every shape.
WIDE_FWD_MAX_THREADS = 512
WIDE_FWD_STEP_CYCLES = 6000


def wide_fwd_smem_bytes(bt: int, hidden: int) -> int:
    """Shared memory of a wide forward block (``wide_fwd_smem_floats``): the
    block's W_hh rows (3U of H' + 4 floats), b_hh and two buffers of h
    rows."""
    u, ks = wide_units(hidden), wide_hpad(hidden) + 4
    return 4 * (3 * u * ks + 3 * u + 2 * bt * ks)


def wide_fwd_blocks_per_sm(bt: int, hidden: int, limits) -> int:
    """Wide forward blocks an SM holds at once, by shared memory, threads
    and registers (0: the block does not fit)."""
    optin, smem_sm, _, threads_sm = limits
    need = wide_fwd_smem_bytes(bt, hidden)
    threads = wide_chain_threads(bt, hidden)
    if (need > optin or threads > WIDE_FWD_MAX_THREADS or bt % 16 or bt > 64
            or bt < 16):
        return 0
    regs = WIDE_REGS if threads <= WIDE_MAX_THREADS else 128
    return min(smem_sm // (need + BLOCK_RESERVED), threads_sm // threads,
               65536 // (threads * regs))


def wide_fwd_step_cost(bt: int, hidden: int, blocks: int, per_sm: int,
                       n_sm: int) -> float:
    """Cycles of one step of the wide forward (``_cluster_step_cost``): the
    hidden half alone, 3 U H' multiply-adds a row."""
    return _cluster_step_cost(
        bt, hidden, blocks, per_sm, n_sm,
        3 * wide_units(hidden) * wide_hpad(hidden), WIDE_FWD_STEP_CYCLES)


def wide_fwd_plan(batch: int, heads: int, hidden: int,
                  limits) -> int | None:
    """The wide forward's batch tile at these shapes on a card of
    ``limits`` (by ``wide_fwd_step_cost``), or None when no block fits."""
    return _cluster_plan(
        batch, heads, lambda bt: wide_fwd_blocks_per_sm(bt, hidden, limits),
        lambda bt, *rest: wide_fwd_step_cost(bt, hidden, *rest), limits)


def fwd_units(hidden: int) -> int:
    """Units of B1's thread tiles (gru_fwd.cuh ``fwd_units``): H rounded up
    to even."""
    return hidden + hidden % 2


def fwd_weight_stride(hidden: int) -> int:
    """Row stride of B1's staged weights (gru_fwd.cuh
    ``fwd_weight_stride``): 3 ``fwd_units`` padded to 16 past a multiple of
    32 floats."""
    g = 3 * fwd_units(hidden)
    return g + (48 - g % 32) % 32


def fwd_tile_smem_bytes(bt: int, d: int, hidden: int) -> int:
    """Shared memory of a B1 block (gru_fwd.cuh ``fwd_tile_smem_floats``):
    W_ih^T and W_hh^T at ``fwd_weight_stride``, then two buffers each of
    the step's input and state rows."""
    return 4 * (_round4((d + hidden) * fwd_weight_stride(hidden))
                + 2 * bt * (d + fwd_units(hidden)))


def fwd_tile_threads(bt: int, hidden: int) -> int:
    """Threads of a B1 block: two per 4 rows x 2 units (k split over two
    lanes)."""
    return fwd_units(hidden) // 2 * (bt // 4) * 2


def fwd_step_cost(bt: int, d: int, hidden: int, blocks: int, per_sm: int,
                  n_sm: int) -> float:
    """B1's issue cycles a step on the busiest SM.  For each round of blocks
    resident at once: a warp's instructions of a step (about 15 for each of
    the D + H inputs, which the k split halves, and 150 of gate math) times
    the warps each of the SM's four schedulers holds, plus two warps'
    worth for the latency that a scheduler with few warps cannot hide.
    Fitted to the tile sweep of ``tools/torch_gru_fwd_tiles.py`` on an
    H100: 20 rows on 20 heads, 8 on one."""
    on_sm = math.ceil(blocks / n_sm)
    warps = math.ceil(fwd_tile_threads(bt, hidden) / 32)
    per_warp = 15 * (d + hidden) + 150
    cost = 0
    while on_sm > 0:
        now = min(on_sm, per_sm)
        cost += (math.ceil(now * warps / 4) + 2) * per_warp
        on_sm -= now
    return cost


def fit_tile(batch: int, heads: int, hidden: int, tiles, smem_fn, threads_fn,
             cost_fn, limits) -> int | None:
    """Batch tile of a (head, tile) grid, one of ``tiles``, or None when no
    tile fits.

    ``smem_fn(bt)`` gives a block's shared memory and ``threads_fn(bt,
    hidden)`` its threads; ``limits`` is (opt-in shared memory of a block,
    shared memory of an SM, SM count, threads of an SM).  Each tile that
    fits costs ``cost_fn(bt, blocks, blocks an SM holds, SMs)``.  The
    cheapest wins, the widest on a tie (fewer blocks stage the weights).
    A tile of twice the batch or more only idles threads and is not taken,
    unless it is the narrowest.
    """
    optin, smem_sm, n_sm, threads_sm = limits
    best = None
    for bt in tiles:
        need, threads = smem_fn(bt), threads_fn(bt, hidden)
        if (need > optin or threads > MAX_THREADS
                or (bt > min(tiles) and bt >= 2 * batch)):
            continue
        per_sm = min(smem_sm // (need + BLOCK_RESERVED), threads_sm // threads)
        if per_sm < 1:
            continue
        blocks = heads * math.ceil(batch / bt)
        cost = cost_fn(bt, blocks, per_sm, n_sm)
        if best is None or cost < best[0]:
            best = (cost, bt)
    return None if best is None else best[1]


def _waves_cost(step_fn):
    """A tile's cost as the number of waves of blocks times ``step_fn(bt)``,
    a block's cost per step."""
    return lambda bt, blocks, per_sm, n_sm: (
        math.ceil(blocks / (n_sm * per_sm)) * step_fn(bt))


def pick_tile(batch: int, heads: int, hidden: int, smem_fn, limits,
              step_fn=rows_per_thread, tiles=TILES) -> int:
    """Batch tile of a (head, tile) grid of gru_tile.cuh's or gru_bwd.cuh's
    bodies: ``fit_tile`` at ``block_threads``, costing a tile as its waves
    of blocks times ``step_fn(bt)``, by default the rows each thread
    computes (a thread's work per step does not shrink below one row, so
    tiles of 1 to 4 rows cost the same per block); the backward chain
    passes ``chain_step_loads`` and ``CHAIN_TILES``.  Raises when no tile
    fits."""
    bt = fit_tile(batch, heads, hidden, tiles, smem_fn, block_threads,
                  _waves_cost(step_fn), limits)
    if bt is None:
        raise ValueError(
            f"GRU kernel: one row of hidden {hidden} needs {smem_fn(1)} bytes "
            f"of shared memory and {block_threads(1, hidden)} threads, over "
            f"the device's {limits[0]} bytes / {MAX_THREADS} threads")
    return bt


def fwd_tile(batch: int, heads: int, d: int, hidden: int, limits,
             wide: bool = False) -> int | None:
    """B1's batch tile (``fwd_step_cost`` over ``FWD_TILES``; or, if
    ``wide``, the wide forward's plan, ``wide_fwd_plan``), or None when no
    tile fits."""
    if wide:
        return wide_fwd_plan(batch, heads, hidden, limits)
    return fit_tile(batch, heads, hidden, FWD_TILES,
                    lambda n: fwd_tile_smem_bytes(n, d, hidden),
                    fwd_tile_threads,
                    lambda n, *rest: fwd_step_cost(n, d, hidden, *rest),
                    limits)


def chain_tile(batch: int, heads: int, d: int, hidden: int, limits,
               wide: bool = False) -> int | None:
    """The batch tile of B2's chain (or, if ``wide``, of the wide chain's
    plan, ``wide_chain_plan``), or None when no tile fits."""
    if wide:
        return wide_chain_plan(batch, heads, hidden, limits)
    return fit_tile(batch, heads, hidden, CHAIN_TILES,
                    lambda n: chain_smem_bytes(n, d, hidden), block_threads,
                    _waves_cost(lambda n: chain_step_loads(n, d, hidden)),
                    limits)


@functools.cache
def recurrence_route(heads: int, batch: int, d: int, hidden: int,
                     limits) -> str:
    """The kernels a recurrence of these shapes runs on a card of
    ``limits``, chosen before any launch: ``"kernel"`` when B1's tile and
    B2's chain tile both fit a block with W_ih^T and W_hh^T in shared
    memory, else ``"wide"`` when the wide forward (``wide_fwd_plan``) and
    the wide chain (``wide_chain_plan``) fit (hidden 128 on an H100, and
    up to 132).  Raises ValueError when neither fits."""
    for route, wide in (("kernel", False), ("wide", True)):
        if (fwd_tile(batch, heads, d, hidden, limits, wide) is not None
                and chain_tile(batch, heads, d, hidden, limits, wide)
                is not None):
            return route
    raise ValueError(
        f"GRU kernel: no tile of B1 or B2's chain fits the device's shared "
        f"memory ({limits[0]} bytes a block) at {heads} heads, batch "
        f"{batch}, D={d}, H={hidden}, even on the wide route's clusters")


# gru_bwd.cuh's weight-gradient block tile: 64 gate rows, 32 rows of K a stage;
# dW_hh tiles are 64 columns wide, dW_ih tiles 32.
WGRAD_BM, WGRAD_BK, WGRAD_MIN_CHUNK = 64, 32, 64
# Blocks of 128 threads at 79 registers (ptxas, sm_90a) and 32 KB of
# shared memory: six fit an SM by registers; the rule counts four.
WGRAD_BLOCKS_PER_SM = 4


def wgrad_splits(batch: int, steps: int, d: int, hidden: int, heads: int,
                 n_sm: int) -> tuple[int, int]:
    """(splits, chunk) of the weight-gradient kernel: the K = B*T rows are
    cut into ``splits`` chunks of ``chunk`` rows (a multiple of 32, at
    least 64), as many as keep the grid within one round of the blocks the
    card holds at once (an SM holds ``WGRAD_BLOCKS_PER_SM``).  Each chunk
    adds a partial of every head's dW and db for the wrapper's sum to read,
    so the rule stops at one round, though the kernel alone runs faster at
    more, smaller chunks (``tools/torch_gru_bwd_tiles.py``).  Shapes and
    the SM count alone decide it, so the partials, and their sum, are the
    same on every call."""
    k = batch * steps
    mt = math.ceil(3 * hidden / WGRAD_BM)
    tiles = heads * mt * (math.ceil(hidden / 64) + math.ceil(d / 32))
    want = max(1, WGRAD_BLOCKS_PER_SM * n_sm // tiles)
    chunk = max(WGRAD_MIN_CHUNK,
                math.ceil(math.ceil(k / want) / WGRAD_BK) * WGRAD_BK)
    return math.ceil(k / chunk), chunk


@functools.cache
def device_limits(device: torch.device) -> tuple[int, int, int, int]:
    """``pick_tile``'s limits, read from ``device`` once."""
    from vae_connexe_torch.ops._build import gru_library

    out = (ctypes.c_int * 4)()
    rc = gru_library().vcx_device_limits(device.index or 0, out)
    if rc != 0:
        raise RuntimeError(f"cannot read the limits of {device} (cuda {rc})")
    return tuple(out)


def _launch(lib, fn_name: str, device: torch.device, args) -> None:
    """Call ``fn_name`` of ``lib`` on ``device``'s current stream; raise on
    the CUDA error it returns.  Tensors pass as their data pointers."""
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor)
            else ctypes.c_void_p(None) if a is None else a for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*conv, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} failed: "
                           f"{lib.vcx_error_string(rc).decode()} (cuda {rc})")


def _inner_stride_one(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def _operands(w_ih, b_ih, w_hh, b_hh, x, h0):
    """Validate the kernel operands; returns (shapes, x and its (head, row,
    step) strides, h0 and its (head, row) strides)."""
    dev = x.device
    p, g, d = w_ih.shape
    hidden = w_hh.shape[-1]
    per_head = x.ndim == 4
    b, t = x.shape[-3], x.shape[-2]
    want = {"w_ih": (w_ih, (p, 3 * hidden, d)),
            "w_hh": (w_hh, (p, 3 * hidden, hidden)),
            "b_ih": (b_ih, (p, 3 * hidden)), "b_hh": (b_hh, (p, 3 * hidden)),
            "x": (x, (p, b, t, d) if per_head else (b, t, d)),
            "h0": (h0, (p, b, hidden))}
    for name, (v, shape) in want.items():
        if v.device != dev or v.dtype != torch.float32:
            raise ValueError(f"GRU kernel: {name} is {v.dtype} on {v.device}; "
                             f"the kernel takes float32 on {dev}")
        if tuple(v.shape) != shape:
            raise ValueError(f"GRU kernel: {name} has shape {tuple(v.shape)}, "
                             f"expected {shape}")
    x = _inner_stride_one(x)
    xs = (x.stride(0), x.stride(1), x.stride(2)) if per_head else \
        (0, x.stride(0), x.stride(1))
    h0 = _inner_stride_one(h0)
    return (p, b, t, d, hidden), x, xs, h0, (h0.stride(0), h0.stride(1))


@functools.cache
def _fwd_plan(shapes, dev: torch.device) -> tuple[int, bool]:
    """(batch tile, wide) of B1 at ``shapes`` on ``dev``."""
    p, b, _, d, hidden = shapes
    limits = device_limits(dev)
    wide = recurrence_route(p, b, d, hidden, limits) == "wide"
    return fwd_tile(b, p, d, hidden, limits, wide), wide


def _forward_kernel(ops, w, outs, bt: int, wide: bool) -> None:
    """Launch ``gru_forward_kernel`` or, if ``wide``, the wide forward
    (``gru_xproj_kernel<3>`` into a (P, B, T, 3H) scratch, then
    ``gru_forward_wide_kernel``) into outs (validated operands) on tiles of
    ``bt`` rows."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = ops
    w_ih, b_ih, w_hh, b_hh = (v.contiguous() for v in w)
    xp = (torch.empty((p, b, t, 3 * hidden), device=x.device,
                      dtype=torch.float32) if wide else None)
    _launch(gru_library(), "vcx_gru_forward", x.device,
            (x, *xs, w_ih, w_hh, b_ih, b_hh, h0, *hs, outs, xp, p, b, t, d,
             hidden, bt))


def _forward_launch(w_ih, b_ih, w_hh, b_hh, x, h0) -> torch.Tensor:
    """B1: outs (P, B, T, H)."""
    ops = _operands(w_ih, b_ih, w_hh, b_hh, x, h0)
    shapes, x = ops[0], ops[1]
    outs = torch.empty((shapes[0], shapes[1], shapes[2], shapes[4]),
                       device=x.device, dtype=torch.float32)
    bt, wide = _fwd_plan(shapes, x.device)
    _forward_kernel(ops, (w_ih, b_ih, w_hh, b_hh), outs, bt, wide)
    LAUNCHES["gru_forward_wide" if wide else "gru_forward"] += 1
    return outs


def _h_prev(h0, outs):
    """h_prev of every step: h0 at t=0, else outs[t-1]; (P, B, T, H)."""
    return torch.cat([h0.expand(outs.shape[0], outs.shape[1],
                                outs.shape[3])[:, :, None], outs[:, :, :-1]],
                     dim=2)


def bwd_chain_plain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts):
    """Plain version of B2's first phase: rematerialise the gates from
    h_prev and x, walk time in reverse, and return the gate gradients
    gh (P, B, T, 4H) = [dbr, dz, da*r, da] with dh0 (P, B, H)."""
    p, b, t, hidden = outs.shape
    hp = _h_prev(h0, outs)
    xs = x if x.ndim == 4 else x.expand(p, *x.shape)
    gi = torch.einsum("pbtd,pgd->pbtg", xs, w_ih) + b_ih[:, None, None]
    gg = torch.einsum("pbtk,pgk->pbtg", hp, w_hh) + b_hh[:, None, None]
    ir, iz, i_n = gi.chunk(3, dim=-1)
    hr, hz, hn = gg.chunk(3, dim=-1)
    r, z = torch.sigmoid(ir + hr), torch.sigmoid(iz + hz)
    n = torch.tanh(i_n + r * hn)
    gh = torch.empty((p, b, t, 4 * hidden), dtype=outs.dtype,
                     device=outs.device)
    dh = torch.zeros((p, b, hidden), dtype=outs.dtype, device=outs.device)
    for s in reversed(range(t)):
        d = dh + douts[:, :, s]
        zs, ns, rs = z[:, :, s], n[:, :, s], r[:, :, s]
        dz = d * (hp[:, :, s] - ns) * zs * (1 - zs)
        da = d * (1 - zs) * (1 - ns * ns)
        dbr = da * hn[:, :, s] * rs * (1 - rs)
        gh[:, :, s] = torch.cat([dbr, dz, da * rs, da], dim=-1)
        dh = d * zs + torch.einsum("pbg,pgk->pbk", gh[:, :, s, :3 * hidden],
                                   w_hh)
    return gh, dh


def bwd_wgrad_plain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, gh, need_dx: bool):
    """Plain version of B2's second phase: (dx or None, dW_ih, db_ih,
    dW_hh, db_hh) from the gate gradients, h_prev and x; dx is summed over
    heads for a shared (B, T, D) input."""
    hidden = outs.shape[-1]
    ghid = gh[..., :3 * hidden]
    gx = torch.cat([gh[..., :2 * hidden], gh[..., 3 * hidden:]], dim=-1)
    xs = x if x.ndim == 4 else x.expand(outs.shape[0], *x.shape)
    dwhh = torch.einsum("pbtg,pbtk->pgk", ghid, _h_prev(h0, outs))
    dwih = torch.einsum("pbtg,pbtd->pgd", gx, xs)
    dx = None
    if need_dx:
        dx = torch.einsum("pbtg,pgd->pbtd", gx, w_ih)
        if x.ndim == 3:
            dx = dx.sum(dim=0)
    return dx, dwih, gx.sum(dim=(1, 2)), dwhh, ghid.sum(dim=(1, 2))


@functools.cache
def _bwd_plan(shapes, dev: torch.device) -> tuple[int, int, int, bool]:
    """(chain tile, splits, chunk, wide) of B2 at ``shapes`` on ``dev``."""
    p, b, t, d, hidden = shapes
    limits = device_limits(dev)
    wide = recurrence_route(p, b, d, hidden, limits) == "wide"
    return (chain_tile(b, p, d, hidden, limits, wide),
            *wgrad_splits(b, t, d, hidden, p, limits[2]), wide)


def _bwd_operands(w_ih, b_ih, w_hh, b_hh, x, h0, outs, extra, name):
    """``_operands`` plus outs (P, B, T, H) and ``extra`` (douts or gh),
    both contiguous."""
    ops = _operands(w_ih, b_ih, w_hh, b_hh, x, h0)
    p, b, t, _, hidden = ops[0]
    width = {"douts": hidden, "gh": 4 * hidden}[name]
    for n, v, shape in (("outs", outs, (p, b, t, hidden)),
                        (name, extra, (p, b, t, width))):
        if tuple(v.shape) != shape or v.device != x.device:
            raise ValueError(f"GRU kernel: {n} must be {shape} on {x.device}")
    return ops, outs.contiguous(), extra.contiguous()


def _chain_kernel(ops, w, outs, douts, gh, dh0, bt: int, wide: bool) -> None:
    """Launch ``gru_chain_kernel`` or, if ``wide``, the wide chain
    (``gru_xproj_kernel`` then ``gru_chain_wide_kernel``) into gh and dh0
    (validated operands)."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = ops
    w_ih, b_ih, w_hh, b_hh = (v.contiguous() for v in w)
    _launch(gru_library(), "vcx_gru_bwd_chain", x.device,
            (x, *xs, w_ih, w_hh, b_ih, b_hh, h0, *hs, outs, douts, gh, dh0,
             p, b, t, d, hidden, bt, int(wide)))


def xproj_plain(w_ih, b_ih, x):
    """Plain version of the wide routes' input projection: x W_ih^T + b_ih
    of every head, (P, B, T, 3H), x shared (B, T, D) or per head."""
    xs = x if x.ndim == 4 else x.expand(w_ih.shape[0], *x.shape)
    return torch.einsum("pbtd,pgd->pbtg", xs, w_ih) + b_ih[:, None, None]


def fwd_wide_plain(w_ih, b_ih, w_hh, b_hh, x, h0):
    """Plain version of the wide forward's decomposition: the projection
    of every step first (``xproj_plain``), then a walk whose step product
    is h W_hh^T alone, torch nn.GRU's gate math; outs (P, B, T, H) from h0
    (P, B, H)."""
    xp = xproj_plain(w_ih, b_ih, x)
    xr, xz, xn = xp.chunk(3, dim=-1)
    h, outs = h0, []
    for s in range(xp.shape[2]):
        hr, hz, hn = (torch.einsum("pbk,pgk->pbg", h, w_hh)
                      + b_hh[:, None]).chunk(3, dim=-1)
        r = torch.sigmoid(xr[:, :, s] + hr)
        z = torch.sigmoid(xz[:, :, s] + hz)
        n = torch.tanh(xn[:, :, s] + r * hn)
        h = (1 - z) * n + z * h
        outs.append(h)
    return torch.stack(outs, dim=2)


def bwd_xproj(w_ih, b_ih, x):
    """The wide chain's input projection, ``gru_xproj_kernel``, alone:
    (P, B, T, 3H), the first 3H columns of the gh scratch it writes.  A
    CPU tensor runs ``xproj_plain``."""
    if x.device.type == "cpu":
        return xproj_plain(w_ih, b_ih, x)
    from vae_connexe_torch.ops._build import gru_library

    p, g, d = w_ih.shape
    hidden = g // 3
    per_head = x.ndim == 4
    b, t = x.shape[-3], x.shape[-2]
    for name, v, shape in (("w_ih", w_ih, (p, g, d)), ("b_ih", b_ih, (p, g)),
                           ("x", x, (p, b, t, d) if per_head else (b, t, d))):
        if (tuple(v.shape) != shape or v.device != x.device
                or v.dtype != torch.float32):
            raise ValueError(f"GRU kernel: {name} must be float32 {shape} "
                             f"on {x.device}")
    x = _inner_stride_one(x)
    xs = (x.stride(0), x.stride(1), x.stride(2)) if per_head else \
        (0, x.stride(0), x.stride(1))
    gh = torch.empty((p, b, t, 4 * hidden), device=x.device,
                     dtype=torch.float32)
    _launch(gru_library(), "vcx_gru_xproj", x.device,
            (x, *xs, w_ih.contiguous(), b_ih.contiguous(), gh, p, b, t, d,
             hidden))
    return gh[..., :g]


def _wgrad_kernel(ops, w_ih, outs, gh, dx, part, splits: int,
                  chunk: int) -> None:
    """Launch ``gru_wgrad_kernel`` (and ``gru_dx_kernel`` unless dx is
    None) into the partials ``part`` (validated operands)."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = ops
    _launch(gru_library(), "vcx_gru_bwd_wgrad", x.device,
            (gh, x, *xs, h0, *hs, outs, w_ih.contiguous(), dx, part, p, b, t,
             d, hidden, splits, chunk))


def _chain_buffers(ops):
    """gh (P, B, T, 4H) and dh0 (P, B, H) for the chain kernel."""
    (p, b, t, _, hidden), x = ops[0], ops[1]
    f32 = dict(device=x.device, dtype=torch.float32)
    return (torch.empty((p, b, t, 4 * hidden), **f32),
            torch.empty((p, b, hidden), **f32))


def _wgrad_buffers(ops, need_dx: bool, splits: int):
    """dx (per head) or None, and the partials of the weight gradients."""
    (p, b, t, d, hidden), x = ops[0], ops[1]
    f32 = dict(device=x.device, dtype=torch.float32)
    dx = torch.empty((p, b, t, d), **f32) if need_dx else None
    return dx, torch.empty((p, splits, 3 * hidden * (hidden + d + 2)), **f32)


def wgrad_totals(part, d: int, hidden: int):
    """(dW_ih, db_ih, dW_hh, db_hh) from the weight-gradient kernel's
    partials (P, splits, 3H * (H + D + 2)), summed over the splits in a
    fixed order."""
    p, g = part.shape[0], 3 * hidden
    tot = part.sum(dim=1)
    o1, o2, o3 = g * hidden, g * (hidden + d), g * (hidden + d + 1)
    return (tot[:, o1:o2].view(p, g, d), tot[:, o3:],
            tot[:, :o1].view(p, g, hidden), tot[:, o2:o3])


def _wgrad_sums(ops, dx, part):
    """(dx, dW_ih, db_ih, dW_hh, db_hh) from the kernel's outputs: the
    partials summed over the splits, dx over heads for a shared input."""
    (p, _, _, d, hidden), x = ops[0], ops[1]
    if dx is not None and x.ndim == 3:
        dx = dx.sum(dim=0) if p > 1 else dx[0]
    return (dx, *wgrad_totals(part, d, hidden))


def bwd_chain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts):
    """B2's first phase, ``gru_chain_kernel`` (on wide shapes the
    projection and ``gru_chain_wide_kernel``): (gh (P, B, T, 4H), dh0
    (P, B, H)).  A CPU tensor runs ``bwd_chain_plain``."""
    if x.device.type == "cpu":
        return bwd_chain_plain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts)
    ops, outs, douts = _bwd_operands(w_ih, b_ih, w_hh, b_hh, x, h0, outs,
                                     douts, "douts")
    gh, dh0 = _chain_buffers(ops)
    bt, _, _, wide = _bwd_plan(ops[0], x.device)
    _chain_kernel(ops, (w_ih, b_ih, w_hh, b_hh), outs, douts, gh, dh0, bt,
                  wide)
    return gh, dh0


def bwd_wgrad(w_ih, b_ih, w_hh, b_hh, x, h0, outs, gh, need_dx: bool):
    """B2's second phase, ``gru_wgrad_kernel`` (and ``gru_dx_kernel`` when
    ``need_dx``): (dx or None, dW_ih, db_ih, dW_hh, db_hh).  The kernel
    writes one partial per (head, split of B*T); they are summed here in a
    fixed order, and dx over heads for a shared input.  A CPU tensor runs
    ``bwd_wgrad_plain``."""
    if x.device.type == "cpu":
        return bwd_wgrad_plain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, gh,
                               need_dx)
    ops, outs, gh = _bwd_operands(w_ih, b_ih, w_hh, b_hh, x, h0, outs, gh,
                                  "gh")
    _, splits, chunk, _ = _bwd_plan(ops[0], x.device)
    dx, part = _wgrad_buffers(ops, need_dx, splits)
    _wgrad_kernel(ops, w_ih, outs, gh, dx, part, splits, chunk)
    return _wgrad_sums(ops, dx, part)


def _backward_launch(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts,
                     need_dx: bool):
    """B2 on a CUDA tensor, its two phases in one call of the library:
    (dx or None, dW_ih, db_ih, dW_hh, db_hh, dh0 (P, B, H))."""
    from vae_connexe_torch.ops._build import gru_library

    ops, outs, douts = _bwd_operands(w_ih, b_ih, w_hh, b_hh, x, h0, outs,
                                     douts, "douts")
    (p, b, t, d, hidden), xc, xs, h0c, hs = ops
    bt, splits, chunk, wide = _bwd_plan(ops[0], x.device)
    gh, dh0 = _chain_buffers(ops)
    dx, part = _wgrad_buffers(ops, need_dx, splits)
    _launch(gru_library(), "vcx_gru_backward", x.device,
            (xc, *xs, w_ih.contiguous(), w_hh.contiguous(), b_ih.contiguous(),
             b_hh.contiguous(), h0c, *hs, outs, douts, gh, dh0, dx, part, p,
             b, t, d, hidden, bt, int(wide), splits, chunk))
    LAUNCHES["gru_backward_wide" if wide else "gru_backward"] += 1
    return (*_wgrad_sums(ops, dx, part), dh0)


class _GruHeads(torch.autograd.Function):
    """outs = B1(params, x, h0); its backward is B2."""

    @staticmethod
    def forward(ctx, w_ih, b_ih, w_hh, b_hh, x, h0):
        outs = _forward_launch(w_ih, b_ih, w_hh, b_hh, x, h0)
        ctx.save_for_backward(w_ih, b_ih, w_hh, b_hh, x, h0, outs)
        return outs

    @staticmethod
    def backward(ctx, douts):
        w_ih, b_ih, w_hh, b_hh, x, h0, outs = ctx.saved_tensors
        dx, dwih, dbih, dwhh, dbhh, dh0 = _backward_launch(
            w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts,
            need_dx=ctx.needs_input_grad[4])
        return dwih, dbih, dwhh, dbhh, dx, dh0


def _broadcast_h0(params: GRUParams, x: torch.Tensor, h0: torch.Tensor):
    return h0.expand(params.w_ih.shape[0], x.shape[-3], params.hidden)


# The plain PyTorch versions of B1 and of B1 + B2: the autograd reference.
fused_gru_scan_heads_plain = gru_scan_heads_fused_plain = gru_scan_heads


def fused_gru_scan_heads(params: GRUParams, x: torch.Tensor,
                         h0: torch.Tensor):
    """Forward of the stacked-head recurrence in one kernel (B1), not
    differentiable.  Returns (outs (P, B, T, H), h_T (P, B, H))."""
    if x.device.type == "cpu":
        return fused_gru_scan_heads_plain(params, x, h0)
    outs = _forward_launch(params.w_ih, params.b_ih, params.w_hh,
                           params.b_hh, x, _broadcast_h0(params, x, h0))
    return outs, outs[:, :, -1]


def gru_scan_heads_fused(params: GRUParams, x: torch.Tensor,
                         h0: torch.Tensor):
    """Differentiable stacked-head recurrence: B1 forward, B2 backward.
    Returns (outs (P, B, T, H), h_T (P, B, H))."""
    if x.device.type == "cpu":
        return gru_scan_heads_fused_plain(params, x, h0)
    outs = _GruHeads.apply(params.w_ih, params.b_ih, params.w_hh,
                           params.b_hh, x, _broadcast_h0(params, x, h0))
    return outs, outs[:, :, -1]
