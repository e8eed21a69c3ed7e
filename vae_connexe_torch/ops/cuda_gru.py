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
its plain version: a CUDA input launches or raises.

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

# Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES = {"gru_forward": 0, "gru_backward": 0}

# Batch tiles the kernels are instantiated for: the forward's (csrc/gru.cu,
# launch_forward()), and the backward chain's (csrc/gru_bwd.cuh,
# launch_chain()), which adds the other multiples of 4.
TILES = (32, 16, 8, 4, 2, 1)
CHAIN_TILES = (32, 28, 24, 20, 16, 12, 8, 4, 2, 1)
MAX_THREADS = 512         # gru_tile.cuh kMaxThreads
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
    """Shared memory of a forward block (gru_tile.cuh ``fwd_smem_floats``):
    W_ih^T and W_hh^T padded to 3H + 1, both biases, the state and input of
    the tile."""
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


def pick_tile(batch: int, heads: int, hidden: int, smem_fn, limits,
              step_fn=rows_per_thread, tiles=TILES) -> int:
    """Batch tile of a (head, tile) grid, one of ``tiles``.

    ``smem_fn(bt)`` gives a block's shared memory; ``limits`` is (opt-in
    shared memory of a block, shared memory of an SM, SM count, threads of
    an SM).  For each tile that fits, the estimated time is the number of
    waves of blocks times ``step_fn(bt)``, a block's cost per step: by
    default the rows each thread computes (a thread's work per step does
    not shrink below one row, so tiles of 1 to 4 rows cost the same per
    block); the backward chain passes ``chain_step_loads`` and
    ``CHAIN_TILES``.  The cheapest wins, the widest on a tie (fewer blocks
    stage the weights).  A tile of twice the batch or more only idles
    threads and is not taken.  Raises when no tile fits.
    """
    optin, smem_sm, n_sm, threads_sm = limits
    best = None
    for bt in tiles:
        need, threads = smem_fn(bt), block_threads(bt, hidden)
        if need > optin or threads > MAX_THREADS or (bt > 1 and bt >= 2 * batch):
            continue
        per_sm = min(smem_sm // (need + BLOCK_RESERVED), threads_sm // threads)
        if per_sm < 1:
            continue
        blocks = heads * math.ceil(batch / bt)
        cost = math.ceil(blocks / (n_sm * per_sm)) * step_fn(bt)
        if best is None or cost < best[0]:
            best = (cost, bt)
    if best is None:
        raise ValueError(
            f"GRU kernel: one row of hidden {hidden} needs {smem_fn(1)} bytes "
            f"of shared memory and {block_threads(1, hidden)} threads, over "
            f"the device's {optin} bytes / {MAX_THREADS} threads")
    return best[1]


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


def _forward_launch(w_ih, b_ih, w_hh, b_hh, x, h0) -> torch.Tensor:
    """B1: outs (P, B, T, H)."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = _operands(w_ih, b_ih, w_hh, b_hh,
                                                    x, h0)
    dev = x.device
    bt = pick_tile(b, p, hidden, lambda n: fwd_smem_bytes(n, d, hidden),
                   device_limits(dev))
    outs = torch.empty((p, b, t, hidden), device=dev, dtype=torch.float32)
    _launch(gru_library(), "vcx_gru_forward", dev,
            (x, *xs, w_ih.contiguous(), w_hh.contiguous(), b_ih.contiguous(),
             b_hh.contiguous(), h0, *hs, outs, p, b, t, d, hidden, bt))
    LAUNCHES["gru_forward"] += 1
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
def _bwd_plan(shapes, dev: torch.device) -> tuple[int, int, int]:
    """(chain tile, splits, chunk) of B2 at ``shapes`` on ``dev``."""
    p, b, t, d, hidden = shapes
    limits = device_limits(dev)
    bt = pick_tile(b, p, hidden, lambda n: chain_smem_bytes(n, d, hidden),
                   limits, lambda n: chain_step_loads(n, d, hidden),
                   CHAIN_TILES)
    return (bt, *wgrad_splits(b, t, d, hidden, p, limits[2]))


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


def _chain_kernel(ops, w, outs, douts, gh, dh0, bt: int) -> None:
    """Launch ``gru_chain_kernel`` into gh and dh0 (validated operands)."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = ops
    w_ih, b_ih, w_hh, b_hh = (v.contiguous() for v in w)
    _launch(gru_library(), "vcx_gru_bwd_chain", x.device,
            (x, *xs, w_ih, w_hh, b_ih, b_hh, h0, *hs, outs, douts, gh, dh0,
             p, b, t, d, hidden, bt))


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
    """B2's first phase, ``gru_chain_kernel``: (gh (P, B, T, 4H), dh0
    (P, B, H)).  A CPU tensor runs ``bwd_chain_plain``."""
    if x.device.type == "cpu":
        return bwd_chain_plain(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts)
    ops, outs, douts = _bwd_operands(w_ih, b_ih, w_hh, b_hh, x, h0, outs,
                                     douts, "douts")
    gh, dh0 = _chain_buffers(ops)
    _chain_kernel(ops, (w_ih, b_ih, w_hh, b_hh), outs, douts, gh, dh0,
                  _bwd_plan(ops[0], x.device)[0])
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
    _, splits, chunk = _bwd_plan(ops[0], x.device)
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
    bt, splits, chunk = _bwd_plan(ops[0], x.device)
    gh, dh0 = _chain_buffers(ops)
    dx, part = _wgrad_buffers(ops, need_dx, splits)
    _launch(gru_library(), "vcx_gru_backward", x.device,
            (xc, *xs, w_ih.contiguous(), w_hh.contiguous(), b_ih.contiguous(),
             b_hh.contiguous(), h0c, *hs, outs, douts, gh, dh0, dx, part, p,
             b, t, d, hidden, bt, splits, chunk))
    LAUNCHES["gru_backward"] += 1
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
