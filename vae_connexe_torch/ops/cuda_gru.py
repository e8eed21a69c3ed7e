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
h0 such as (P, 1, H) or one z shared by every head.  B2 writes one dW/db
partial per (head, batch tile) and the partials are summed here in a fixed
order, so a step is deterministic.  The kernels run in float32 and sum in
another order than ``einsum``; ``chip_smoke.py`` states the tolerances.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from vae_connexe_torch.ops.gru import GRUParams, gru_scan_heads

# Kernel launches per wrapper, counted where the kernel is launched.
LAUNCHES = {"gru_forward": 0, "gru_backward": 0}

# Batch tiles the kernels are instantiated for (csrc/gru.cu, launch()).
TILES = (32, 16, 8, 4, 2, 1)
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


def bwd_smem_bytes(bt: int, d: int, hidden: int) -> int:
    """Shared memory of a backward block: the forward's plus the dW/db
    accumulators and the step's gate gradients (``bwd_smem_floats``)."""
    extra = (3 * hidden * hidden + 3 * hidden * d + 6 * hidden
             + 4 * bt * hidden)
    return fwd_smem_bytes(bt, d, hidden) + 4 * extra


def pick_tile(batch: int, heads: int, hidden: int, smem_fn, limits) -> int:
    """Batch tile of a (head, tile) grid.

    ``smem_fn(bt)`` gives a block's shared memory; ``limits`` is (opt-in
    shared memory of a block, shared memory of an SM, SM count, threads of
    an SM).  For each tile that fits, the estimated time is the number of
    waves of blocks times the rows each thread computes per step (a thread's
    work per step does not shrink below one row, so tiles of 1 to 4 rows
    cost the same per block); the cheapest wins, the widest on a tie (fewer
    blocks stage the weights).  A tile of twice the batch or more only
    idles threads and is not taken.  Raises when no tile fits.
    """
    optin, smem_sm, n_sm, threads_sm = limits
    best = None
    for bt in TILES:
        need, threads = smem_fn(bt), block_threads(bt, hidden)
        if need > optin or threads > MAX_THREADS or (bt > 1 and bt >= 2 * batch):
            continue
        per_sm = min(smem_sm // (need + BLOCK_RESERVED), threads_sm // threads)
        if per_sm < 1:
            continue
        blocks = heads * math.ceil(batch / bt)
        cost = math.ceil(blocks / (n_sm * per_sm)) * rows_per_thread(bt)
        if best is None or cost < best[0]:
            best = (cost, bt)
    if best is None:
        raise ValueError(
            f"GRU kernel: one row of hidden {hidden} needs {smem_fn(1)} bytes "
            f"of shared memory and {block_threads(1, hidden)} threads, over "
            f"the device's {optin} bytes / {MAX_THREADS} threads")
    return best[1]


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


def _backward_launch(w_ih, b_ih, w_hh, b_hh, x, h0, outs, douts,
                     need_dx: bool):
    """B2: (dx or None, dW_ih, db_ih, dW_hh, db_hh, dh0 (P, B, H))."""
    from vae_connexe_torch.ops._build import gru_library

    (p, b, t, d, hidden), x, xs, h0, hs = _operands(w_ih, b_ih, w_hh, b_hh,
                                                    x, h0)
    dev = x.device
    bt = pick_tile(b, p, hidden, lambda n: bwd_smem_bytes(n, d, hidden),
                   device_limits(dev))
    nbt, g = math.ceil(b / bt), 3 * hidden
    f32 = dict(device=dev, dtype=torch.float32)
    dx = torch.empty((p, b, t, d), **f32) if need_dx else None
    dwih = torch.empty((p, nbt, g, d), **f32)
    dwhh = torch.empty((p, nbt, g, hidden), **f32)
    dbih = torch.empty((p, nbt, g), **f32)
    dbhh = torch.empty((p, nbt, g), **f32)
    dh0 = torch.empty((p, b, hidden), **f32)
    _launch(gru_library(), "vcx_gru_backward", dev,
            (x, *xs, w_ih.contiguous(), w_hh.contiguous(), b_ih.contiguous(),
             b_hh.contiguous(), h0, *hs, outs, douts.contiguous(), dx, dwih,
             dwhh, dbih, dbhh, dh0, p, b, t, d, hidden, bt))
    LAUNCHES["gru_backward"] += 1
    if dx is not None and x.ndim == 3:
        dx = dx.sum(dim=0)                   # the shared input: sum heads
    return (dx, dwih.sum(dim=1), dbih.sum(dim=1), dwhh.sum(dim=1),
            dbhh.sum(dim=1), dh0)


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
