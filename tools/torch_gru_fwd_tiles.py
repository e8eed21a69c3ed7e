"""Check B1 on one GPU at each batch tile and time it there.

    python3 tools/torch_gru_fwd_tiles.py

At the phase-1 shapes (encoder P=1 and decoder heads P=20; B=256, T=10,
D=20, H=64, shared input, h0 broadcast from one state), for each tile of
``cuda_gru.FWD_TILES`` that fits, it launches ``gru_forward_kernel``
(csrc/gru_fwd.cuh) alone into a buffer allocated once, holds its outputs
against the plain version (1e-5 absolute) and times it by CUDA events over
back-to-back launches and by ``torch.profiler`` (device time alone), beside
the cost ``cuda_gru.fwd_step_cost`` gives it and the tile that
``cuda_gru.fwd_tile`` takes: the sweep behind the cost model.  Then the
whole wrapper (``fused_gru_scan_heads``) by events, its host enqueue time
a call, and its device time.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tools.torch_gru_bwd_tiles import time_ms  # noqa: E402
from tools.torch_step_profile import device_us, is_kernel  # noqa: E402
from vae_connexe_torch.ops import cuda_gru  # noqa: E402
from vae_connexe_torch.ops.gru import init_stacked_gru  # noqa: E402

B, T, D, H = 256, 10, 20, 64
OUT_TOL = 1e-5


def device_ms(fn, iters: int = 20) -> float:
    """Device time of ``fn`` a call, from the profiler's device rows."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(device_us(e) for e in prof.key_averages()
               if is_kernel(e)) / iters / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    limits = cuda_gru.device_limits(dev)
    optin, smem_sm, n_sm, threads_sm = limits
    g = torch.Generator().manual_seed(0)
    for heads in (1, 20):
        prm = init_stacked_gru(g, heads, D, H, device=dev)
        w = (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh)
        x = torch.randn((B, T, D), generator=g).to(dev)
        h0 = torch.randn((1, B, H), generator=g).to(dev).expand(heads, B, H)
        ref, _ = cuda_gru.fused_gru_scan_heads_plain(prm, x, h0)
        ops = cuda_gru._operands(*w, x, h0)
        outs = torch.empty((heads, B, T, H), device=dev)
        picked = cuda_gru.fwd_tile(B, heads, D, H, limits)
        row = []
        for bt in cuda_gru.FWD_TILES:
            need = cuda_gru.fwd_tile_smem_bytes(bt, D, H)
            threads = cuda_gru.fwd_tile_threads(bt, H)
            if need > optin or threads > cuda_gru.MAX_THREADS:
                continue
            per_sm = min(smem_sm // (need + cuda_gru.BLOCK_RESERVED),
                         threads_sm // threads)
            blocks = heads * math.ceil(B / bt)
            cost = cuda_gru.fwd_step_cost(bt, D, H, blocks, per_sm, n_sm)

            def launch():
                cuda_gru._forward_kernel(ops, w, outs, bt, False)

            ms = time_ms(launch)
            dms = device_ms(launch)
            err = (outs - ref).abs().max().item()
            assert err <= OUT_TOL, (bt, err)          # every tile is right
            row.append(f"bt={bt} ({blocks} blocks, {per_sm}/SM, cost "
                       f"{cost:.0f}): {ms:.4f} ms, device {dms:.4f} ms, "
                       f"err {err:.2e}")
        print(f"B1 kernel P={heads} picked bt={picked}:\n  "
              + "\n  ".join(row), flush=True)

        def b1():
            cuda_gru.fused_gru_scan_heads(prm, x, h0)

        full = time_ms(b1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            b1()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        print(f"B1 wrapper P={heads}: {full:.4f} ms by events, host enqueue "
              f"{host:.4f} ms a call, device {device_ms(b1):.4f} ms a call",
              flush=True)


if __name__ == "__main__":
    main()
