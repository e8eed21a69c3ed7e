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

    python3 tools/torch_gru_fwd_tiles.py --wide [ROOT ...]

B1's wide route at ``WIDE_SHAPES``: lorenz96_scaled's decoder heads (P=40,
B=512, T=30, D=40), lorenz96_xl's (P=128, B=64, T=30, D=128), the one-head
encoder (P=1, B=512, T=10, D=40), a ragged batch (P=3, B=37, T=5, D=40)
at H=128, and hidden 130 with a per-head input (P=6, B=100, T=12, D=40),
shared input (bar the last) and a broadcast h0, the same seeded inputs for
every ROOT.  For each ROOT in the order given (default: this checkout), a
fresh process imports ``vae_connexe_torch`` from ROOT, holds its
``fused_gru_scan_heads`` against the plain forward (1e-5 absolute) and
checks two calls bitwise equal, then times the wrapper by CUDA events and
its device time by kernel (``torch.profiler``).  A checkout with the
clustered forward (``cuda_gru.wide_fwd_plan``) also prints its plan and,
at every shape, every tile that fits (``WIDE_TILES``,
``wide_fwd_blocks_per_sm``), each held against the plain forward, beside
``wide_fwd_step_cost``'s figure: the sweep behind the cost model.  A
shape a checkout does not route is reported so and skipped.  Last, the
checkout's own ``chip_smoke.scaled_main_path`` (the 30-step
``lorenz96_scaled`` fit, 2 wide forwards a step) prints its steps/s,
twice: the first fit of a process is a warm-up.
List an older checkout (a ``git archive`` unpacked under ``build/``) twice around
this one (parent, change, change, parent) to compare the two on one card.
Each process prints one ``WIDEFWD {json}`` line per shape.
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
# (name, P, B, T, D, H, per-head input)
WIDE_SHAPES = (("scaled_heads", 40, 512, 30, 40, 128, False),
               ("xl_heads", 128, 64, 30, 128, 128, False),
               ("one_head", 1, 512, 10, 40, 128, False),
               ("ragged", 3, 37, 5, 40, 128, False),
               ("h130", 6, 100, 12, 40, 130, True))


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


def wide_one(root: str) -> None:
    """B1's wide route of the checkout at ``root`` (run in a process of its
    own: the package is imported from there)."""
    import json

    sys.path.insert(0, os.path.abspath(root))
    for name in [m for m in sys.modules
                 if m.startswith(("vae_connexe_torch", "chip_smoke"))]:
        del sys.modules[name]
    from vae_connexe_torch.ops import cuda_gru as cg
    from vae_connexe_torch.ops.gru import init_stacked_gru as init

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    limits = cg.device_limits(dev)
    planned = hasattr(cg, "wide_fwd_plan")
    for what, heads, b, t, d, hid, per_head in WIDE_SHAPES:
        g = torch.Generator().manual_seed(heads * 1000 + b + hid)
        prm = init(g, heads, d, hid, device="cpu")
        prm = type(prm)(prm.w_ih.to(dev), prm.w_hh.to(dev), prm.b_ih.to(dev),
                        prm.b_hh.to(dev))
        w = (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh)
        x = torch.randn((heads, b, t, d) if per_head else (b, t, d),
                        generator=g).to(dev)
        h0 = torch.randn((1, b, hid), generator=g).to(dev).expand(
            heads, b, hid)
        row = {"shape": what, "P": heads, "B": b, "T": t, "D": d, "H": hid,
               "root": root}
        try:
            route = cg.recurrence_route(heads, b, d, hid, limits)
        except ValueError as e:
            row["route"] = f"none: {e}"
            print("WIDEFWD " + json.dumps(row), flush=True)
            continue
        row["route"] = route
        ref, _ = cg.fused_gru_scan_heads_plain(prm, x, h0)
        got, _ = cg.fused_gru_scan_heads(prm, x, h0)
        again, _ = cg.fused_gru_scan_heads(prm, x, h0)
        torch.cuda.synchronize()
        row["err"] = (got - ref).abs().max().item()
        row["bitwise"] = bool(torch.equal(got, again))
        assert row["err"] <= OUT_TOL and row["bitwise"], row
        row["ms"] = time_ms(lambda: cg.fused_gru_scan_heads(prm, x, h0), 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cg.fused_gru_scan_heads(prm, x, h0)
            torch.cuda.synchronize()
        row["device_ms"] = {
            e.key[:48]: device_us(e) / 5 / 1e3 for e in prof.key_averages()
            if is_kernel(e)}
        if planned and route == "wide":
            row["plan"] = cg.wide_fwd_plan(b, heads, hid, limits)
            ops = cg._operands(*w, x, h0)
            outs = torch.empty((heads, b, t, hid), device=dev)
            sweep = {}
            for bt in cg.WIDE_TILES:
                per_sm = cg.wide_fwd_blocks_per_sm(bt, hid, limits)
                if per_sm < 1 or (bt > min(cg.WIDE_TILES) and bt >= 2 * b):
                    continue
                ms = time_ms(lambda: cg._forward_kernel(ops, w, outs, bt,
                                                        True), 10)
                err = (outs - ref).abs().max().item()
                assert err <= OUT_TOL, (what, bt, err)
                blocks = heads * -(-b // bt) * cg.WIDE_CLUSTER
                sweep[f"bt{bt}"] = {
                    "ms": ms, "err": err, "per_sm": per_sm,
                    "model": cg.wide_fwd_step_cost(bt, hid, blocks, per_sm,
                                                   limits[2])}
            row["sweep"] = sweep
        print("WIDEFWD " + json.dumps(row), flush=True)
    import chip_smoke

    # The first fit of a process pays the library handles' and the caching
    # allocator's set-up; the second is the reading.
    for _ in range(2):
        chip_smoke.scaled_main_path(dev, chip_smoke.smi_line())


def wide(roots) -> None:
    """``--wide``: one process per root, in order."""
    from vae_connexe_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for line in _build.build("gru")[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas", line.strip(), flush=True)
    for root in roots or ["."]:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--wide-one", root])
        if r.returncode != 0:
            sys.exit(f"--wide at {root} failed ({r.returncode})")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--wide"]:
        wide(sys.argv[2:])
    elif sys.argv[1:2] == ["--wide-one"]:
        wide_one(sys.argv[2])
    else:
        main()
