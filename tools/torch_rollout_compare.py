"""Time the rollout kernels at hidden 128 from a given checkout of the port.

    python3 tools/torch_rollout_compare.py [ROOT ...]

For each ROOT (default: this checkout), in the order given, a fresh
process imports ``vae_connexe_torch`` from ROOT and times, by CUDA events,
K1 (``crvae_free_run_fused``) in float32 and bf16 at lorenz96_scaled's p=40
and lorenz96_xl's p=128, and K2 (``errvae_sample_fused``) in float32 at
d=40, all at H=128, T=21 and B = 1 and 3072, with the launches by route
and the largest error against the plain version on the same inputs; at
B=1 also the device time a call spends in the rollout kernels and their
count (``torch.profiler``), the host time a call takes to return, and, on
the streamed route where the checkout has them, the time of packing the
weights alone (``cuda_rollout.pack_streamed``) and of a call that packs
them again (its cache of packed weights, ``_PACKED``, emptied before each
call).  Only
the wrappers' public signatures are used, so an older checkout (a ``git
archive`` of an earlier commit) is timed the same way: list it twice
around this one (parent, change, change, parent) to compare the two on
one card.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

H, T = 128, 21
CASES = (("crvae", 40, "float32"), ("crvae", 40, "bfloat16"),
         ("errvae", 40, "float32"), ("crvae", 128, "float32"),
         ("crvae", 128, "bfloat16"))
BATCHES = (1, 3072)


def time_ms(fn) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    once = start.elapsed_time(end)
    iters = 3 if once > 100 else (10 if once > 5 else 50)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_split(fn, calls: int = 5) -> tuple[float, int]:
    """(device ms a call in kernels, kernels a call) of ``fn`` under
    ``torch.profiler``: beside the event time, the share of a call the
    card spends outside its kernels (launch gaps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = float(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0)))
        if t > 0 and ("free_run" in e.key or "sample" in e.key):
            us += t
            n += e.count
    return us / calls / 1e3, n // calls


def enqueue_ms(fn, calls: int = 20) -> float:
    """Host time a call of ``fn`` takes to return (its launches queued, not
    run): where it reaches the event time, the host sets the pace."""
    import time

    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e3


def run_here() -> None:
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_rollout as cr

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    for kind, p, dtype in CASES:
        dt = getattr(torch, dtype)
        if kind == "crvae":
            params = CRVAE(p, H).init(g, dev)
            w, ro = params.heads, params.readout
        else:
            params = ErrorVAE(p, H).init(g, dev)
            w, ro = params.dec, params.out
        if dt != torch.float32:
            w, ro = cr.cast_weights(w, dt), cr.cast_weights(ro, dt)
        for b in BATCHES:
            h0 = torch.randn((b, H), generator=g).to(dev)
            if kind == "crvae":
                noise = torch.randn((b, T, p), generator=g).to(dev)
                x0 = torch.zeros((b, p), device=dev)
                args = (w, ro, x0, h0, noise, 0.1)
                fused, plain = cr.crvae_free_run_fused, cr.crvae_free_run_plain
            else:
                args = (w, ro, h0, p, T)
                fused, plain = cr.errvae_sample_fused, cr.errvae_sample_plain
            cr.reset_launches()
            got = fused(*args)
            routes = {k: v for k, v in cr.ROUTE_LAUNCHES.items() if v}
            err = (got - plain(*args)).abs().max().item()
            ms = time_ms(lambda: fused(*args))
            row = {"kind": kind, "p": p, "dtype": dtype, "B": b, "ms": ms,
                   "routes": routes, "max_abs_err": err}
            if b == 1:
                row["kernel_ms"], row["kernels"] = device_split(
                    lambda: fused(*args))
                row["enqueue_ms"] = enqueue_ms(lambda: fused(*args))
                pack = getattr(cr, "pack_streamed", None)
                cache = getattr(cr, "_PACKED", None)
                if pack is not None and any(k.endswith("_streamed")
                                            for k in routes):
                    row["pack_ms"] = time_ms(lambda: pack(w.w_ih, w.w_hh))
                if cache is not None and any(k.endswith("_streamed")
                                             for k in routes):
                    row["cold_ms"] = time_ms(
                        lambda: (cache.clear(), fused(*args)))
            print(json.dumps(row), flush=True)


def main() -> None:
    if sys.argv[1:2] == ["--here"]:
        run_here()
        return
    roots = sys.argv[1:] or [os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))]
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    for root in roots:
        root = os.path.abspath(root)
        print(f"root {root}", flush=True)
        subprocess.run([sys.executable, os.path.abspath(__file__), "--here"],
                       cwd=root, check=True,
                       env={**os.environ, "PYTHONPATH": root})


if __name__ == "__main__":
    main()
