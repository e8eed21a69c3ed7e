#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU: build, check, serve, time.

    python3 chip_smoke.py

1. Print the card's name and power limit (nvidia-smi).
2. Build the rollout kernels from ``vae_connexe_torch/csrc/`` with nvcc.
3. Hold each kernel against its plain PyTorch version on the card at the
   serving width (p=20, H=64, T=21; B = 1, 8, 37, 3072) and at p=4, H=8 with
   a random parents mask.  Tolerance: 1e-4 absolute (float32 recurrences of
   21 steps whose products are summed in another order than cuBLAS's).
4. The main path: a port-initialised CRVAE(p=20, H=64) + ErrorVAE(d=20,
   H=64), exported at batch 3072, loaded and served by ``GeneratorServer``,
   which answers explicit-seed, JSON and coalesced seedless requests.  The
   kernels' launch counts are set to 0 just before and read just after.
   The served samples are held against the plain versions on the same draws.
5. Time each kernel (CUDA events) and the whole compensated generation at
   B=1 and B=3072, beside the plain versions and the card's bound.
6. Print one JSON line of per-kernel results, the nvidia-smi line, and the
   last line ``{"ok": true, "device": {...}}``.

Exits non-zero, without the last line, when any phase fails or when no CUDA
device is present.  Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

TOL = 1e-4
P, H, T, SERVE_B = 20, 64, 21, 3072
CHECK_BATCHES = (1, 8, 37, SERVE_B)
# Published H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor
# cores, and HBM3 bandwidth.
F32_FLOPS, HBM_BYTES_S = 67e12, 3.35e12


def log(*a):
    print(*a, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
        check=True)
    return out.stdout.strip().splitlines()[0]


def rollout_cost(b, t, heads, hidden, d, outs, noise: bool, x0: bool):
    """(flops, bytes) the card must at least spend on one rollout launch:
    the multiply-adds of the input, hidden and readout products (the gate
    math, ~2% more, is not counted), and every input read once and the
    output written once."""
    g = 3 * hidden
    flops = 2 * b * t * heads * (g * d + g * hidden + outs * hidden)
    weights = heads * (g * d + g * hidden + 2 * g + outs * hidden + outs)
    elems = (weights + b * hidden + (b * d if x0 else 0)
             + (b * t * d if noise else 0) + b * t * d)
    return flops, 4 * elems


def bound(flops, nbytes):
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def make_models(p, hidden, seed, dev):
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE

    g = torch.Generator().manual_seed(seed)
    model, err = CRVAE(p=p, hidden=hidden), ErrorVAE(d=p, hidden=hidden)
    return model, err, model.init(g, dev), err.init(g, dev), g


def check_kernels(dev, errors):
    """Phase 3: each kernel against its plain version, on the card."""
    import torch

    from vae_connexe_torch.models import masked_heads
    from vae_connexe_torch.ops import cuda_rollout as cr

    cases = [(P, H, b, False) for b in CHECK_BATCHES] + \
        [(4, 8, b, True) for b in (1, 37)]
    for p, hidden, b, with_parents in cases:
        model, err, params, eparams, g = make_models(p, hidden, b, dev)
        heads = params.heads
        if with_parents:
            heads = masked_heads(heads, (torch.rand((p, p), generator=g)
                                         > 0.3).float())
        h0 = torch.randn((b, hidden), generator=g).to(dev)
        noise = torch.randn((b, T, p), generator=g).to(dev)
        x0 = torch.zeros((b, p), device=dev)
        k1 = cr.crvae_free_run_fused(heads, params.readout, x0, h0, noise, 0.1)
        r1 = cr.crvae_free_run_plain(heads, params.readout, x0, h0, noise, 0.1)
        k2 = cr.errvae_sample_fused(eparams.dec, eparams.out, h0, p, T)
        r2 = cr.errvae_sample_plain(eparams.dec, eparams.out, h0, p, T)
        torch.cuda.synchronize()
        for name, k, r in (("crvae_free_run", k1, r1),
                           ("errvae_sample", k2, r2)):
            e = (k - r).abs().max().item()
            ok = bool(torch.isfinite(k).all()) and e <= TOL
            errors[name] = max(errors.get(name, 0.0), e)
            log(f"check {name} p={p} H={hidden} B={b} T={T} "
                f"parents={with_parents}: max_abs_err={e:.3e} tol={TOL:g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{name} disagrees with its plain version")


def post(srv, body):
    req = urllib.request.Request(
        f"http://{srv.host}:{srv.port}/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        data = r.read()
    if body.get("format") == "json":
        return json.loads(data)
    import numpy as np

    return np.load(io.BytesIO(data))


def serve_main_path(dev):
    """Phase 4: export, load and serve at the serving width; returns the
    launch counts of this phase."""
    import numpy as np
    import torch

    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.ops.cuda_rollout import (
        crvae_free_run_plain,
        errvae_sample_plain,
    )
    from vae_connexe_torch.server import GeneratorServer
    from vae_connexe_torch.serving import export_generator, load_generator

    cr.reset_launches()
    model, err, params, eparams, _ = make_models(P, H, 0, dev)
    blob = export_generator(model, err, params, eparams, batch=SERVE_B)
    srv = GeneratorServer(blob, device=dev)
    srv.start()
    try:
        a, b = post(srv, {"seed": 7}), post(srv, {"seed": 7})
        c = post(srv, {"seed": 8})
        j = post(srv, {"seed": 9, "format": "json", "n_samples": 4})
        art = srv._artifacts[srv._default]
        outs = [None, None]

        def client(i):
            outs[i] = post(srv, {"seed": None, "n_samples": 16})

        threads = [threading.Thread(target=client, args=(i,)) for i in (0, 1)]
        srv._lock.acquire()           # hold dispatch so both requests queue
        try:
            for t in threads:
                t.start()
            deadline = time.time() + 60
            while len(art.coal_queue) < 2 and time.time() < deadline:
                time.sleep(0.01)
        finally:
            srv._lock.release()
        for t in threads:
            t.join(timeout=120)
        with urllib.request.urlopen(
                f"http://{srv.host}:{srv.port}/meta", timeout=60) as r:
            meta = json.loads(r.read())
    finally:
        srv.shutdown()
    launches = dict(cr.LAUNCHES)

    assert a.shape == (SERVE_B, T, P) and np.isfinite(a).all(), a.shape
    assert np.array_equal(a, b), "same seed gave different samples"
    assert c.shape == a.shape and not np.allclose(a, c), "seed ignored"
    assert j["shape"] == [4, T, P] and np.isfinite(j["samples"]).all()
    assert all(o is not None and o.shape == (16, T, P) for o in outs)
    assert meta["requests"] == 6 and meta["coalesced_requests"] == 2, meta
    assert meta["device_calls"] == 5 and meta["errors"] == 0, meta
    # 1 warm-up call + 5 dispatches, one launch of each kernel apiece.
    assert launches == {"crvae_free_run": 6, "errvae_sample": 6}, launches

    # The served samples against the plain versions on the seed's draws.
    gen = torch.Generator(device=dev).manual_seed(7)
    h0_err = torch.randn((SERVE_B, H), generator=gen, device=dev)
    h0 = torch.randn((SERVE_B, H), generator=gen, device=dev)
    errs = errvae_sample_plain(eparams.dec, eparams.out, h0_err, P, T)
    noise = torch.cat([torch.zeros((SERVE_B, 1, P), device=dev), errs],
                      dim=1)[:, :T]
    ref = crvae_free_run_plain(params.heads, params.readout,
                               torch.zeros((SERVE_B, P), device=dev), h0,
                               noise, model.noise_scale).cpu().numpy()
    e2e = float(np.abs(a - ref).max())
    log(f"main path: {meta['requests']} requests, {meta['device_calls']} "
        f"dispatches, {meta['coalesced_requests']} coalesced, launches "
        f"{launches}, served vs plain max_abs_err={e2e:.3e} tol={TOL:g}, "
        f"generate_ms {meta['generate_ms']}")
    assert e2e <= TOL, "served samples disagree with the plain path"
    fn, _ = load_generator(blob, dev)
    return launches, fn


def time_all(dev, card, served_fn):
    """Phase 5: device times of kernels, plain versions and the whole
    generation; returns the per-kernel timings at B=3072."""
    import torch

    from vae_connexe_torch.ops import cuda_rollout as cr
    from vae_connexe_torch.train import generate_from_draws

    model, err, params, eparams, g = make_models(P, H, 1, dev)
    res = {}
    for b in (1, SERVE_B):
        iters = 200 if b == 1 else 20
        h0 = torch.randn((b, H), generator=g).to(dev)
        h0_err = torch.randn((b, H), generator=g).to(dev)
        noise = torch.randn((b, T, P), generator=g).to(dev)
        x0 = torch.zeros((b, P), device=dev)
        k1 = (params.heads, params.readout, x0, h0, noise, 0.1)
        k2 = (eparams.dec, eparams.out, h0, P, T)
        row = {
            "crvae_free_run": (time_ms(lambda: cr.crvae_free_run_fused(*k1), iters),
                               time_ms(lambda: cr.crvae_free_run_plain(*k1), iters)),
            "errvae_sample": (time_ms(lambda: cr.errvae_sample_fused(*k2), iters),
                              time_ms(lambda: cr.errvae_sample_plain(*k2), iters)),
        }
        gen_ms = time_ms(lambda: generate_from_draws(
            model, err, params.heads, params.readout, eparams.dec,
            eparams.out, h0_err, h0), iters)
        for name, (ms, plain) in row.items():
            log(f"time {name} B={b}: kernel {ms:.4f} ms, plain {plain:.4f} ms "
                f"[{card}]")
        log(f"time compensated generation B={b}: {gen_ms:.4f} ms, "
            f"{b / gen_ms * 1e3:.1f} samples/s [{card}]")
        res[b] = row
    t0 = time.perf_counter()
    n = 5
    for s in range(n):
        served_fn(s)
    served_ms = (time.perf_counter() - t0) / n * 1e3
    log(f"time served fn(seed) B={SERVE_B} incl. copy to host: "
        f"{served_ms:.3f} ms, {SERVE_B / served_ms * 1e3:.1f} samples/s "
        f"[{card}]")
    return res[SERVE_B]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vae_connexe_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(f"card: {card}")

    t0 = time.perf_counter()
    lib_path, report = _build.build("rollout")
    _build.rollout_library()
    log(f"build: {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    errors = {}
    check_kernels(dev, errors)
    launches, served_fn = serve_main_path(dev)
    times = time_all(dev, card, served_fn)

    source = "vae_connexe_torch/csrc/rollout.cu"
    costs = {
        "crvae_free_run": (rollout_cost(SERVE_B, T, P, H, P, 1, True, True),
                           "vae_connexe_tpu/ops/pallas_rollout.py:117"),
        "errvae_sample": (rollout_cost(SERVE_B, T, 1, H, P, P, False, False),
                          "vae_connexe_tpu/ops/pallas_rollout.py:204"),
    }
    kernels = []
    for name, ((flops, nbytes), replaces) in costs.items():
        bound_ms, bound_by = bound(flops, nbytes)
        ms, plain_ms = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errors[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        })
    log(json.dumps({"kernels": kernels}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
