"""Sweep the rollout kernels' designs on one GPU.

    python3 tools/torch_rollout_tiles.py [--streamed]

``vae_connexe_torch/ops/cuda_rollout.rollout_route`` rests on this sweep.
Resident route: K1 (the CRVAE free run, T=21, H=64) at the serving width
p=20 and at lorenz96_crvae's p=10: for each cluster size C of 4..8, 10 and
16 (heads per block ceil(p / C), spread as the kernel spreads them) and
each batch tile of ``cuda_gru.FWD_TILES`` that fits a block, and each k
split (``cuda_rollout.SPLITS``) whose gate tiles fit it, it prints the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``) and,
at B = 1, 37 and 3072, the device time of one launch (CUDA events) and the
largest error against the plain version.  K2 (the ErrorVAE free run, d=20,
H=64) at each tile and split.
Streamed route (hidden 128; ``--streamed`` runs this part alone): K1 at
lorenz96_scaled's p=40 and lorenz96_xl's p=128, in float32 and bf16, and
K2 at d=40 in float32, at B = 1, 37, 512 and 3072: each batch tile M of
``cuda_rollout.STREAM_TILES`` whose block fits, with its blocks a step,
the device time of one call (T launches; the weights packed before it) and
the largest error against the plain version.  ``cuda_rollout.stream_tile``'s
rule is read off it.
The plan ``rollout_route`` picks is marked ``*``.
The library is called directly, so the plan itself is bypassed.  Needs a
CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vae_connexe_torch.models import CRVAE, ErrorVAE  # noqa: E402
from vae_connexe_torch.ops import cuda_rollout as cr  # noqa: E402
from vae_connexe_torch.ops._build import rollout_library  # noqa: E402
from vae_connexe_torch.ops.cuda_gru import FWD_TILES  # noqa: E402

H, T = 64, 21
BATCHES = (1, 37, 3072)
CLUSTERS = (4, 5, 6, 7, 8, 10, 16)


def time_ms(fn, iters: int = 20) -> float:
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


def designs(heads: int, hidden: int):
    """(tile, split) pairs whose gate tiles fit a resident block."""
    return [(bt, s) for bt in FWD_TILES for s in cr.SPLITS
            if cr.gate_threads(heads, bt, hidden, s) <= cr.RESIDENT_THREADS]


def sweep_k1(dev, g, p, limits) -> None:
    params = CRVAE(p, H).init(g, dev)
    hd, ro = params.heads, params.readout
    inputs = {}
    for b in BATCHES:
        h0 = torch.randn((b, H), generator=g).to(dev)
        noise = torch.randn((b, T, p), generator=g).to(dev)
        x0 = torch.zeros((b, p), device=dev)
        inputs[b] = (x0, h0, noise,
                     cr.crvae_free_run_plain(hd, ro, x0, h0, noise, 0.1))
    plans = {b: cr.rollout_route("crvae", p, b, p, H, limits) for b in BATCHES}
    for c in CLUSTERS:
        hpb = -(-p // c)
        if c > p:
            continue
        for bt, split in designs(hpb, H):
            smem = cr.resident_smem_bytes(hpb, bt, p, H, 1, True)
            if smem > limits[0]:
                continue
            active = ctypes.c_int(0)
            rc = rollout_library().vcx_crvae_max_clusters(
                p, H, c, bt, split, 0, ctypes.byref(active))
            row = [f"K1 p={p} C={c} heads/block={hpb} bt={bt} split={split} "
                   f"smem={smem} max_active_clusters={active.value} (rc {rc})"]
            if rc != 0 or active.value < 1:
                print(row[0] + ": not launchable", flush=True)
                continue
            for b in BATCHES:
                x0, h0, noise, ref = inputs[b]
                out = torch.empty((b, T, p), device=dev)
                n = min(active.value, -(-b // bt))
                args = (x0, h0, noise, hd.w_ih, hd.w_hh, hd.b_ih, hd.b_hh,
                        ro.w, ro.b, out)
                ints = (b, T, p, H, ctypes.c_float(0.1), c, bt, split, n)

                def run():
                    cr._launch("vcx_crvae_free_run_resident", dev, args, ints)

                try:
                    ms = time_ms(run)
                except RuntimeError as e:   # a design the card refuses
                    row.append(f"B={b}: {e}")
                    continue
                err = (out - ref).abs().max().item()
                pick = plans[b]
                mark = "*" if (pick.route, pick.cluster, pick.bt,
                               pick.split) == ("resident", c, bt, split) else ""
                row.append(f"B={b}{mark}: {ms:.4f} ms err {err:.2e}")
            print(" | ".join(row), flush=True)


def sweep_k2(dev, g, d, limits) -> None:
    err_p = ErrorVAE(d, H).init(g, dev)
    for b in BATCHES:
        h0 = torch.randn((b, H), generator=g).to(dev)
        ref = cr.errvae_sample_plain(err_p.dec, err_p.out, h0, d, T)
        pick = cr.rollout_route("errvae", 1, b, d, H, limits)
        row = [f"K2 d={d} B={b}"]
        for bt, split in designs(1, H):
            if cr.resident_smem_bytes(1, bt, d, H, d, False) > limits[0]:
                continue
            out = torch.empty((b, T, d), device=dev)
            args = (h0, err_p.dec.w_ih, err_p.dec.w_hh, err_p.dec.b_ih,
                    err_p.dec.b_hh, err_p.out.w, err_p.out.b, out)
            ms = time_ms(lambda: cr._launch("vcx_errvae_sample_resident", dev,
                                            args, (b, T, d, H, bt, split)))
            err = (out - ref).abs().max().item()
            mark = "*" if (pick.bt, pick.split) == (bt, split) else ""
            row.append(f"bt={bt} split={split}{mark}: {ms:.4f} ms "
                       f"err {err:.2e}")
        print(" | ".join(row), flush=True)


STREAM_BATCHES = (1, 37, 512, 3072)


def sweep_streamed(dev, g, kind, p, dtype, limits) -> None:
    """Every streamed tile of one kernel at hidden 128 (``kind`` "crvae":
    K1 with p heads; "errvae": K2 at d = p), weights of ``dtype``."""
    hidden = 128
    elem = 2 if dtype == torch.bfloat16 else 4
    half = "_bf16" if elem == 2 else ""
    if kind == "crvae":
        params = CRVAE(p, hidden).init(g, dev)
        w, ro = params.heads, params.readout
        heads = p
    else:
        params = ErrorVAE(p, hidden).init(g, dev)
        w, ro = params.dec, params.out
        heads = 1
    if elem == 2:
        w, ro = cr.cast_weights(w, dtype), cr.cast_weights(ro, dtype)
    rnd = cr._carries(dtype)
    for b in STREAM_BATCHES:
        h0 = rnd(torch.randn((b, hidden), generator=g).to(dev))
        if kind == "crvae":
            noise = rnd(torch.randn((b, T, p), generator=g).to(dev))
            x0 = torch.zeros((b, p), device=dev)
            ref = cr.crvae_free_run_plain(w, ro, x0, h0, noise, 0.1)
            packed = cr.pack_streamed(w.w_ih, w.w_hh)
            head = (x0, h0, noise, packed)
        else:
            ref = cr.errvae_sample_plain(w, ro, h0, p, T)
            packed = cr.pack_streamed(w.w_ih[None], w.w_hh[None])
            head = (h0, packed)
        pick = cr.rollout_route(kind, heads, b, p, hidden, limits, elem)
        row = [f"streamed {kind}{half} p={p} B={b}"]
        for m in cr.STREAM_TILES:
            outs = 1 if kind == "crvae" else p
            smem = cr.stream_smem_bytes(m, p, hidden, outs)
            if smem > limits[0]:
                continue
            plan = cr.RolloutPlan("streamed", 1, 1, m, 0,
                                  cr.stream_threads(m, hidden), smem)
            out = torch.empty((b, T, p), device=dev)
            args = (*head, w.b_ih, w.b_hh, ro.w, ro.b, out,
                    *cr._stream_scratch(plan, heads, b, p, hidden, dev))
            if kind == "crvae":
                fn, ints = (f"vcx_crvae_free_run_streamed{half}",
                            (b, T, p, hidden, ctypes.c_float(0.1), m))
            else:
                fn, ints = (f"vcx_errvae_sample_streamed{half}",
                            (b, T, p, hidden, m))
            ms = time_ms(lambda: cr._launch(fn, dev, args, ints),
                         iters=5 if b * p >= 100_000 else 20)
            err = (out - ref).abs().max().item()
            mark = "*" if (pick.route, pick.bt) == ("streamed", m) else ""
            row.append(f"M={m}{mark} blocks={heads * -(-b // m)}: "
                       f"{ms:.4f} ms err {err:.2e}")
        print(" | ".join(row), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    limits = cr.device_limits(dev)
    print(f"limits {limits}", flush=True)
    g = torch.Generator().manual_seed(0)
    if sys.argv[1:] != ["--streamed"]:
        for p in (20, 10):
            sweep_k1(dev, g, p, limits)
        sweep_k2(dev, g, 20, limits)
    for kind, p, dtype in (("crvae", 40, torch.float32),
                           ("crvae", 40, torch.bfloat16),
                           ("crvae", 128, torch.float32),
                           ("crvae", 128, torch.bfloat16),
                           ("errvae", 40, torch.float32)):
        sweep_streamed(dev, g, kind, p, dtype, limits)


if __name__ == "__main__":
    main()
