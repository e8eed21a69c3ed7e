"""K1/K2's bf16 instantiations against their plain bf16 versions and the
float32 kernels, on one GPU.

    python3 tools/torch_bf16_rollouts.py [--reps N]

Builds ``csrc/rollout.cu`` (ptxas's register and shared-memory lines of the
rollout kernels are printed), then at ``bench.py``'s serving width (p=20,
H=64 + ErrorVAE) and ``lorenz96_scaled``'s (p=40, H=128), each at B=3072
and B=1, with random weights from a seed: the plan each type takes, the
largest per-element difference of each bf16 kernel from its plain bf16
version and of the bf16 compensated generation from the float32 one on
the same draws (with JAX's distributional bounds of
``tests/test_serve_dtype.py``), and each kernel's time by CUDA events
beside the float32 kernel's.  Prints one JSON line a shape.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = ((20, 64, 3072), (20, 64, 1), (40, 128, 3072), (40, 128, 1))


def time_ms(fn, reps: int) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import _build
    from vae_connexe_torch.ops import cuda_rollout as cr

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    _, log = _build.build("rollout")
    for line in log.splitlines():
        if re.search(r"(Compiling entry|registers|spill)", line) and \
                "rollout" not in line:
            print(line.strip())
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dev = torch.device("cuda")
    bf = torch.bfloat16
    for p, hidden, b in SHAPES:
        g = torch.Generator().manual_seed(p * 1000 + hidden)
        model, err = CRVAE(p, hidden), ErrorVAE(p, hidden)
        params, ep = model.init(g, dev), err.init(g, dev)
        heads, ro, dec, out = params.heads, params.readout, ep.dec, ep.out
        g16 = [cr.cast_weights(w, bf) for w in (heads, ro, dec, out)]
        gd = torch.Generator(device=dev).manual_seed(7)
        h0e = torch.randn((b, hidden), generator=gd, device=dev)
        h0 = torch.randn((b, hidden), generator=gd, device=dev)
        t = model.rollout_len
        row = {"p": p, "hidden": hidden, "batch": b}
        for kind, n in (("crvae", p), ("errvae", 1)):
            for elem in (4, 2):
                plan, _ = cr._plan(kind, n, b, p, hidden, dev, elem)
                row[f"plan_{kind}_{'bf16' if elem == 2 else 'f32'}"] = (
                    f"{plan.route} cluster={plan.cluster} bt={plan.bt} "
                    f"split={plan.split} smem={plan.smem}")
        errs16 = cr.errvae_sample_fused(g16[2], g16[3], h0e, p, t)
        errs16_plain = cr.errvae_sample_plain(g16[2], g16[3], h0e, p, t)
        noise = torch.cat([torch.zeros((b, 1, p), device=dev), errs16],
                          dim=1)[:, :t]
        x0 = torch.zeros((b, p), device=dev)
        k1 = cr.crvae_free_run_fused(g16[0], g16[1], x0, h0, noise, 0.1)
        k1_plain = cr.crvae_free_run_plain(g16[0], g16[1], x0, h0, noise, 0.1)
        errs = cr.errvae_sample_fused(dec, out, h0e, p, t)
        noise32 = torch.cat([torch.zeros((b, 1, p), device=dev), errs],
                            dim=1)[:, :t]
        f32 = cr.crvae_free_run_fused(heads, ro, x0, h0, noise32, 0.1)
        torch.cuda.synchronize()
        a, c = k1.cpu().numpy(), f32.cpu().numpy()
        row.update(
            k2_bf16_vs_plain=float((errs16 - errs16_plain).abs().max()),
            k1_bf16_vs_plain=float((k1 - k1_plain).abs().max()),
            k1_bf16_vs_plain_p99=float(torch.quantile(
                (k1 - k1_plain).abs().flatten()[:1 << 20], 0.99)),
            bf16_vs_f32=float(np.abs(a - c).max()),
            bf16_vs_f32_limit=0.15 * (float(np.abs(c).max()) + 1.0),
            mean_gap=float(np.abs(a.mean((0, 1)) - c.mean((0, 1))).max()),
            std_gap=float(np.abs(a.std((0, 1)) - c.std((0, 1))).max()),
            finite=bool(np.isfinite(a).all()))
        for name, fn in (
                ("k1_bf16", lambda: cr.crvae_free_run_fused(
                    g16[0], g16[1], x0, h0, noise, 0.1)),
                ("k1_f32", lambda: cr.crvae_free_run_fused(
                    heads, ro, x0, h0, noise32, 0.1)),
                ("k2_bf16", lambda: cr.errvae_sample_fused(
                    g16[2], g16[3], h0e, p, t)),
                ("k2_f32", lambda: cr.errvae_sample_fused(
                    dec, out, h0e, p, t))):
            row[f"{name}_ms"] = time_ms(fn, args.reps)
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
