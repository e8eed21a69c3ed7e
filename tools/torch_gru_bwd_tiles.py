"""Check B2's two phases on one GPU, time its chain at each batch tile.

    python3 tools/torch_gru_bwd_tiles.py

At the phase-1 shapes (encoder P=1 and decoder heads P=20; B=256, T=10,
D=20, H=64, shared input, h0 broadcast from one state), it prints ptxas's
register report of the gru library, holds ``cuda_gru.bwd_chain`` (gh,
dh0) and ``cuda_gru.bwd_wgrad`` (dW, db, dx) against their plain versions
(rtol 1e-3, atol 1e-4), then prints the time of the chain kernel alone at
each of ``cuda_gru.CHAIN_TILES`` (each held against the plain phase)
beside the tile that
``cuda_gru._bwd_plan`` takes (the sweep behind
``cuda_gru.chain_step_loads``), the weight-gradient kernel's time at
several chunks of B*T rows beside the one ``cuda_gru.wgrad_splits``
takes, and one whole B2 call: by CUDA events, its host enqueue time, and
its device time by kernel from ``torch.profiler``.  Launches
alone into buffers allocated once, by CUDA events over back-to-back calls:
below ~0.05 ms the host's launch rate, not the kernel, sets these.  Needs
a CUDA device and nvcc.

    python3 tools/torch_gru_bwd_tiles.py --wide [ROOT ...]

The wide chain (hidden 128) at ``WIDE_SHAPES``: lorenz96_scaled's decoder
heads (P=40, B=512, T=30, D=40), lorenz96_xl's (P=128, B=64, T=30, D=128),
the one-head encoder (P=1, B=512, T=10, D=40) and a ragged batch (P=3,
B=37, T=5, D=40), shared input and a broadcast h0, the same seeded inputs
for every ROOT.  For each ROOT in the order given (default: this
checkout), a fresh process imports ``vae_connexe_torch`` from ROOT, holds
its ``cuda_gru.bwd_chain`` (gh, dh0) against ``bwd_chain_plain`` (rtol
1e-3, atol 1e-4) and checks two calls bitwise equal, then times by CUDA
events the chain wrapper, the whole B2 wrapper (``_backward_launch``, no
dx) and their device time by kernel (``torch.profiler``).  A checkout
with the cluster chain (``cuda_gru.wide_chain_plan``) also prints its
plan and, at the three large shapes, every tile that fits (``WIDE_TILES``,
``wide_blocks_per_sm``), each held against the plain phase, beside
``wide_step_cost``'s figure, and the input projection against
``xproj_plain`` (1e-5 of its largest magnitude).  List an older checkout
(a ``git archive`` unpacked under ``build/``) twice around this one
(parent, change, change, parent) to compare the two on one card.  Each
process prints one ``WIDE {json}`` line per shape.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import time  # noqa: E402

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from tools.torch_step_profile import device_us, is_kernel  # noqa: E402
from vae_connexe_torch.ops import cuda_gru  # noqa: E402
from vae_connexe_torch.ops.gru import init_stacked_gru  # noqa: E402

B, T, D, H = 256, 10, 20, 64
TOL = dict(rtol=1e-3, atol=1e-4)


def time_ms(fn, iters: int = 50) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    from vae_connexe_torch.ops import _build

    for line in _build.build("gru")[1].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas", line.strip(), flush=True)
    g = torch.Generator().manual_seed(0)
    for heads in (1, 20):
        prm = init_stacked_gru(g, heads, D, H, device=dev)
        w = (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh)
        x = torch.randn((B, T, D), generator=g).to(dev)
        h0 = torch.randn((1, B, H), generator=g).to(dev).expand(heads, B, H)
        douts = torch.randn((heads, B, T, H), generator=g).to(dev)
        outs = cuda_gru._forward_launch(*w, x, h0)
        gh, dh0 = cuda_gru.bwd_chain(*w, x, h0, outs, douts)
        rgh, rdh0 = cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)
        got = cuda_gru.bwd_wgrad(*w, x, h0, outs, rgh, True)
        ref = cuda_gru.bwd_wgrad_plain(*w, x, h0, outs, rgh, True)
        torch.cuda.synchronize()
        for name, a, r in [("gh", gh, rgh), ("dh0", dh0, rdh0)] + [
                (n, a, r) for n, a, r in zip(
                    ("dx", "dW_ih", "db_ih", "dW_hh", "db_hh"), got, ref)]:
            err = (a - r).abs().max().item()
            print(f"P={heads} {name}: max_abs_err {err:.3e}", flush=True)
            torch.testing.assert_close(a, r, **TOL)
        # Kernel launches alone, into buffers allocated once.
        ops, outs_c, douts_c = cuda_gru._bwd_operands(*w, x, h0, outs, douts,
                                                      "douts")
        picked, splits, chunk, _ = cuda_gru._bwd_plan(ops[0], dev)
        row = []
        for bt in cuda_gru.CHAIN_TILES:
            ms = time_ms(lambda: cuda_gru._chain_kernel(
                ops, w, outs_c, douts_c, gh, dh0, bt, False))
            torch.testing.assert_close(gh, rgh, **TOL)   # every tile is right
            torch.testing.assert_close(dh0, rdh0, **TOL)
            row.append(f"bt={bt}: {ms:.4f} ms")
        print(f"kernel chain P={heads} picked bt={picked}: " + " | ".join(row),
              flush=True)
        # The weight-gradient kernel at chunks of K = B*T rows around the
        # one ``wgrad_splits`` takes (the sweep behind WGRAD_BLOCKS_PER_SM).
        row = []
        for ch in sorted({64, 128, 256, 320, 448, 640, 1280, chunk}):
            n = -(-B * T // ch)
            part = torch.empty((heads, n, 3 * H * (H + D + 2)), device=dev)
            ms = time_ms(lambda: cuda_gru._wgrad_kernel(
                ops, prm.w_ih, outs_c, gh, None, part, n, ch))
            row.append(f"{n}x{ch}: {ms:.4f} ms")
        print(f"kernel wgrad P={heads} picked {splits} splits of {chunk} "
              "rows: " + " | ".join(row), flush=True)

        def b2():
            cuda_gru._backward_launch(*w, x, h0, outs, douts, need_dx=False)

        full = time_ms(b2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            b2()
        host = (time.perf_counter() - t0) / 50 * 1e3
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                b2()
            torch.cuda.synchronize()
        kern = [(device_us(e) / 20 / 1e3, e.key[:60])
                for e in prof.key_averages()
                if is_kernel(e) and device_us(e) > 0]
        print(f"B2 wrapper P={heads}: {full:.4f} ms by events, host enqueue "
              f"{host:.4f} ms a call, device "
              f"{sum(k for k, _ in kern):.4f} ms a call: "
              + "; ".join(f"{n} {k:.4f}" for k, n in kern), flush=True)


WIDE_SHAPES = (("scaled_heads", 40, 512, 30, 40),
               ("xl_heads", 128, 64, 30, 128),
               ("one_head", 1, 512, 10, 40), ("ragged", 3, 37, 5, 40))
WIDE_H = 128


def wide_one(root: str) -> None:
    """The wide chain of the checkout at ``root`` (run in a process of its
    own: the package is imported from there)."""
    import json

    sys.path.insert(0, os.path.abspath(root))
    for name in [m for m in sys.modules if m.startswith("vae_connexe_torch")]:
        del sys.modules[name]
    import torch
    from torch.profiler import ProfilerActivity, profile

    from vae_connexe_torch.ops import cuda_gru as cg
    from vae_connexe_torch.ops.gru import init_stacked_gru

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    planned = hasattr(cg, "wide_chain_plan")
    for what, heads, b, t, d in WIDE_SHAPES:
        g = torch.Generator().manual_seed(heads * 1000 + b)
        prm = init_stacked_gru(g, heads, d, WIDE_H, device="cpu")
        w = tuple(v.to(dev) for v in (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh))
        x = torch.randn((b, t, d), generator=g).to(dev)
        h0 = torch.randn((1, b, WIDE_H), generator=g).to(dev).expand(
            heads, b, WIDE_H)
        douts = torch.randn((heads, b, t, WIDE_H), generator=g).to(dev)
        outs = cg._forward_launch(*w, x, h0)
        rgh, rdh0 = cg.bwd_chain_plain(*w, x, h0, outs, douts)
        gh, dh0 = cg.bwd_chain(*w, x, h0, outs, douts)
        gh2, dh02 = cg.bwd_chain(*w, x, h0, outs, douts)
        torch.cuda.synchronize()
        row = {"shape": what, "P": heads, "B": b, "T": t, "D": d, "H": WIDE_H,
               "root": root, "gh_err": (gh - rgh).abs().max().item(),
               "dh0_err": (dh0 - rdh0).abs().max().item(),
               "bitwise": bool(torch.equal(gh, gh2) and torch.equal(dh0, dh02))}
        torch.testing.assert_close(gh, rgh, **TOL)
        torch.testing.assert_close(dh0, rdh0, **TOL)
        assert row["bitwise"], what
        row["chain_ms"] = time_ms(lambda: cg.bwd_chain(*w, x, h0, outs, douts),
                                  20)
        row["b2_ms"] = time_ms(lambda: cg._backward_launch(
            *w, x, h0, outs, douts, need_dx=False), 20)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                cg._backward_launch(*w, x, h0, outs, douts, need_dx=False)
            torch.cuda.synchronize()
        row["b2_device_ms"] = {
            e.key[:48]: float(getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0.0))) / 5 / 1e3
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")}
        if planned:
            limits = cg.device_limits(dev)
            row["plan"] = cg.wide_chain_plan(b, heads, WIDE_H, limits)
            xp = cg.bwd_xproj(w[0], w[1], x)
            rxp = cg.xproj_plain(w[0], w[1], x)
            torch.cuda.synchronize()
            row["xproj_err"] = (xp - rxp).abs().max().item()
            assert row["xproj_err"] <= 1e-5 * rxp.abs().max().item(), what
            row["xproj_ms"] = time_ms(lambda: cg.bwd_xproj(w[0], w[1], x), 20)
            ops, outs_c, douts_c = cg._bwd_operands(*w, x, h0, outs, douts,
                                                    "douts")
            sweep = {}
            for bt in cg.WIDE_TILES if what != "ragged" else ():
                per_sm = cg.wide_blocks_per_sm(bt, WIDE_H, limits)
                if per_sm < 1:
                    continue
                ms = time_ms(lambda: cg._chain_kernel(
                    ops, w, outs_c, douts_c, gh, dh0, bt, True), 10)
                torch.testing.assert_close(gh, rgh, **TOL)
                torch.testing.assert_close(dh0, rdh0, **TOL)
                blocks = heads * -(-b // bt) * cg.WIDE_CLUSTER
                sweep[f"bt{bt}"] = {
                    "ms": ms, "per_sm": per_sm,
                    "model": cg.wide_step_cost(bt, WIDE_H, blocks, per_sm,
                                               limits[2])}
            row["sweep"] = sweep
        print("WIDE " + json.dumps(row), flush=True)


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
