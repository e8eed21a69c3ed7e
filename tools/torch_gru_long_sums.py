"""How far float32 gradients of the GRU recurrence are from exact, on one GPU.

    python3 tools/torch_gru_long_sums.py

For each shape, the same random weights (a random parents mask on W_ih),
shared input, h0 and douts go through B1/B2 (``gru_scan_heads_fused``,
whichever variant ``cuda_gru.recurrence_route`` picks), the plain version
in float32 and the plain version in float64.  For the outputs and every
gradient it prints the largest magnitude, the largest absolute difference
of each pair, and how many elements of the kernel (against float32 plain)
and of float32 plain (against float64 plain) fall outside ``chip_smoke.py``'s
GRAD_TOL (rtol 1e-3, atol 1e-4).  Then the same for B2's weight-gradient
kernel alone, as ``chip_smoke.py``'s phase check runs it: dx, dW and db
from the plain float32 gate gradients, against the plain phase in float32
and in float64 on the same gate gradients.  Shapes: the main path's
decoder heads, ``lorenz96_scaled``'s (the wide kernels), the same B*T at
hidden 64 (the kernels with both weights in shared memory), and
``lorenz96_crcsrae``'s decoder heads and encoder at batch 2048: the
evidence behind ``chip_smoke.py``'s LONG_SUM_TOL.  Needs a CUDA device and
nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vae_connexe_torch.ops import cuda_gru  # noqa: E402
from vae_connexe_torch.ops.gru import GRUParams, init_stacked_gru  # noqa: E402

RTOL, ATOL = 1e-3, 1e-4
# (heads, batch, steps, D, H)
SHAPES = [(20, 256, 10, 20, 64), (40, 512, 30, 40, 128), (40, 512, 30, 20, 64),
          (10, 2048, 10, 10, 64), (1, 2048, 10, 10, 64)]
NAMES = ("outs", "dW_ih", "dW_hh", "db_ih", "db_hh", "dx", "dh0")
PHASE_NAMES = ("dx", "dW_ih", "db_ih", "dW_hh", "db_hh")


def outs_and_grads(fn, params, x, h0, douts, dtype):
    ins = [v.clone().to(dtype).requires_grad_(True) for v in
           (params.w_ih, params.w_hh, params.b_ih, params.b_hh, x, h0)]
    outs, _ = fn(GRUParams(*ins[:4]), ins[4], ins[5])
    grads = torch.autograd.grad((outs * douts.to(dtype)).sum(), ins)
    return [outs.detach().double(), *(v.double() for v in grads)]


def outside(a, r) -> int:
    return int(((a - r).abs() > ATOL + RTOL * r.abs()).sum().item())


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    limits = cuda_gru.device_limits(dev)
    for heads, b, t, d, hidden in SHAPES:
        g = torch.Generator().manual_seed(b + heads)
        params = init_stacked_gru(g, heads, d, hidden, device=dev)
        mask = (torch.rand((heads, d), generator=g) > 0.3).float().to(dev)
        params = GRUParams(params.w_ih * mask[:, None, :], params.w_hh,
                           params.b_ih, params.b_hh)
        x = torch.randn((b, t, d), generator=g).to(dev)
        h0 = torch.randn((1, b, hidden), generator=g).to(dev)
        douts = torch.randn((heads, b, t, hidden), generator=g).to(dev)
        kern = outs_and_grads(cuda_gru.gru_scan_heads_fused, params, x, h0,
                              douts, torch.float32)
        p32, p64 = (outs_and_grads(cuda_gru.gru_scan_heads_fused_plain,
                                   params, x, h0, douts, dt)
                    for dt in (torch.float32, torch.float64))
        route = cuda_gru.recurrence_route(heads, b, d, hidden, limits)
        print(f"P={heads} B={b} T={t} D={d} H={hidden} (B*T={b * t}, "
              f"route {route}):", flush=True)
        for name, k, r, e in zip(NAMES, kern, p32, p64):
            report(name, k, r, e)
        # The weight-gradient kernel alone, on the plain float32 gh.
        w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
        outs, hb = kern[0].float(), h0.expand(heads, b, hidden)
        gh, _ = cuda_gru.bwd_chain_plain(*w, x, hb, outs, douts)
        k_w = cuda_gru.bwd_wgrad(*w, x, hb, outs, gh, True)
        r32 = cuda_gru.bwd_wgrad_plain(*w, x, hb, outs, gh, True)
        r64 = cuda_gru.bwd_wgrad_plain(
            *(t.double() for t in (*w, x, hb, outs, gh)), True)
        print("  weight-gradient kernel from the plain gh:", flush=True)
        for name, k, r, e in zip(PHASE_NAMES, k_w, r32, r64):
            report("  " + name, k.double(), r.double(), e)


def report(name, k, r, e) -> None:
    """One line: the largest magnitude, the three pairs' largest
    differences and the elements outside GRAD_TOL."""
    print(f"  {name}: |ref| <= {r.abs().max().item():.4e}; "
          f"kernel-plain32 {(k - r).abs().max().item():.4e}, "
          f"kernel-plain64 {(k - e).abs().max().item():.4e}, "
          f"plain32-plain64 {(r - e).abs().max().item():.4e}; "
          f"outside GRAD_TOL: kernel {outside(k, r)}, plain32 "
          f"{outside(r, e)}, kernel against plain64 {outside(k, e)}",
          flush=True)


if __name__ == "__main__":
    main()
