"""Time the CRVAE free-run kernel (K1) at each batch-tile width on one GPU.

    python3 tools/torch_rollout_tiles.py

The tile policy of ``vae_connexe_torch/ops/cuda_rollout.pick_bt`` rests on
this sweep: for each batch it prints the device time of one launch at tile
widths 1, 2, 4 and 8 (p=20, H=64, T=21, float32), calling the kernel
library directly so that the policy itself is bypassed.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from vae_connexe_torch.models import CRVAE  # noqa: E402
from vae_connexe_torch.ops import cuda_rollout as cr  # noqa: E402

P, H, T = 20, 64, 21


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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    g = torch.Generator().manual_seed(0)
    params = CRVAE(P, H).init(g, dev)
    hd = params.heads
    wi = hd.w_ih.transpose(1, 2).contiguous()
    wh = hd.w_hh.transpose(1, 2).contiguous()
    for b in (8, 37, 64, 264, 1024, 3072):
        h0 = torch.randn((b, H), generator=g).to(dev)
        noise = torch.randn((b, T, P), generator=g).to(dev)
        x0 = torch.zeros((b, P), device=dev)
        out = torch.empty((b, T, P), device=dev)
        args = (x0, h0, noise, wi, wh, hd.b_ih, hd.b_hh, params.readout.w,
                params.readout.b, out)
        row = []
        for bt in (1, 2, 4, 8):
            ms = time_ms(lambda: cr._launch("vcx_crvae_free_run", dev, args,
                                            (b, T, P, H), bt, scale=0.1))
            row.append(f"bt={bt}: {ms:.4f} ms")
        print(f"K1 B={b} picked bt={cr._pick_bt_on(dev, b, P, H, P)}: "
              + " | ".join(row), flush=True)


if __name__ == "__main__":
    main()
