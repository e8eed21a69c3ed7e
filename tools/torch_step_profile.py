"""Where a training step's device time goes, by kernel, on one GPU.

    python3 tools/torch_step_profile.py

Traces 20 steps of each step path at p=20, H=64, ctx=20, B=256 with
``torch.profiler`` (CPU and CUDA activity): ``fused_phase1_step`` (the
eleven kernels of csrc/step.cu), ``make_phase1_step`` (B1/B2 plus eager
PyTorch) and ``make_phase2_step`` (four B1 and four B2 launches, the
ErrorVAE's Adam, eager PyTorch).  Prints, per path, the wall time per step, the device time per
step summed over kernels (host operators are left out: they carry their
kernels' time too), their ratio (the device's busy share; idle is the
rest), and the kernels that take the most device time.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from vae_connexe_torch.models import CRVAE, ErrorVAE  # noqa: E402
from vae_connexe_torch.optim import adam_init  # noqa: E402
from vae_connexe_torch.ops.cuda_step import fused_phase1_step  # noqa: E402
from vae_connexe_torch.train import (  # noqa: E402
    Phase1Config,
    Phase1State,
    Phase2Config,
    Phase2State,
    make_phase1_step,
    make_phase2_step,
)

P, H, CTX, B, STEPS = 20, 64, 20, 256, 20


def device_us(evt) -> float:
    """Device time of a profiler row, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def is_kernel(evt) -> bool:
    """A row of the device itself, not an operator on the host (those carry
    their kernels' time too, and would count it twice)."""
    return str(getattr(evt, "device_type", "")).endswith("CUDA")


def trace(name, run_step, card):
    for _ in range(5):
        run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run_step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS * 1e3
    rows = [e for e in prof.key_averages() if is_kernel(e) and device_us(e) > 0]
    rows.sort(key=device_us, reverse=True)
    busy = sum(device_us(e) for e in rows) / STEPS / 1e3
    print(f"{name}: wall {wall:.4f} ms/step (under the profiler), device "
          f"{busy:.4f} ms/step, busy share {busy / wall:.3f} [{card}]")
    for e in rows[:12]:
        print(f"  {device_us(e) / STEPS / 1e3:9.4f} ms/step  "
              f"{e.count // STEPS:4d} calls/step  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    model = CRVAE(P, H)
    params = model.init(torch.Generator().manual_seed(1), dev)
    windows = torch.randn((2048, CTX, P), generator=g, device=dev)
    parents = torch.ones((P, P), device=dev)
    cfg = Phase1Config(batch_size=B)
    eps = torch.randn((B, H), generator=g, device=dev)
    batch = windows[:B].contiguous()
    trace("fused_phase1_step",
          lambda: fused_phase1_step(model, cfg, params, parents, batch, eps),
          card)
    step = make_phase1_step(model, cfg, windows, parents)
    state = [Phase1State(params=params, prior=None, best_params=params,
                         best_loss=torch.tensor(float("inf"), device=dev),
                         generator=g, step=0)]

    def run():
        state[0] = step(state[0])[0]

    trace("make_phase1_step", run, card)

    err = ErrorVAE(P, H)
    eparams = err.init(torch.Generator().manual_seed(2), dev)
    step2 = make_phase2_step(model, err, Phase2Config(batch_size=B), windows,
                             parents)
    state2 = [Phase2State(params=params, err_params=eparams,
                          err_opt=adam_init(eparams), prior=None,
                          best_params=params,
                          best_loss=torch.tensor(float("inf"), device=dev),
                          generator=g, step=0)]

    def run2():
        state2[0] = step2(state2[0])[0]

    trace("make_phase2_step", run2, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
