"""Sweep the rollout kernels' designs on one GPU.

    python3 tools/torch_rollout_tiles.py [--streamed | --bf16]

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
bf16 resident route (``--bf16`` runs this part alone; the tensor-core body
``mma_body``): first a check of the wrappers at the plans' picks against
the plain bf16 versions (largest error, share of elements equal bit for
bit, two calls bitwise equal) at the serving width (K1 p=20, K2 d=20,
H=64), at lorenz96_scaled's K2 (d=40, H=128), at an odd width (p=6, H=7),
at p=2 and p=10, B = 1, 37, 3072; then K1 at p=20 and p=10 for each
cluster size and each tile of ``cuda_rollout.MMA_TILES`` that fits, and
K2 at both widths for each tile, at B = 1, 37 and 3072 (device time of
one launch, share against the plain bf16 version), beside the float32
kernel at its plan; then the same sweep of a build in which each mma
starts from zero and its k16 partial joins the running sum by a rounded
float32 add (``SPLIT_ADDS``), time and share beside the default build's.
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


BF16_BATCHES = (1, 37, 3072)


def bf16_inputs(dev, g, kind, p, hidden, b):
    """bf16 weights (K1: ``p`` heads; K2: d = ``p``), bf16-valued inputs on
    ``dev``, the launch's tensors before ``out`` and its plain bf16
    output, and the float32 weights' tensors for the float32 kernel."""
    bf = torch.bfloat16
    if kind == "crvae":
        params = CRVAE(p, hidden).init(g, dev)
        w32, ro32 = params.heads, params.readout
    else:
        params = ErrorVAE(p, hidden).init(g, dev)
        w32, ro32 = params.dec, params.out
    w, ro = cr.cast_weights(w32, bf), cr.cast_weights(ro32, bf)
    rnd = cr._carries(bf)
    h0 = rnd(torch.randn((b, hidden), generator=g).to(dev))
    if kind == "crvae":
        noise = rnd(torch.randn((b, T, p), generator=g).to(dev))
        x0 = rnd(torch.randn((b, p), generator=g).to(dev))
        ref = cr.crvae_free_run_plain(w, ro, x0, h0, noise, 0.1)
        head = (x0, h0, noise)
        call = lambda ws, rs: cr.crvae_free_run_fused(  # noqa: E731
            ws, rs, x0, h0, noise, 0.1)
    else:
        ref = cr.errvae_sample_plain(w, ro, h0, p, T)
        head = (h0,)
        call = lambda ws, rs: cr.errvae_sample_fused(  # noqa: E731
            ws, rs, h0, p, T)
    args = (*head, w.w_ih, w.w_hh, w.b_ih, w.b_hh, ro.w, ro.b)
    return args, ref, lambda: call(w, ro), lambda: call(w32, ro32)


def share(out, ref) -> float:
    return float((out == ref).float().mean())


def check_bf16(dev, g) -> bool:
    """The wrappers at their plans against the plain bf16 versions."""
    ok = True
    for kind, p, hidden in (("crvae", 20, 64), ("errvae", 20, 64),
                            ("errvae", 40, 128), ("crvae", 6, 7),
                            ("errvae", 6, 7), ("crvae", 2, 64),
                            ("crvae", 10, 64)):
        for b in BF16_BATCHES:
            _, ref, run, _ = bf16_inputs(dev, g, kind, p, hidden, b)
            plan, _ = cr._plan(kind, p if kind == "crvae" else 1, b, p,
                               hidden, dev, 2)
            try:
                out, again = run(), run()
                torch.cuda.synchronize()
            except RuntimeError as e:
                print(f"check bf16 {kind} p={p} H={hidden} B={b}: {e}",
                      flush=True)
                ok = False
                continue
            err = (out - ref).abs().max().item()
            rel = ((out - ref).abs() / (ref.abs() + 1)).max().item()
            same = torch.equal(out, again)
            good = (rel <= 2.0 ** -8 and same
                    and bool(torch.isfinite(out).all()))
            ok = ok and good
            print(f"check bf16 {kind} p={p} H={hidden} B={b} "
                  f"({plan.route} cluster={plan.cluster} bt={plan.bt} "
                  f"smem={plan.smem}): err {err:.3e} rel {rel:.3e} share "
                  f"{share(out, ref):.5f} repeat {same} "
                  f"{'ok' if good else 'FAIL'}", flush=True)
    return ok


def sweep_bf16(dev, g, limits, lib, name) -> None:
    """K1 at p=20, 10 over clusters and tiles, K2 at d=20 / H=64 and d=40 /
    H=128 over tiles, with library ``lib`` (``name`` its build)."""
    for kind, p, hidden in (("crvae", 20, 64), ("crvae", 10, 64),
                            ("errvae", 20, 64), ("errvae", 40, 128)):
        heads = p if kind == "crvae" else 1
        outs = 1 if kind == "crvae" else p
        clusters = [c for c in CLUSTERS if c <= p] if kind == "crvae" else [1]
        inputs = {b: bf16_inputs(dev, g, kind, p, hidden, b)
                  for b in BF16_BATCHES}
        f32 = {b: time_ms(inputs[b][3], 5 if b > 1 else 20)
               for b in BF16_BATCHES}
        plans = {b: cr.rollout_route(kind, heads, b, p, hidden, limits, 2)
                 for b in BF16_BATCHES}
        for c in clusters:
            hpb = -(-heads // c)
            for bt in reversed(cr.MMA_TILES):
                smem = cr.mma_smem_bytes(hpb, bt, p, hidden, outs,
                                         kind == "crvae")
                if smem > limits[0]:
                    continue
                row = [f"{name} {kind} bf16 p={p} H={hidden} C={c} "
                       f"heads/block={hpb} bt={bt} smem={smem}"]
                active = ctypes.c_int(0)
                if kind == "crvae":
                    rc = lib.vcx_crvae_max_clusters(p, hidden, c, bt, 0, 1,
                                                    ctypes.byref(active))
                    row[0] += f" max_active_clusters={active.value}"
                    if rc != 0 or active.value < 1:
                        print(row[0] + f": not launchable (rc {rc})",
                              flush=True)
                        continue
                for b in BF16_BATCHES:
                    args, ref = inputs[b][:2]
                    out = torch.empty((b, T, p), device=dev)
                    if kind == "crvae":
                        fn = lib.vcx_crvae_free_run_resident_bf16
                        ints = (b, T, p, hidden, ctypes.c_float(0.1), c, bt, 0,
                                min(active.value, -(-b // bt)))
                    else:
                        fn = lib.vcx_errvae_sample_resident_bf16
                        ints = (b, T, p, hidden, bt, 0)
                    ptrs = [ctypes.c_void_p(t.data_ptr())
                            for t in (*args, out)]
                    stream = ctypes.c_void_p(
                        torch.cuda.current_stream().cuda_stream)

                    def run():
                        rc = fn(*ptrs, *ints, stream)
                        if rc != 0:
                            raise RuntimeError(f"cuda {rc}")

                    try:
                        ms = time_ms(run, 5 if b > 1 else 20)
                    except RuntimeError as e:
                        row.append(f"B={b}: {e}")
                        continue
                    pick = plans[b]
                    mark = "*" if (pick.route, pick.cluster, pick.bt) == (
                        "resident", c, bt) else ""
                    row.append(f"B={b}{mark}: {ms:.4f} ms (f32 {f32[b]:.4f}) "
                               f"share {share(out, ref):.5f} err "
                               f"{(out - ref).abs().max().item():.2e}")
                print(" | ".join(row), flush=True)


# The split-adds build: rollout.cu's mma16816 renamed, and a new one that
# runs it from zero and adds the k16 partial by a rounded float32 add.
SPLIT_ADDS = (
    ("__device__ __forceinline__ void mma16816(",
     "__device__ __forceinline__ void mma16816_fused("),
    ("// One k span (n_k, a multiple of 16)",
     """__device__ __forceinline__ void mma16816(float (&c)[4],
                                         const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma16816_fused(p, a, b0, b1);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = __fadd_rn(c[e], p[e]);
}

// One k span (n_k, a multiple of 16)"""),
    ('#include "gru_fwd.cuh"', '#include "{csrc}/gru_fwd.cuh"'),
)


def variant_library(out_dir: str):
    """rollout.cu built with each mma's k16 partial added by a rounded
    float32 add (``SPLIT_ADDS``), its C signatures declared."""
    from vae_connexe_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    with open(_build.CSRC / "rollout.cu") as f:
        src = f.read()
    for old, new in SPLIT_ADDS:
        if src.count(old) != 1:
            raise RuntimeError(f"rollout.cu no longer holds one {old!r}")
        src = src.replace(old, new.replace("{csrc}", str(_build.CSRC)))
    cu = os.path.join(out_dir, "rollout_split_adds.cu")
    with open(cu, "w") as f:
        f.write(src)
    path = os.path.join(out_dir, "librollout_split_adds.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", path, cu],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(path)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    lib.vcx_crvae_free_run_resident_bf16.argtypes = (
        [p_] * 10 + [i_] * 4 + [ctypes.c_float] + [i_] * 4 + [p_])
    lib.vcx_errvae_sample_resident_bf16.argtypes = [p_] * 8 + [i_] * 6 + [p_]
    lib.vcx_crvae_max_clusters.argtypes = [i_] * 6 + [ctypes.POINTER(i_)]
    return lib


def main_bf16(dev, g, limits) -> None:
    if not check_bf16(dev, g):
        sys.exit("the bf16 body disagrees with its plain version")
    from vae_connexe_torch.ops import _build

    split = variant_library(str(_build.BUILD_DIR / "variants"))
    for lib, name in ((rollout_library(), "mma"), (split, "split_adds")):
        sweep_bf16(dev, g, limits, lib, name)


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
    if sys.argv[1:] == ["--bf16"]:
        main_bf16(dev, g, limits)
        return
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
