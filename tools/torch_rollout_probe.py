"""Split the resident rollout kernels' time by part, on one GPU.

    python3 tools/torch_rollout_probe.py

Builds copies of ``vae_connexe_torch/csrc/rollout.cu`` with parts of the
resident bodies switched off (one ``nvcc`` per variant, all started
together, under the package's ``build/probe``) and times K1 and K2 at the
serving width (p=20, H=64, T=21) at B=1 and B=3072, in float32
(``resident_body``) and in bf16 (``mma_body``, the tensor-core body), with
the plans ``cuda_rollout.rollout_route`` picks, by CUDA events:

- ``base``: the kernels as they are;
- ``no_dsmem``: K1's readout stores only into its own block;
- ``no_barrier``: no cluster barrier (and no DSMEM stores, which a block
  that may already have exited cannot take): a block barrier instead;
- ``no_readout``: no readout (x stays as it was);
- ``no_gates``: no gate product or gate math;
- ``gates_only``: the gates without barrier, DSMEM stores or readout;
- ``nothing``: staging, the tile loop and its barriers alone;
- ``fast_math``: the gates' exponentials by ``__expf``;
- ``no_update`` (bf16 only): the GRU update without its sigmoids and tanh;
- ``no_product`` (bf16 only): the update from the biases, no mma.

A variant's outputs are wrong by design; each is run in its own process,
so a fault in one does not stop the others.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = {
    "base": [],
    "no_dsmem": ["NO_DSMEM"],
    "no_barrier": ["NO_BARRIER", "NO_DSMEM"],
    "no_readout": ["NO_READOUT"],
    "no_gates": ["NO_GATES"],
    "gates_only": ["NO_BARRIER", "NO_DSMEM", "NO_READOUT"],
    "nothing": ["NO_BARRIER", "NO_DSMEM", "NO_READOUT", "NO_GATES"],
    "fast_math": ["FAST_MATH"],
    "no_update": ["NO_UPDATE"],
    "no_product": ["NO_PRODUCT"],
}

# (text in rollout.cu, its replacement with the switches[, how many times
# it occurs: 1 if not given]); each must match exactly so often, so an
# edit to the kernels that moves one fails loudly.
PATCHES = [
    ('#include "gru_fwd.cuh"', '#include "{csrc}/gru_fwd.cuh"'),
    ("""      if constexpr (CLUSTER) {
        if (t > 0) cluster_wait();
      }""", """#ifndef NO_BARRIER
      if constexpr (CLUSTER) {
        if (t > 0) cluster_wait();
      }
#endif""", 2),
    ("""      if constexpr (CLUSTER) {
        cluster_arrive();""", """#ifdef NO_BARRIER
      __syncthreads();
      if constexpr (false) {
#else
      if constexpr (CLUSTER) {
#endif
        cluster_arrive();""", 2),
    # The bf16 body's own parts.
    ("""          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = xv;""",
     """#ifdef NO_DSMEM
          *dst = xv; (void)cl;
#else
          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = xv;
#endif"""),
    ("""        for (int e = blockDim.x - 1 - threadIdx.x; e < ncols * live;""",
     """#ifdef NO_READOUT
        for (int e = blockDim.x - 1 - threadIdx.x; e < 0;
#else
        for (int e = blockDim.x - 1 - threadIdx.x; e < ncols * live;
#endif"""),
    ("""        for (int it = n_warps - 1 - warp; it < n_mt * n_ot; it += n_warps) {""",
     """#ifdef NO_READOUT
        for (int it = n_warps - 1 - warp; it < 0; it += n_warps) {
#else
        for (int it = n_warps - 1 - warp; it < n_mt * n_ot; it += n_warps) {
#endif"""),
    ("""      if (warp < n_items) mma_hidden_half(l, c, q, k);""",
     """#ifndef NO_GATES
      if (warp < n_items) mma_hidden_half(l, c, q, k);
#endif"""),
    ("""      for (int it = warp; it < n_items; it += n_warps) {""",
     """#ifdef NO_GATES
      for (int it = warp; it < 0; it += n_warps) {
#else
      for (int it = warp; it < n_items; it += n_warps) {
#endif"""),
    ("""  for (int k = 0; k < n_k; k += kMmaK) {""", """#ifdef NO_PRODUCT
  for (int k = 0; k < 0; k += kMmaK) {
#else
  for (int k = 0; k < n_k; k += kMmaK) {
#endif"""),
    ("""      const float rr = sigmoid_f(c.r[e]), zz = sigmoid_f(c.z[e]);
      const float nn = tanhf(c.xn[e] + rr * c.hn[e]);""", """#if defined(NO_UPDATE)
      const float rr = c.r[e], zz = c.z[e];
      const float nn = c.xn[e] + rr * c.hn[e];
#elif defined(FAST_MATH)
      const float rr = 1.0f / (1.0f + __expf(-c.r[e]));
      const float zz = 1.0f / (1.0f + __expf(-c.z[e]));
      const float nn = 1.0f - 2.0f / (__expf(2.0f * (c.xn[e] + rr * c.hn[e])) + 1.0f);
#else
      const float rr = sigmoid_f(c.r[e]), zz = sigmoid_f(c.z[e]);
      const float nn = tanhf(c.xn[e] + rr * c.hn[e]);
#endif"""),
    ("""          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = v;""",
     """#ifdef NO_DSMEM
          *dst = v; (void)cl;
#else
          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = v;
#endif"""),
    ("""      for (int e = threadIdx.x; e < ncols * bt; e += blockDim.x) {
        const int b = e % bt, c = e / bt;
        const float* hv""", """#ifdef NO_READOUT
      for (int e = threadIdx.x; e < 0; e += blockDim.x) {
#else
      for (int e = threadIdx.x; e < ncols * bt; e += blockDim.x) {
#endif
        const int b = e % bt, c = e / bt;
        const float* hv"""),
    ("""    const float rr = sigmoid_f(s[r][0]), zz = sigmoid_f(s[r][1]);
    const float nn = tanhf(s[r][2] + rr * s[r][3]);""", """#ifdef FAST_MATH
    const float rr = 1.0f / (1.0f + __expf(-s[r][0]));
    const float zz = 1.0f / (1.0f + __expf(-s[r][1]));
    const float nn = 1.0f - 2.0f / (__expf(2.0f * (s[r][2] + rr * s[r][3])) + 1.0f);
#else
    const float rr = sigmoid_f(s[r][0]), zz = sigmoid_f(s[r][1]);
    const float nn = tanhf(s[r][2] + rr * s[r][3]);
#endif"""),
]
GATE_GUARD = "      if (gate) {\n"          # both halves of the gate phase


def probe_source(csrc: str) -> str:
    """rollout.cu with the switches of ``VARIANTS`` compiled in."""
    with open(os.path.join(csrc, "rollout.cu")) as f:
        src = f.read()
    for old, new, *times in PATCHES:
        n = times[0] if times else 1
        if src.count(old) != n:
            raise RuntimeError(f"rollout.cu no longer holds {n} of "
                               f"{old[:60]!r}")
        src = src.replace(old, new.replace("{csrc}", csrc))
    if src.count(GATE_GUARD) != 2:
        raise RuntimeError("rollout.cu no longer holds the two gate phases")
    return src.replace(GATE_GUARD, "#ifdef NO_GATES\n      if (false) {\n"
                       "#else\n      if (gate) {\n#endif\n")


def build(out_dir: str) -> None:
    from vae_connexe_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "rollout_probe.cu")
    with open(src, "w") as f:
        f.write(probe_source(str(_build.CSRC)))
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in defs],
         "-o", os.path.join(out_dir, f"lib_{name}.so"), src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in VARIANTS.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")


def time_variant(path: str) -> str:
    import torch

    from vae_connexe_torch.models import CRVAE, ErrorVAE
    from vae_connexe_torch.ops import cuda_rollout as cr

    lib = ctypes.CDLL(path)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for suffix in ("", "_bf16"):
        getattr(lib, "vcx_crvae_free_run_resident" + suffix).argtypes = (
            [p_] * 10 + [i_] * 4 + [ctypes.c_float] + [i_] * 4 + [p_])
        getattr(lib, "vcx_errvae_sample_resident" + suffix).argtypes = (
            [p_] * 8 + [i_] * 6 + [p_])
    dev = torch.device("cuda")
    p, hidden, t_len = 20, 64, 21
    g = torch.Generator().manual_seed(0)
    params, err = CRVAE(p, hidden).init(g, dev), ErrorVAE(p, hidden).init(g, dev)
    weights = {4: (params.heads, params.readout, err.dec, err.out)}
    weights[2] = tuple(cr.cast_weights(w, torch.bfloat16)
                       for w in weights[4])
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())   # noqa: E731
    row = []
    for b in (1, 3072):
        rnd = cr._carries(torch.bfloat16)
        h0 = rnd(torch.randn((b, hidden), generator=g).to(dev))
        noise = rnd(torch.randn((b, t_len, p), generator=g).to(dev))
        x0 = torch.zeros((b, p), device=dev)
        out1 = torch.empty((b, t_len, p), device=dev)
        out2 = torch.empty((b, t_len, p), device=dev)
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        for elem, suffix in ((4, ""), (2, "_bf16")):
            hd, ro, dec, out = weights[elem]
            k1_plan, n_clusters = cr._plan("crvae", p, b, p, hidden, dev, elem)
            k2_plan, _ = cr._plan("errvae", 1, b, p, hidden, dev, elem)
            k1 = (*map(ptr, (x0, h0, noise, hd.w_ih, hd.w_hh, hd.b_ih,
                             hd.b_hh, ro.w, ro.b, out1)), b, t_len, p, hidden,
                  ctypes.c_float(0.1), k1_plan.cluster, k1_plan.bt,
                  k1_plan.split, n_clusters, stream)
            k2 = (*map(ptr, (h0, dec.w_ih, dec.w_hh, dec.b_ih, dec.b_hh,
                             out.w, out.b, out2)), b, t_len, p, hidden,
                  k2_plan.bt, k2_plan.split, stream)
            for name, fn, args in (
                    ("K1", getattr(lib, "vcx_crvae_free_run_resident"
                                   + suffix), k1),
                    ("K2", getattr(lib, "vcx_errvae_sample_resident"
                                   + suffix), k2)):
                iters = 200 if b == 1 else 20
                rc = fn(*args)
                for _ in range(2):
                    fn(*args)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                row.append(f"{name}{suffix} B={b} "
                           f"{start.elapsed_time(end) / iters:.4f} ms"
                           + (f" (rc {rc})" if rc else ""))
    return ", ".join(row)


def main() -> None:
    from vae_connexe_torch.ops import _build

    out_dir = str(_build.BUILD_DIR / "probe")
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(time_variant(sys.argv[2]), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    build(out_dir)
    for name in VARIANTS:
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--time",
             os.path.join(out_dir, f"lib_{name}.so")],
            capture_output=True, text=True, timeout=300)
        line = res.stdout.strip() or f"failed: {res.stderr.strip()[-300:]}"
        print(f"{name}: {line}", flush=True)


if __name__ == "__main__":
    main()
