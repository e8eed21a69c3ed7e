"""Split B2's wide chain (hidden 128) by part, on one GPU.

    python3 tools/torch_gru_wide_probe.py
    python3 tools/torch_gru_wide_probe.py --control

Builds copies of ``vae_connexe_torch/csrc/gru.cu`` whose wide chain
(``csrc/gru_wide.cuh``) has parts switched off (one ``nvcc`` per variant,
all started together, under the package's ``build/probe_wide``) and times
the chain's C call (``vcx_gru_bwd_chain``: the input projection, then the
walk) at ``cuda_gru.wide_chain_plan``'s plan, by CUDA events, at
lorenz96_scaled's decoder heads (P=40, B=512, T=30, D=40) and lorenz96_xl's
(P=128, B=64, T=30, D=128), H=128, and the projection alone
(``vcx_gru_xproj``) of each build:

- ``base``: the kernels as they are;
- ``no_dsmem``: every d h_prev partial stored into its own block;
- ``no_barrier``: no cluster barrier (and no DSMEM stores): a block
  barrier instead;
- ``fast_math``: the gates' sigmoids and tanh by ``__expf``;
- ``no_math``: the gate math without its sigmoids and tanh;
- ``no_io``: no xp or douts loads and no gh stores;
- ``no_hidden``: no hidden-half product;
- ``no_dh``: no d h_prev product;
- ``products_only``: the two products, the syncs and the h_prev copies
  (no_barrier, no_math, no_io);
- ``nothing``: staging, the step loop's copies and barriers alone;
- ``xproj_no_store``, ``xproj_no_fma``: the input projection without its
  stores to gh (all but never taken) or without its products;
- ``one_pass``: every product one TF32 pass (the lo halves of the split
  set to zero), the precision a chain on plain TF32 would have.

(``no_hidden`` also takes the hidden half out of B1's wide forward, which
shares its product; the forward is not timed here.)  A variant's outputs
are wrong by design.  ``--control`` builds ``base`` and ``one_pass`` alone
and holds each build's gh and dh0, at the plan, on ``chip_smoke.py``'s
wide cases (``wide_training_cases``, the same seeded inputs), against
``cuda_gru.bwd_chain_plain`` at ``chip_smoke.py``'s ``WIDE_CHAIN_TOL``,
and each build's wide forward (``vcx_gru_forward`` at
``cuda_gru.wide_fwd_plan``'s tile) against the plain forward at
``chip_smoke.py``'s ``OUT_TOL`` (B1's 1e-5 absolute): it prints each
build's largest errors and their worst share of the limits (1 or below:
within), and exits 1 unless ``base`` is within both limits at every case
and ``one_pass`` outside both at every case, so that the limits tell the
walks' three-pass accuracy from one pass.  Needs a CUDA device and nvcc.
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
    "fast_math": ["FAST_MATH"],
    "no_math": ["NO_MATH"],
    "no_io": ["NO_IO"],
    "no_hidden": ["NO_HIDDEN"],
    "no_dh": ["NO_DH"],
    "products_only": ["NO_BARRIER", "NO_DSMEM", "NO_MATH", "NO_IO"],
    "nothing": ["NO_BARRIER", "NO_DSMEM", "NO_MATH", "NO_IO", "NO_HIDDEN",
                "NO_DH"],
    "xproj_no_store": ["NO_XP_STORE"],
    "xproj_no_fma": ["NO_XP_FMA"],
    "one_pass": ["ONE_PASS"],
}

# (text in gru_wide.cuh, its replacement with the switches); each must
# occur exactly once, so an edit to the kernel that moves one fails loudly.
PATCHES = [
    ("  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));",
     "#ifdef ONE_PASS\n  lo = 0u;\n#else\n"
     "  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));\n"
     "#endif"),
    ("      if (owner != rank) dst = cl.map_shared_rank(dst, owner);",
     "#ifndef NO_DSMEM\n"
     "      if (owner != rank) dst = cl.map_shared_rank(dst, owner);\n"
     "#endif"),
    ('  asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");',
     "#ifdef NO_BARRIER\n  __syncthreads();\n#else\n"
     '  asm volatile("barrier.cluster.arrive.release;\\n" ::: "memory");\n'
     "#endif"),
    ('  asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");',
     "#ifndef NO_BARRIER\n"
     '  asm volatile("barrier.cluster.wait.acquire;\\n" ::: "memory");\n'
     "#endif"),
    ("  for (int k = k0; k < k1; k += 8) {",
     "#ifdef NO_HIDDEN\n  for (int k = k0; k < k0; k += 8) {\n#else\n"
     "  for (int k = k0; k < k1; k += 8) {\n#endif"),
    ("      for (int c = 0; c < 3 * U; c += 8) {",
     "#ifdef NO_DH\n      for (int c = 0; c < 0; c += 8) {\n#else\n"
     "      for (int c = 0; c < 3 * U; c += 8) {\n#endif"),
    ("""      const float rr = sigmoid_f(acc[0][h][q] + xr[e] + bhh[jl]);
      const float zz = sigmoid_f(acc[1][h][q] + xz[e] + bhh[U + jl]);
      const float hn = acc[2][h][q] + bhh[2 * U + jl];
      const float nn = tanhf(xn[e] + rr * hn);""",
     """      const float hn = acc[2][h][q] + bhh[2 * U + jl];
#if defined(NO_MATH)
      const float rr = acc[0][h][q] + xr[e] + bhh[jl];
      const float zz = acc[1][h][q] + xz[e] + bhh[U + jl];
      const float nn = xn[e] + rr * hn;
#elif defined(FAST_MATH)
      const float rr = 1.0f / (1.0f + __expf(-(acc[0][h][q] + xr[e] + bhh[jl])));
      const float zz = 1.0f / (1.0f + __expf(-(acc[1][h][q] + xz[e] + bhh[U + jl])));
      const float nn = 1.0f - 2.0f / (__expf(2.0f * (xn[e] + rr * hn)) + 1.0f);
#else
      const float rr = sigmoid_f(acc[0][h][q] + xr[e] + bhh[jl]);
      const float zz = sigmoid_f(acc[1][h][q] + xz[e] + bhh[U + jl]);
      const float nn = tanhf(xn[e] + rr * hn);
#endif"""),
    ("  auto load_step = [&](int t) {",
     "  auto load_step = [&](int t) {\n#ifdef NO_IO\n"
     "    for (int e = 0; e < 8; ++e) xr[e] = xz[e] = xn[e] = dt[e] = 0.0f;\n"
     "    if (t >= 0) return;\n#endif"),
    ("#pragma unroll\n    for (int e = 0; e < 8; e += 2) {\n"
     "      const int row = row0 + item_row(e), j = u0 + item_unit(e);\n"
     "      float* o = gh",
     "#pragma unroll\n#ifdef NO_IO\n    for (int e = 0; e < 0; e += 2) {\n"
     "#else\n    for (int e = 0; e < 8; e += 2) {\n#endif\n"
     "      const int row = row0 + item_row(e), j = u0 + item_unit(e);\n"
     "      float* o = gh"),
    ("    for (int np = 0; np < 4; ++np) {",
     "#ifdef NO_XP_FMA\n    for (int np = 0; np < 0; ++np) {\n#else\n"
     "    for (int np = 0; np < 4; ++np) {\n#endif"),
    ("        if (k >= K) continue;",
     "#ifdef NO_XP_STORE\n"
     "        if (k >= K || acc[mt][nt][0] != 1234.5f) continue;\n"
     "#else\n        if (k >= K) continue;\n#endif"),
]
SHAPES = (("scaled_heads", 40, 512, 30, 40), ("xl_heads", 128, 64, 30, 128))
H = 128


def build(out_dir: str, variants) -> None:
    from vae_connexe_torch.ops import _build

    os.makedirs(out_dir, exist_ok=True)
    csrc = str(_build.CSRC)
    with open(os.path.join(csrc, "gru_wide.cuh")) as f:
        wide = f.read()
    for old, new in PATCHES:
        if wide.count(old) != 1:
            raise RuntimeError(f"gru_wide.cuh no longer holds {old[:60]!r}")
        wide = wide.replace(old, new)
    wide = wide.replace('#include "gru_bwd.cuh"',
                        f'#include "{csrc}/gru_bwd.cuh"')
    with open(os.path.join(out_dir, "gru_wide.cuh"), "w") as f:
        f.write(wide)
    with open(os.path.join(csrc, "gru.cu")) as f:
        src = f.read()
    for name in ("gru_bwd.cuh", "gru_fwd.cuh"):
        src = src.replace(f'#include "{name}"', f'#include "{csrc}/{name}"')
    src = src.replace('#include "gru_wide.cuh"',
                      f'#include "{out_dir}/gru_wide.cuh"')
    with open(os.path.join(out_dir, "gru_probe.cu"), "w") as f:
        f.write(src)
    procs = {name: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, *[f"-D{d}" for d in defs],
         "-o", os.path.join(out_dir, f"lib_{name}.so"),
         os.path.join(out_dir, "gru_probe.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, defs in variants.items()}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out}")


def load(out_dir: str, names):
    """The probe builds ``names``, their entry points typed as the gru
    library's."""
    from vae_connexe_torch.ops import _build

    ref = _build.gru_library()
    libs = {}
    for name in names:
        lib = ctypes.CDLL(os.path.join(out_dir, f"lib_{name}.so"))
        for fn in ("vcx_gru_bwd_chain", "vcx_gru_xproj", "vcx_gru_forward",
                   "vcx_error_string"):
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
            getattr(lib, fn).restype = getattr(ref, fn).restype
        libs[name] = lib
    return libs


def control(out_dir: str) -> bool:
    """``--control``: the three-pass chain within ``WIDE_CHAIN_TOL`` of the
    plain chain, and the three-pass forward within ``OUT_TOL`` of the plain
    forward, and a one-pass build outside both, at every wide case of
    ``chip_smoke.py``."""
    import torch

    import chip_smoke
    from vae_connexe_torch.ops import cuda_gru

    names = ("base", "one_pass")
    build(out_dir, {n: VARIANTS[n] for n in names})
    libs = load(out_dir, names)
    dev = torch.device("cuda")
    limits = cuda_gru.device_limits(dev)
    tol = chip_smoke.WIDE_CHAIN_TOL
    sound = True
    for case in chip_smoke.wide_training_cases():
        what, heads, b, t, d, hid = case[:6]
        params, x, h0, douts = chip_smoke.training_inputs(dev, *case[1:])
        w = (params.w_ih, params.b_ih, params.w_hh, params.b_hh)
        h0 = h0.expand(heads, b, hid)
        outs = cuda_gru._forward_launch(*w, x, h0)
        ref = torch.cat([v.reshape(-1) for v in
                         cuda_gru.bwd_chain_plain(*w, x, h0, outs, douts)])
        ops, outs_c, douts_c = cuda_gru._bwd_operands(*w, x, h0, outs, douts,
                                                      "douts")
        (_, xc, xs, h0c, hs) = ops
        bt = cuda_gru.wide_chain_plan(b, heads, hid, limits)
        bt_f = cuda_gru.wide_fwd_plan(b, heads, hid, limits)
        ref_out = cuda_gru.fused_gru_scan_heads_plain(params, x, h0)[0]
        for name, lib in libs.items():
            k_out = torch.empty_like(ref_out)
            xp = torch.empty((heads, b, t, 3 * hid), device=dev)
            cuda_gru._launch(lib, "vcx_gru_forward", dev, (
                xc, *xs, *(v.contiguous() for v in (w[0], w[2], w[1], w[3])),
                h0c, *hs, k_out, xp, heads, b, t, d, hid, bt_f))
            torch.cuda.synchronize()
            err = (k_out - ref_out).abs().max().item()
            f_within = (bool(torch.isfinite(k_out).all())
                        and err <= chip_smoke.OUT_TOL)
            print(f"control {what} P={heads} B={b} T={t} D={d} H={hid} "
                  f"bt={bt_f}: {name} forward outs max_abs_err {err:.3e}, "
                  f"{err / chip_smoke.OUT_TOL:.4f} of OUT_TOL "
                  f"{chip_smoke.OUT_TOL} "
                  f"({'within' if f_within else 'outside'})", flush=True)
            sound &= f_within == (name == "base")
            gh, dh0 = cuda_gru._chain_buffers(ops)
            cuda_gru._launch(lib, "vcx_gru_bwd_chain", dev, (
                xc, *xs, *(v.contiguous() for v in (w[0], w[2], w[1], w[3])),
                h0c, *hs, outs_c, douts_c, gh, dh0, heads, b, t, d, hid, bt,
                1))
            torch.cuda.synchronize()
            got = torch.cat([gh.reshape(-1), dh0.reshape(-1)])
            diff = (got - ref).abs()
            share = (diff / (tol["atol"] + tol["rtol"] * ref.abs())).max()
            within = bool(torch.isfinite(got).all()) and share.item() <= 1.0
            grad = bool((diff <= 1e-4 + 1e-3 * ref.abs()).all())
            print(f"control {what} P={heads} B={b} T={t} D={d} H={hid} "
                  f"bt={bt}: {name} gh dh0 max_abs_err "
                  f"{diff.max().item():.3e} (|ref| <= "
                  f"{ref.abs().max().item():.3e}), worst share of "
                  f"WIDE_CHAIN_TOL {tol} {share.item():.4f} "
                  f"({'within' if within else 'outside'}); within GRAD_TOL "
                  f"{grad}", flush=True)
            sound &= within == (name == "base")
    print("control: " + ("the limits tell three passes from one" if sound
                         else "FAIL"), flush=True)
    return sound


def main() -> None:
    import torch

    from tools.torch_gru_bwd_tiles import time_ms
    from vae_connexe_torch.ops import _build, cuda_gru
    from vae_connexe_torch.ops.gru import init_stacked_gru

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out_dir = str(_build.BUILD_DIR / "probe_wide")
    if sys.argv[1:2] == ["--control"]:
        sys.exit(0 if control(out_dir) else 1)
    build(out_dir, VARIANTS)
    dev = torch.device("cuda")
    libs = load(out_dir, VARIANTS)
    for what, heads, b, t, d in SHAPES:
        g = torch.Generator().manual_seed(heads)
        prm = init_stacked_gru(g, heads, d, H, device="cpu")
        w_ih, b_ih, w_hh, b_hh = (v.to(dev) for v in
                                  (prm.w_ih, prm.b_ih, prm.w_hh, prm.b_hh))
        x = torch.randn((b, t, d), generator=g).to(dev)
        h0 = torch.randn((heads, b, H), generator=g).to(dev)
        outs = torch.randn((heads, b, t, H), generator=g).to(dev).tanh()
        douts = torch.randn((heads, b, t, H), generator=g).to(dev)
        gh = torch.empty((heads, b, t, 4 * H), device=dev)
        dh0 = torch.empty((heads, b, H), device=dev)
        bt = cuda_gru.wide_chain_plan(b, heads, H,
                                      cuda_gru.device_limits(dev))
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        p = lambda v: ctypes.c_void_p(v.data_ptr())   # noqa: E731
        head = (p(x), 0, x.stride(0), x.stride(1), p(w_ih), p(w_hh), p(b_ih),
                p(b_hh), p(h0), h0.stride(0), h0.stride(1))
        row, xrow = [], []
        for name, lib in libs.items():
            def chain():
                rc = lib.vcx_gru_bwd_chain(
                    *head, p(outs), p(douts), p(gh), p(dh0), heads, b, t, d,
                    H, bt, 1, stream)
                assert rc == 0, rc
            def proj():
                rc = lib.vcx_gru_xproj(p(x), 0, x.stride(0), x.stride(1),
                                       p(w_ih), p(b_ih), p(gh), heads, b, t,
                                       d, H, stream)
                assert rc == 0, rc
            row.append(f"{name} {time_ms(chain, 20):.4f}")
            xrow.append(f"{name} {time_ms(proj, 20):.4f}")
        print(f"probe {what} P={heads} B={b} T={t} D={d} H={H} plan "
              f"C={cuda_gru.WIDE_CLUSTER} bt={bt}: chain call by variant "
              "(ms): "
              + ", ".join(row) + "; projection alone by variant (ms): "
              + ", ".join(xrow), flush=True)


if __name__ == "__main__":
    main()
