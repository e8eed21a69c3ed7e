// The two phases of the stacked-head GRU backward, as device bodies and
// launch helpers shared by the recurrence kernels (gru.cu, B2) and the
// phase-1 step (step.cu, B3).  Each translation unit wraps the bodies in
// kernels of its own.
//
//   1. gru_chain_body, on a (batch tile, head) grid, walks time in reverse:
//      rematerialises the step's gates from h_prev (outs[t-1], or h0) and
//      x_t, writes the gate gradients gh[b, t] = [dbr, dz, da*r, da] (4H,
//      coalesced) to a (P, B, T, 4H) scratch, and carries
//      dh <- dh * z + [dbr, dz, da*r] @ W_hh.  It holds the weights, two
//      buffers of the step's h_prev, x and douts rows (the next step's are
//      copied in with cp.async while this one computes) and the step's gate
//      gradients, and no dW sums.
//   2. gru_wgrad_body, parallel over the B*T rows: per head
//      dW_hh = ghid^T h_prev and dW_ih = gx^T x (ghid = gh[:, :3H],
//      gx = [dbr, dz, da]) as register-tiled f32 products over K = B*T
//      (operand tiles copied to shared memory by cp.async, two stages),
//      with the bias sums on the side.  K is cut into `splits` fixed chunks
//      and each block writes one partial, which a later reader sums in a
//      fixed order.
// No float atomics: two calls on the same inputs give bitwise-equal
// results.
//
// Options for the phase-1 step, compiled in where the template argument OPT
// is true (step.cu) and out where it is false (gru.cu, whose kernels then
// compile as they did before the options existed): a W_ih column mask per
// head, applied as the weights are staged; an input view in which step t
// reads x at t + t_off, and a zero step at t = 0 when zero_first (teacher
// forcing); and a null h0 (zeros).

#pragma once

#include "gru_tile.cuh"

namespace vcx {

struct GruArgs {
  const float* x;      // (B, T, D) or (P, B, T, D), strides below
  i64 sxp, sxb, sxt;   // sxp = 0 for a shared input
  const float* w_ih;   // (P, 3H, D)
  const float* w_hh;   // (P, 3H, H)
  const float* b_ih;   // (P, 3H)
  const float* b_hh;   // (P, 3H)
  const float* h0;     // (P, B, H) through strides sh0p, sh0b, or nullptr
  i64 sh0p, sh0b;
  float* outs;         // (P, B, T, H)
  // backward chain only
  const float* douts;  // (P, B, T, H)
  float* gh;           // (P, B, T, 4H) gate gradients
  float* dh0;          // (P, B, H)
  int P, B, T, D, H, bt;
  // options (OPT): read only where compiled in
  const float* mask;   // (P, D) W_ih column mask, or nullptr
  int t_off, zero_first;
};

template <bool OPT>
__device__ inline void head_views(const GruArgs& a, int i, GruHead& w,
                                  GruInput& in, GruTile& tl) {
  const int G = 3 * a.H;
  const float* mask =
      OPT && a.mask != nullptr ? a.mask + (i64)i * a.D : nullptr;
  w = {a.w_ih + (i64)i * G * a.D, a.w_hh + (i64)i * G * a.H,
       a.b_ih + (i64)i * G, a.b_hh + (i64)i * G, mask, a.D, a.H};
  in = {a.x + (i64)i * a.sxp, a.sxb, a.sxt, OPT ? a.t_off : 0,
        OPT ? a.zero_first : 0};
  tl = {a.B, a.T, (int)blockIdx.x * a.bt, a.bt,
        !OPT || a.h0 != nullptr ? a.h0 + (i64)i * a.sh0p : nullptr, a.sh0b,
        a.outs + (i64)i * a.B * a.T * a.H};
}

// ---- Phase 1: the dh chain ---------------------------------------------------

// 4-byte asynchronous copy global -> shared; copies zeros unless `valid`.
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the last
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared memory of a chain block (floats), every region 16-byte aligned:
//   wih [round4(D)][g1], whh [round4(H)][g1]  W_ih^T, W_hh^T, g1 = 3H + 1
//       as in gru_tile.cuh; the pad rows and the pad column are zero
//   bih, bhh [3H]
//   h [2][bt][round4(H)], x [2][bt][round4(D)]  h_prev and x of a step,
//       two buffers, zero past H and D, read as float4s along k
//   ghid [bt][round4(3H)]  the step's [dbr, dz, da*r], zero past 3H
//   dout [2][bt][H]        douts rows of a step, two buffers
__host__ __device__ inline i64 chain_smem_floats(int bt, int D, int H) {
  const i64 g1 = 3 * H + 1, dp = round4(D), hp = round4(H);
  const i64 head = (dp + hp) * g1 + 6 * H;
  return ((head + 3) & ~3LL) + 2LL * bt * (hp + dp) + (i64)bt * round4(3 * H) +
         2LL * bt * H;
}

struct ChainSmem {
  GruSmem w;                       // wih, whh, bih, bhh
  float *h[2], *x[2], *dout[2], *ghid;
};

// Buffer k of a pair, by a select: indexing the pair with a run-time k
// would put the struct in local memory.
__device__ __forceinline__ float* pick(float* const (&p)[2], int k) {
  return k ? p[1] : p[0];
}

__device__ inline ChainSmem carve_chain(float* base, int bt, int D, int H) {
  const int g1 = 3 * H + 1, dp = round4(D), hp = round4(H);
  ChainSmem s;
  s.w.wih = base;
  s.w.whh = base + dp * g1;
  s.w.bih = s.w.whh + hp * g1;
  s.w.bhh = s.w.bih + 3 * H;
  s.w.h = s.w.x = nullptr;
  float* p = base + (((s.w.bhh + 3 * H - base) + 3) & ~(i64)3);
  s.h[0] = p;
  s.h[1] = p + bt * hp;
  s.x[0] = s.h[1] + bt * hp;
  s.x[1] = s.x[0] + bt * dp;
  s.ghid = s.x[1] + bt * dp;
  s.dout[0] = s.ghid + bt * round4(3 * H);
  s.dout[1] = s.dout[0] + bt * H;
  return s;
}

// Stage the weights (gru_tile.cuh) and zero every pad a float4 walk reads:
// the pad rows and column of W_ih^T and W_hh^T, the pad columns of both
// h and x buffers (cp.async never writes them) and of ghid.
__device__ inline void stage_chain(const GruHead& w, const ChainSmem& s,
                                   int bt) {
  const int D = w.D, H = w.H, G = 3 * H, g1 = G + 1;
  const int dp = round4(D), hp = round4(H), gs = round4(G);
  stage_weights(w, s.w);
  for (int e = threadIdx.x; e < (dp - D) * g1; e += blockDim.x)
    s.w.wih[D * g1 + e] = 0.0f;
  for (int e = threadIdx.x; e < (hp - H) * g1; e += blockDim.x)
    s.w.whh[H * g1 + e] = 0.0f;
  for (int k = threadIdx.x; k < dp + hp; k += blockDim.x)
    s.w.wih[k * g1 + G] = 0.0f;            // wih and whh are contiguous
  if (hp > H)
    for (int e = threadIdx.x; e < bt * hp; e += blockDim.x)
      if (e % hp >= H) s.h[0][e] = s.h[1][e] = 0.0f;
  if (dp > D)
    for (int e = threadIdx.x; e < bt * dp; e += blockDim.x)
      if (e % dp >= D) s.x[0][e] = s.x[1][e] = 0.0f;
  for (int e = threadIdx.x; e < bt * gs; e += blockDim.x) s.ghid[e] = 0.0f;
}

// Issue the copies of step t's h_prev, x and douts rows into buffer k.
// Rows past B, a null h0 and a zero first step are filled with zeros.
template <bool OPT>
__device__ inline void prefetch_step(const GruArgs& a, int i,
                                     const ChainSmem& s, int k, int t) {
  const int H = a.H, D = a.D, bt = a.bt, row0 = blockIdx.x * bt;
  const int hp = round4(H), dp = round4(D);
  const i64 bth = (i64)a.B * a.T;
  const float* outs = a.outs + i * bth * H;
  const float* douts = a.douts + i * bth * H;
  const float* h0 = a.h0 + i * a.sh0p;
  const float* x = a.x + i * a.sxp;
  const bool h_live = !OPT || t > 0 || a.h0 != nullptr;
  const bool x_live = !OPT || !(a.zero_first && t == 0);
  const int tx = OPT ? t + a.t_off : t;
  // Thread (c, g) = (tid % H, tid / H) copies unit c of rows g, g + groups...
  const int c = threadIdx.x % H, groups = blockDim.x / H;
  for (int b = threadIdx.x / H; b < bt; b += groups) {
    const int row = row0 + b;
    const bool ok = row < a.B;
    const i64 rt = (i64)(ok ? row : 0) * a.T + t;
    const float* hsrc = t > 0 ? outs + (rt - 1) * H + c
                              : h0 + (i64)(ok ? row : 0) * a.sh0b + c;
    cp_async_f32(pick(s.h, k) + b * hp + c, h_live ? hsrc : douts,
                 ok && h_live);
    cp_async_f32(pick(s.dout, k) + b * H + c, douts + rt * H + c, ok);
  }
  for (int e = threadIdx.x; e < bt * D; e += blockDim.x) {
    const int b = e / D, c = e % D, row = row0 + b;
    const bool ok = row < a.B && x_live;
    cp_async_f32(pick(s.x, k) + b * dp + c,
                 x + (i64)(ok ? row : 0) * a.sxb + (i64)tx * a.sxt + c, ok);
  }
  cp_async_commit();
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Pre-activations of unit j for the thread's RPT rows (as gru_tile.cuh's
// preacts), reading each row's x and h_prev as float4s: per 4 k, 12 weight
// loads and RPT row loads for 12 * RPT multiply-adds.
template <int RPT>
__device__ __forceinline__ void chain_preacts(const ChainSmem& s, int kx,
                                              const GruHead& w, int j, int r0,
                                              float* ar, float* az, float* axn,
                                              float* ahn) {
  const int H = w.H, g1 = 3 * H + 1, dp = round4(w.D), hp = round4(H);
  const float br = s.w.bih[j] + s.w.bhh[j];
  const float bz = s.w.bih[H + j] + s.w.bhh[H + j];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    ar[r] = br;
    az[r] = bz;
    axn[r] = s.w.bih[2 * H + j];
    ahn[r] = s.w.bhh[2 * H + j];
  }
  for (int k = 0; k < dp; k += 4) {
    float4 v[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      v[r] = *reinterpret_cast<const float4*>(pick(s.x, kx) + (r0 + r) * dp + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* wp = s.w.wih + (k + q) * g1 + j;
      const float wr = wp[0], wz = wp[H], wn = wp[2 * H];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float u = lane4(v[r], q);
        ar[r] = fmaf(u, wr, ar[r]);
        az[r] = fmaf(u, wz, az[r]);
        axn[r] = fmaf(u, wn, axn[r]);
      }
    }
  }
#pragma unroll 2
  for (int k = 0; k < hp; k += 4) {
    float4 v[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      v[r] = *reinterpret_cast<const float4*>(pick(s.h, kx) + (r0 + r) * hp + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float* wp = s.w.whh + (k + q) * g1 + j;
      const float wr = wp[0], wz = wp[H], wn = wp[2 * H];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float u = lane4(v[r], q);
        ar[r] = fmaf(u, wr, ar[r]);
        az[r] = fmaf(u, wz, az[r]);
        ahn[r] = fmaf(u, wn, ahn[r]);
      }
    }
  }
}

// Threads as gru_tile.cuh: thread (j, rg) = (tid % H, tid / H) owns unit j
// of rows rg*RPT ... rg*RPT + RPT - 1 and carries their dh in registers.
// Dynamic shared memory: chain_smem_floats(a.bt, a.D, a.H).
template <int RPT, bool OPT>
__device__ void gru_chain_body(const GruArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.y, H = a.H, D = a.D, G = 3 * H;
  const int gs = round4(G), hp = round4(H), g1 = G + 1;
  const int tid = threadIdx.x, j = tid % H, r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * a.bt;
  const ChainSmem s = carve_chain(smem, a.bt, D, H);
  GruHead w;
  GruInput in;
  GruTile tl;
  head_views<OPT>(a, i, w, in, tl);
  prefetch_step<OPT>(a, i, s, 0, a.T - 1);  // in flight while weights stage
  stage_chain(w, s, a.bt);
  cp_async_wait_all();
  __syncthreads();

  float* gh = a.gh + (i64)i * a.B * a.T * 4 * H;
  const float* wrow = s.w.whh + j * g1;  // W_hh[g][j] = whh[j * g1 + g]
  float dh[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh[r] = 0.0f;

  for (int t = a.T - 1, k = 0; t >= 0; --t, k ^= 1) {
    if (t > 0) prefetch_step<OPT>(a, i, s, k ^ 1, t - 1);
    float ar[RPT], az[RPT], axn[RPT], ahn[RPT];
    chain_preacts<RPT>(s, k, w, j, r0, ar, az, axn, ahn);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int b = r0 + r, row = row0 + b;
      const float d = dh[r] + pick(s.dout, k)[b * H + j];
      const float rr = sigmoid_f(ar[r]), zz = sigmoid_f(az[r]);
      const float nn = tanhf(axn[r] + rr * ahn[r]);
      const float hv = pick(s.h, k)[b * hp + j];
      const float dz = d * (hv - nn) * zz * (1.0f - zz);
      const float da = d * (1.0f - zz) * (1.0f - nn * nn);
      const float dbr = da * ahn[r] * rr * (1.0f - rr);
      const float dar = da * rr;
      s.ghid[b * gs + j] = dbr;
      s.ghid[b * gs + H + j] = dz;
      s.ghid[b * gs + 2 * H + j] = dar;
      if (row < a.B) {
        float* o = gh + ((i64)row * a.T + t) * 4 * H;
        o[j] = dbr;
        o[H + j] = dz;
        o[2 * H + j] = dar;
        o[3 * H + j] = da;
      }
      dh[r] = d * zz;
    }
    __syncthreads();
    // dh_prev = dh * z + ghid @ W_hh.  Past 3H the walk meets ghid's zero
    // pad and, in W_hh^T, the zeroed pad column and rows.
#pragma unroll 2
    for (int g = 0; g < gs; g += 4) {
      const float w0 = wrow[g], w1 = wrow[g + 1], w2 = wrow[g + 2],
                  w3 = wrow[g + 3];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const float4 q =
            *reinterpret_cast<const float4*>(s.ghid + (r0 + r) * gs + g);
        dh[r] = fmaf(q.x, w0, dh[r]);
        dh[r] = fmaf(q.y, w1, dh[r]);
        dh[r] = fmaf(q.z, w2, dh[r]);
        dh[r] = fmaf(q.w, w3, dh[r]);
      }
    }
    cp_async_wait_all();                 // the next step's rows have landed
    __syncthreads();                     // ... and every read of ghid is done
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    if (row < a.B) a.dh0[((i64)i * a.B + row) * H + j] = dh[r];
  }
}

typedef void (*ChainKernel)(GruArgs);

// Launch the chain on a.bt-row tiles: kernels[rpt - 1] is the kernel
// instantiated at rpt = rows_per_thread(a.bt) rows a thread.  Tiles: 1, 2
// or any multiple of 4 up to 32 (rpt 1 to 8), so that a tile can fit its
// grid in one wave.
inline cudaError_t launch_chain(const ChainKernel (&kernels)[8],
                                const GruArgs& a, cudaStream_t st) {
  const int rpt = rows_per_thread(a.bt);
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 || a.bt < 1 ||
      a.bt > 32 || a.bt % rpt != 0 || a.H * (a.bt / rpt) > kMaxThreads)
    return cudaErrorInvalidValue;
  const ChainKernel kern = kernels[rpt - 1];
  const size_t smem = (size_t)chain_smem_floats(a.bt, a.D, a.H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  kern<<<grid, a.H * (a.bt / rpt), smem, st>>>(a);
  return cudaGetLastError();
}

// ---- Phase 2: weight gradients -----------------------------------------------

struct WgradArgs {
  const float* gh;     // (P, B, T, 4H) from the chain
  const float* x;      // as GruArgs
  i64 sxp, sxb, sxt;
  const float* h0;     // (P, B, H) through strides sh0p, sh0b, or nullptr
  i64 sh0p, sh0b;
  const float* outs;   // (P, B, T, H)
  const float* w_ih;   // (P, 3H, D), for dx
  float* dx;           // (P, B, T, D) per head, or nullptr
  float* part;         // (P, splits, wgrad_part_floats) partials
  int P, B, T, D, H, splits, chunk;   // split s: rows [s*chunk, (s+1)*chunk)
  int t_off, zero_first;              // options (OPT), as GruArgs
};

// One (head, split) partial: dW_hh [3H][H], dW_ih [3H][D], db_hh [3H],
// db_ih [3H], in this order.
__host__ __device__ inline i64 wgrad_part_floats(int D, int H) {
  return 3LL * H * (H + D + 2);
}

// Block tile: 64 gate rows by BN columns, K staged 32 rows at a time;
// 128 threads as 8 x 16, each computing 8 gate rows by TN columns (per k,
// two float4 loads of A and one of Bm for 8 * TN multiply-adds).
constexpr int kWM = 64, kWK = 32, kWThreads = 128, kWTM = 8;

// One (head, split, tile) of  C[m][n] = sum_k A[k][m] Bm[k][n]  over the
// split's rows k = b*T + t.  job 0: A = ghid (gh columns 0..3H), Bm =
// h_prev (outs[k-1], or h0 at t=0), C = dW_hh, bias db_hh.  job 1: A = gx
// (gh columns [0, 2H) and [3H, 4H)), Bm = x, C = dW_ih, bias db_ih.  The
// blocks of the first column tile also sum A's columns (the bias), in
// order of k.
template <int BN, int TN, bool OPT>
__device__ void wgrad_tile(const WgradArgs& a, int i, int job, int mt,
                           int nt, int s, float* As, float* Bs) {
  const int H = a.H, T = a.T, G = 3 * H, N = job == 0 ? H : a.D;
  const int m0 = mt * kWM, n0 = nt * BN;
  const int tid = threadIdx.x, tr = tid / (BN / TN), tc = tid % (BN / TN);
  const int K = a.B * T, k_lo = s * a.chunk;
  const int k_hi = min(K, k_lo + a.chunk);
  const float* gh = a.gh + (i64)i * K * 4 * H;
  const float* outs = a.outs + (i64)i * K * H;
  const float* h0 = !OPT || a.h0 != nullptr ? a.h0 + (i64)i * a.sh0p : nullptr;
  const float* x = a.x + (i64)i * a.sxp;
  const bool bias = nt == 0 && tid < kWM;
  // Each thread copies NA elements of A and NB of Bm per K step, all in
  // one column (kWThreads is a multiple of kWM and BN): A rows tid/kWM +
  // RA*q, Bm rows tid/BN + RB*q.  Two stages in shared memory: the next
  // step's cp.async copies run while this one computes.
  constexpr int NA = kWK * kWM / kWThreads, NB = kWK * BN / kWThreads;
  constexpr int RA = kWThreads / kWM, RB = kWThreads / BN;
  constexpr int SA = kWK * kWM, SB = kWK * BN;   // floats of a stage
  const int gm = m0 + tid % kWM, gn = n0 + tid % BN;
  const bool a_ok = gm < G, b_ok = gn < N;
  const int gcol = job == 1 && gm >= 2 * H ? gm + H : gm;
  const float inv_t = 1.0f / (float)T;
  auto issue = [=](int st, int k0) {
#pragma unroll
    for (int q = 0; q < NA; ++q) {
      const int k = k0 + tid / kWM + RA * q;
      const bool ok = a_ok && k < k_hi;
      cp_async_f32(As + st * SA + tid + q * kWThreads,
                   gh + (ok ? (i64)k * 4 * H + gcol : 0), ok);
    }
    // Row k = b*T + t of the first Bm element by one division, the next
    // ones (RB rows apart) by stepping t.
    int k = k0 + tid / BN;
    int b = __float2int_rz(__int2float_rn(k) * inv_t), t = k - b * T;
    while (t < 0) --b, t += T;
    while (t >= T) ++b, t -= T;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      // The zero first step of x, or a null h0, adds nothing.
      const bool live = !OPT || (job == 1 ? !(a.zero_first && t == 0)
                                          : (t > 0 || h0 != nullptr));
      const bool ok = b_ok && k < k_hi && live;
      const int tx = OPT && job == 1 ? t + a.t_off : t;
      const float* src = job == 1 ? x + (i64)b * a.sxb + (i64)tx * a.sxt
                         : t > 0  ? outs + (i64)(k - 1) * H
                                  : h0 + (i64)b * a.sh0b;
      cp_async_f32(Bs + st * SB + tid + q * kWThreads, ok ? src + gn : gh,
                   ok);
      k += RB;
      for (t += RB; t >= T; t -= T) ++b;
    }
    cp_async_commit();
  };
  float acc[kWTM][TN] = {};
  float bsum = 0.0f;
  issue(0, k_lo);
  for (int k0 = k_lo, st = 0; k0 < k_hi; k0 += kWK, st ^= 1) {
    if (k0 + kWK < k_hi)
      issue(st ^ 1, k0 + kWK);
    else
      cp_async_commit();               // an empty group keeps the count
    cp_async_wait_one();               // this step's copies have landed
    __syncthreads();
    const float* as = As + st * SA;
    const float* bs = Bs + st * SB;
#pragma unroll 8
    for (int kk = 0; kk < kWK; ++kk) {
      const float* ap = as + kk * kWM + tr * kWTM;
      const float4 a0 = *reinterpret_cast<const float4*>(ap);
      const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
      float bv[TN];
      if constexpr (TN == 4) {
        const float4 q = *reinterpret_cast<const float4*>(bs + kk * BN + tc * 4);
        bv[0] = q.x, bv[1] = q.y, bv[2] = q.z, bv[3] = q.w;
      } else {
        const float2 q = *reinterpret_cast<const float2*>(bs + kk * BN + tc * 2);
        bv[0] = q.x, bv[1] = q.y;
      }
      const float am[kWTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int u = 0; u < kWTM; ++u)
#pragma unroll
        for (int v = 0; v < TN; ++v) acc[u][v] = fmaf(am[u], bv[v], acc[u][v]);
    }
    if (bias)
      for (int kk = 0; kk < kWK; ++kk) bsum += as[kk * kWM + tid];
    __syncthreads();                   // stage st is free for step + 2
  }
  float* part = a.part + ((i64)i * a.splits + s) * wgrad_part_floats(a.D, H);
  float* dw = job == 0 ? part : part + G * H;
#pragma unroll
  for (int u = 0; u < kWTM; ++u) {
    const int m = m0 + tr * kWTM + u;
#pragma unroll
    for (int v = 0; v < TN; ++v) {
      const int n = n0 + tc * TN + v;
      if (m < G && n < N) dw[(i64)m * N + n] = acc[u][v];
    }
  }
  if (bias && m0 + tid < G)
    part[G * (H + a.D) + job * G + m0 + tid] = bsum;
}

__host__ __device__ inline int wgrad_mtiles(int H) {
  return (3 * H + kWM - 1) / kWM;
}
__host__ __device__ inline int wgrad_hh_tiles(int H) {  // job 0, BN = 64
  return wgrad_mtiles(H) * ((H + 63) / 64);
}
__host__ __device__ inline int wgrad_ih_tiles(int H, int D) {  // job 1, BN = 32
  return wgrad_mtiles(H) * ((D + 31) / 32);
}

// Grid (tiles of both jobs, splits, heads), kWThreads threads.
template <bool OPT>
__device__ inline void gru_wgrad_body(const WgradArgs& a) {
  __shared__ __align__(16) float As[2 * kWK * kWM];
  __shared__ __align__(16) float Bs[2 * kWK * 64];
  const int mt = wgrad_mtiles(a.H), nhh = wgrad_hh_tiles(a.H);
  const int tile = blockIdx.x, s = blockIdx.y, i = blockIdx.z;
  if (tile < nhh)
    wgrad_tile<64, 4, OPT>(a, i, 0, tile % mt, tile / mt, s, As, Bs);
  else
    wgrad_tile<32, 2, OPT>(a, i, 1, (tile - nhh) % mt, (tile - nhh) / mt, s, As,
                      Bs);
}

inline cudaError_t launch_wgrad(void (*kern)(WgradArgs), const WgradArgs& a,
                                cudaStream_t st) {
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 || a.splits < 1 ||
      a.chunk < 1 || (i64)a.splits * a.chunk < (i64)a.B * a.T)
    return cudaErrorInvalidValue;
  const dim3 grid((unsigned)(wgrad_hh_tiles(a.H) + wgrad_ih_tiles(a.H, a.D)),
                  (unsigned)a.splits, (unsigned)a.P);
  kern<<<grid, kWThreads, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace vcx
