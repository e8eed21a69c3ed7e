// Whole-rollout generation kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU serving kernels of
// vae_connexe_tpu/ops/pallas_rollout.py:
//   crvae_free_run_*  <- _crvae_kernel  (pallas_rollout.py:117)
//   errvae_sample_*   <- _errvae_kernel (pallas_rollout.py:204)
//
// Both are one free-running GRU recurrence with a readout whose output is
// the next step's input:
//   P heads, each a GRU of width H over the shared input x (width D) and a
//   readout of O outputs per head; D = P * O.
//   CRVAE free run (K1): P = p heads, O = 1,
//                        x_{t+1} = concat_i(readout_i(h_i)) + s * noise[:, t].
//   ErrorVAE sample (K2): P = 1, O = D, x_0 = 0, no noise.
//
// Two routes, chosen by ops/cuda_rollout.py::rollout_route from the shapes
// and the card's limits before any launch:
//
// Resident (resident_body).  Every weight a block uses is staged in shared
// memory once, from the native (3H, D) / (3H, H) layouts, with
// gru_fwd.cuh's staging helpers and row stride; nothing is read from global
// memory inside the time loop but the noise, which cp.async brings in a
// step ahead.  A step's gates use B1's thread tile (gru_fwd.cuh: 4 rows x 2
// units x 3 gates a lane, the k of the D + H inputs split over two lanes
// that swap partials in a fixed order), so two calls give bitwise-equal
// outputs.  The readout follows the gates behind a barrier: each (column,
// row) is one thread's dot over H in a fixed order.
//   K2: one block owns a batch tile for all T steps; the new x goes to the
//   other of two x buffers and a second barrier ends the step.
//   K1: the P heads are coupled only through x, so they are spread over a
//   thread-block cluster of C blocks, block r holding a fixed group of
//   heads (P / C, the first P % C one more).  Each block keeps its heads'
//   state and all D columns of x; its readout stores its columns of
//   x_{t+1} into the next x buffer of every block of the cluster through
//   distributed shared memory, then arrives at a cluster barrier; it waits
//   on that barrier only before the input half of the next step's gate
//   product, so the barrier's latency hides behind the hidden half (W_hh
//   h, the block's own state: three quarters of the product at p=20,
//   H=64).  x is double-buffered, so that one barrier a step also orders
//   every peer's reads of x_t before anyone writes x_{t+2} into the same
//   buffer.  Clusters are
//   persistent: n_clusters (at most what the card holds at once) walk the
//   batch tiles cid, cid + n_clusters, ..., so the weights are staged once
//   per block for all of them.  A tile's last step waits on its barrier at
//   once, so no block starts the next tile's buffers, or exits, while a
//   peer may still write into its shared memory.
//
// Streamed (rollout_tile, the first port's body, for shapes whose weights
// do not fit a block: one head at hidden 128 with D = 40 is 269 KB).  One
// thread computes one (head, unit) pair for BT rows; weights stream from
// L2 every step in the (in, 3H) layout the wrapper transposes them into.
//
// Bound.  At the serving shape (p=20, H=64, B=3072, T=21) K1 is ~4.2e10
// f32 flops against ~13 MB of input and output: bound by f32 FMA
// throughput (0.62 ms on an H100 SXM); the streamed body was instead held
// back by re-reading 1.3 MB of weights from L2 per tile and step.  On the
// resident route the arithmetic is the limit, on the busiest block of a
// cluster (3 heads of 20 on 7 blocks).  At B=1 neither bound applies: the
// 21-step dependency chain (a gate product, a readout, a barrier a step)
// sets the time.
//
// Storage type.  Every kernel is instantiated for float32 weights and for
// bfloat16 weights (W = __nv_bfloat16, bf16 serving: JAX's _free_run and
// ErrorVAE.sample with dtype=bfloat16).  In bf16 the weights, biases and
// readout stay bf16 in memory (the resident route stages them as bf16 in
// shared memory, rows at res_weight_stride: half the bytes, so a head at
// hidden 128 fits a block), the products are accumulated and the gate math
// done in float32, and each step's new state and emitted x are rounded to
// the nearest bf16 (carry<W>), as JAX's bf16 carries are; x0, h0 and the
// noise arrive as float32 holding bf16 values, and the output is float32.
// The float32 instantiation is the code before bf16 existed (carry<float>
// is the identity).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include "gru_fwd.cuh"

namespace cg = cooperative_groups;

namespace {

using vcx::i64;
using vcx::sigmoid_f;
using bf16 = __nv_bfloat16;

// ---- Storage type ------------------------------------------------------------

// A weight as float32.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

// A weight through the read-only cache, as float32.
template <typename W>
__device__ __forceinline__ float ldg_f(const W* p) { return to_f(__ldg(p)); }

// A carry (new state, emitted x) as it is stored: unchanged in float32,
// rounded to the nearest bf16 in bf16.
template <typename W>
__device__ __forceinline__ float carry(float v) {
  if constexpr (sizeof(W) == 2)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

// The weights of units j, j + 1 (j even) at p, as float32.
template <typename W>
__device__ __forceinline__ float2 ld2(const W* p) {
  if constexpr (sizeof(W) == 2)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  else
    return *reinterpret_cast<const float2*>(p);
}

// ---- Streamed route ----------------------------------------------------------

template <typename W>
struct RolloutArgs {
  const float* x0;      // (B, D), or nullptr for a zero start
  const float* h0;      // (B, H), every head's initial state
  const float* noise;   // (B, T, D), or nullptr for none
  const W* w_ih_t;      // (P, D, 3H), gates [r; z; n] along the last axis
  const W* w_hh_t;      // (P, H, 3H)
  const W* b_ih;        // (P, 3H)
  const W* b_hh;        // (P, 3H)
  const W* ro_w;        // (P, O, H)
  const W* ro_b;        // (P, O)
  float* out;           // (B, T, D)
  int B, T, P, H, O;
  float noise_scale;
};

// Threads per block: a tile of few rows gets many threads, so that a single
// stream spreads its p*H units over the SM; a wide tile keeps its
// accumulators (4 * BT a thread) in registers.
template <int BT>
constexpr int max_threads() { return BT <= 2 ? 1024 : 2048 / BT; }

template <int BT, typename W>
__device__ __forceinline__ void rollout_tile(const RolloutArgs<W>& a) {
  extern __shared__ float smem[];
  const int P = a.P, H = a.H, O = a.O, D = P * O, G = 3 * H;
  const int head_stride = BT * H;           // floats per head in a buffer
  float* h_cur = smem;                      // [P][BT][H]
  float* h_next = smem + P * head_stride;   // [P][BT][H]
  float* x = smem + 2 * P * head_stride;    // [BT][D]
  const int row0 = blockIdx.x * BT;
  const int tid = threadIdx.x, nth = blockDim.x;

  // Every head starts from the same h0 row; rows past B stay zero.
  for (int e = tid; e < P * head_stride; e += nth) {
    const int k = e % H, row = row0 + (e / H) % BT;
    h_cur[e] = row < a.B ? a.h0[(size_t)row * H + k] : 0.0f;
  }
  for (int e = tid; e < BT * D; e += nth) {
    const int row = row0 + e / D;
    x[e] = (a.x0 != nullptr && row < a.B) ? a.x0[(size_t)row * D + e % D]
                                          : 0.0f;
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // Gates: one (head, unit) pair per thread, all BT rows at once.
    for (int u = tid; u < P * H; u += nth) {
      const int i = u / H, j = u % H;
      const W* wi = a.w_ih_t + (size_t)i * D * G;
      const W* wh = a.w_hh_t + (size_t)i * H * G;
      const float* hi = h_cur + i * head_stride;
      const W* bi = a.b_ih + (size_t)i * G;
      const W* bh = a.b_hh + (size_t)i * G;
      const float br = ldg_f(bi + j) + ldg_f(bh + j);
      const float bz = ldg_f(bi + H + j) + ldg_f(bh + H + j);
      const float bxn = ldg_f(bi + 2 * H + j), bhn = ldg_f(bh + 2 * H + j);
      float ar[BT], az[BT], axn[BT], ahn[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        ar[b] = br; az[b] = bz; axn[b] = bxn; ahn[b] = bhn;
      }
      // Unrolled so that several steps' weight loads are in flight at once:
      // each comes from L2, and one at a time would leave the SM waiting.
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const W* w = wi + (size_t)k * G + j;
        const float wr = ldg_f(w), wz = ldg_f(w + H), wn = ldg_f(w + 2 * H);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float v = x[b * D + k];
          ar[b] = fmaf(v, wr, ar[b]);
          az[b] = fmaf(v, wz, az[b]);
          axn[b] = fmaf(v, wn, axn[b]);
        }
      }
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const W* w = wh + (size_t)k * G + j;
        const float wr = ldg_f(w), wz = ldg_f(w + H), wn = ldg_f(w + 2 * H);
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float v = hi[b * H + k];
          ar[b] = fmaf(v, wr, ar[b]);
          az[b] = fmaf(v, wz, az[b]);
          ahn[b] = fmaf(v, wn, ahn[b]);
        }
      }
      float* hn = h_next + i * head_stride;
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        const float r = sigmoid_f(ar[b]);
        const float z = sigmoid_f(az[b]);
        const float n = tanhf(axn[b] + r * ahn[b]);
        hn[b * H + j] = carry<W>((1.0f - z) * n + z * hi[b * H + j]);
      }
    }
    __syncthreads();

    // Readout: x[b, i*O + o] = h_i[b] . ro_w[i, o] + ro_b[i, o] (+ noise).
    for (int e = tid; e < BT * D; e += nth) {
      const int b = e / D, c = e % D, i = c / O;
      const float* hv = h_next + i * head_stride + b * H;
      const W* w = a.ro_w + (size_t)c * H;       // (P, O, H) row i*O + o = c
      float acc = ldg_f(a.ro_b + c);
#pragma unroll 4
      for (int k = 0; k < H; ++k) acc = fmaf(hv[k], ldg_f(w + k), acc);
      const int row = row0 + b;
      if (row < a.B) {
        const size_t off = ((size_t)row * a.T + t) * D + c;
        if (a.noise != nullptr) acc += a.noise_scale * a.noise[off];
        acc = carry<W>(acc);
        a.out[off] = acc;
      }
      x[e] = acc;
    }
    __syncthreads();
    float* tmp = h_cur; h_cur = h_next; h_next = tmp;
  }
}

template <int BT, typename W>
__global__ void __launch_bounds__(max_threads<BT>())
crvae_free_run_kernel(RolloutArgs<W> a) { rollout_tile<BT, W>(a); }

template <int BT, typename W>
__global__ void __launch_bounds__(max_threads<BT>())
errvae_sample_kernel(RolloutArgs<W> a) { rollout_tile<BT, W>(a); }

template <int BT, typename W>
cudaError_t launch_tile(bool crvae, const RolloutArgs<W>& a, cudaStream_t s) {
  void (*kern)(RolloutArgs<W>) =
      crvae ? &crvae_free_run_kernel<BT, W> : &errvae_sample_kernel<BT, W>;
  const size_t smem =
      (2 * (size_t)a.P * BT * a.H + (size_t)BT * a.P * a.O) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int threads = (a.P * a.H + 31) / 32 * 32;
  if (threads > max_threads<BT>()) threads = max_threads<BT>();
  const unsigned grid = (unsigned)((a.B + BT - 1) / BT);
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename W>
cudaError_t launch(bool crvae, const RolloutArgs<W>& a, int bt, void* stream) {
  if (a.B < 1 || a.T < 1 || a.P < 1 || a.H < 1 || a.O < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 1: return launch_tile<1, W>(crvae, a, s);
    case 2: return launch_tile<2, W>(crvae, a, s);
    case 4: return launch_tile<4, W>(crvae, a, s);
    case 8: return launch_tile<8, W>(crvae, a, s);
    default: return cudaErrorInvalidValue;
  }
}

// ---- Resident route ----------------------------------------------------------

// Threads of a resident block: B1's register budget (128 a thread at 512),
// all of them staging the weights; the gate tiles take as many as their
// split gives them (gate_threads), the rest idle in the gate product.
constexpr int kResidentThreads = 512;

template <typename W>
struct ResidentArgs {
  const float* x0;      // (B, D), or nullptr for a zero start
  const float* h0;      // (B, H), every head's initial state
  const float* noise;   // (B, T, D), or nullptr for none
  const W* w_ih;        // (P, 3H, D), torch layout, rows [r; z; n]
  const W* w_hh;        // (P, 3H, H)
  const W* b_ih;        // (P, 3H)
  const W* b_hh;        // (P, 3H)
  const W* ro_w;        // (P, O, H)
  const W* ro_b;        // (P, O)
  float* out;           // (B, T, D)
  int B, T, P, H, O;
  int bt;               // rows of a batch tile, a multiple of 4
  int nh;               // heads of the fullest block: ceil(P / cluster)
  float noise_scale;
};

// Row stride of a staged readout row and of a head's state rows: U + 1
// (odd), so that the readout's lanes, which walk different heads or
// columns at the same k, meet in different banks.
__host__ __device__ inline int res_row_ld(int H) { return vcx::fwd_units(H) + 1; }

// Row stride (in weights) of the staged W^T rows: B1's in float32; in bf16
// 3 fwd_units(H) padded to 32 past a multiple of 64, so that rows k and
// k + 1, which the two lanes of a k split read, are 16 words apart mod 32
// and meet in disjoint banks, as B1's float rows do.
__host__ __device__ inline int res_weight_stride(int H, bool half) {
  if (!half) return vcx::fwd_weight_stride(H);
  const int g = 3 * vcx::fwd_units(H);
  return g + (96 - g % 64) % 64;
}

// Floats of one head's staged W_ih^T and W_hh^T (bf16 weights take half).
__host__ __device__ inline i64 res_weights_floats(int D, int H, bool half) {
  if (!half) return vcx::fwd_weights_floats(D, H, false);
  return ((i64)(D + H) * res_weight_stride(H, true) / 2 + 3) & ~3LL;
}

// Layout in shared memory (floats), every region 16-byte aligned:
//   w   [nh][res_weights_floats(D, H)]  W_ih^T then W_hh^T of each head,
//                                       rows at res_weight_stride(H), in
//                                       the weights' type
//   ro  [nh * O][res_row_ld(H)]         readout rows, zero past H
//   rob [nh * O]                        readout biases
//   x   [2][D][bt]                      the step's input, transposed
//   h   [2][nh][res_row_ld(H)][bt]      each head's state, transposed
//   nz  [2][nh * O][bt]                 a step's noise columns (if noise)
// x and h are read as float4s of 4 rows, as B1 reads them.
__host__ __device__ inline i64 resident_smem_floats(int nh, int bt, int D,
                                                    int H, int O,
                                                    bool noise, bool half) {
  return nh * res_weights_floats(D, H, half) +
         vcx::round4(nh * O * res_row_ld(H)) + vcx::round4(nh * O) +
         2LL * D * bt + 2LL * nh * res_row_ld(H) * bt +
         (noise ? 2LL * nh * O * bt : 0);
}

// Threads of the gate tiles of nh heads of bt rows, split S ways.
__host__ __device__ inline int gate_threads(int nh, int bt, int H, int S) {
  return vcx::fwd_units(H) / 2 * (nh * bt / 4) * S;
}

// Copy step t's noise columns [col0, col0 + ncols) of the tile's rows into
// dst [ncols][bt] (zeros past B); commits a group.
template <typename W>
__device__ inline void prefetch_noise(float* dst, const ResidentArgs<W>& a,
                                      int col0, int ncols, int row0, int t) {
  const int bt = a.bt, D = a.P * a.O;
  for (int e = threadIdx.x; e < ncols * bt; e += blockDim.x) {
    const int b = e % bt, c = e / bt, row = row0 + b;
    const bool ok = row < a.B;
    vcx::cp_async_f32(dst + e,
                      a.noise + ((i64)(ok ? row : 0) * a.T + t) * D + col0 + c,
                      ok);
  }
  vcx::cp_async_commit();
}

// B1's thread tile (gru_fwd.cuh fwd_thread_tile) with the k of a step split
// over S lanes (2 or 4): lane ks of tile t = threadIdx.x / S.  A warp's
// 32 / S tiles are 8 neighbouring unit pairs (at S = 2, of two row
// groups), so its weight loads are neighbouring float2s; at S = 2 this is
// fwd_thread_tile's mapping.
template <int S>
__device__ __forceinline__ void res_thread_tile(int U, int rows, int& ks,
                                                int& j, int& r0) {
  const int pairs = U / vcx::kFwdUnits, groups = rows / vcx::kFwdRows;
  const int t = threadIdx.x / S;
  int u, g;
  if (pairs % 8 == 0) {
    const int c = t / 8;
    u = (c / groups) * 8 + t % 8;
    g = c % groups;
  } else {
    u = t % pairs;
    g = t / pairs;
  }
  ks = threadIdx.x % S;
  j = vcx::kFwdUnits * u;
  r0 = vcx::kFwdRows * g;
}

// A lane's gate partials of one step: 4 rows x 2 units of r, z and the
// input and hidden parts of n, over its share (1 / S) of the k of x and h.
struct GateAcc {
  float r[vcx::kFwdRows][vcx::kFwdUnits], z[vcx::kFwdRows][vcx::kFwdUnits];
  float xn[vcx::kFwdRows][vcx::kFwdUnits], hn[vcx::kFwdRows][vcx::kFwdUnits];
};

// Add v[c] . W^T[c] for c = ks, ks + S, ... < n: v rows at vk + c * bt (the
// lane's 4 rows, a float4), the lane's 2 units of each gate at
// w + c * ld + j.  HIDDEN: the n gate's product goes to the hidden part.
template <bool HIDDEN, int S, typename W>
__device__ __forceinline__ void gate_product(GateAcc& a, const float* vk,
                                             const W* w, int n, int ks,
                                             int j, int U, int ld, int bt) {
#pragma unroll 4
  for (int c = ks; c < n; c += S) {
    const float4 v = *reinterpret_cast<const float4*>(vk + c * bt);
    const W* wp = w + c * ld + j;
    const float2 wr = ld2(wp);
    const float2 wz = ld2(wp + U);
    const float2 wn = ld2(wp + 2 * U);
    const float vr[vcx::kFwdRows] = {v.x, v.y, v.z, v.w};
    float(&an)[vcx::kFwdRows][vcx::kFwdUnits] = HIDDEN ? a.hn : a.xn;
#pragma unroll
    for (int r = 0; r < vcx::kFwdRows; ++r) {
      a.r[r][0] = fmaf(vr[r], wr.x, a.r[r][0]);
      a.r[r][1] = fmaf(vr[r], wr.y, a.r[r][1]);
      a.z[r][0] = fmaf(vr[r], wz.x, a.z[r][0]);
      a.z[r][1] = fmaf(vr[r], wz.y, a.z[r][1]);
      an[r][0] = fmaf(vr[r], wn.x, an[r][0]);
      an[r][1] = fmaf(vr[r], wn.y, an[r][1]);
    }
  }
}

// A lane finishes 8 / S rows of its tile (4 at S = 2, 2 at S = 4), from
// row gate_row(ks).
template <int S>
__device__ __forceinline__ int gate_row(int ks) {
  return S == 4 ? 2 * ((ks >> 1) & 1) : 0;
}

// Sum the S lanes' partials in a fixed order, halving what each lane keeps
// at every exchange: unit j + (ks & 1) (as fwd_pair_sum), then, at S = 4,
// two of the 4 rows; and finish the gates of the lane's unit and rows from
// h_prev (hp, 8 / S floats) into out, each new state a carry<W>.
template <int S, typename W>
__device__ __forceinline__ void gate_finish(const GateAcc& a, unsigned mask,
                                            int ks, const float* hp,
                                            float* out) {
  float s[vcx::kFwdRows][4];
#pragma unroll
  for (int r = 0; r < vcx::kFwdRows; ++r) {
    s[r][0] = vcx::fwd_pair_sum(mask, ks & 1, a.r[r][0], a.r[r][1]);
    s[r][1] = vcx::fwd_pair_sum(mask, ks & 1, a.z[r][0], a.z[r][1]);
    s[r][2] = vcx::fwd_pair_sum(mask, ks & 1, a.xn[r][0], a.xn[r][1]);
    s[r][3] = vcx::fwd_pair_sum(mask, ks & 1, a.hn[r][0], a.hn[r][1]);
  }
  if constexpr (S == 4) {   // keep rows 2 * hi, 2 * hi + 1
    const bool hi = ks & 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mine = hi ? s[2 + i][q] : s[i][q];
        const float other = hi ? s[i][q] : s[2 + i][q];
        s[i][q] = mine + __shfl_xor_sync(mask, other, 2);
      }
  }
  constexpr int R = 8 / S;
  float h[R], o[R];
  if constexpr (R == 4) {
    const float4 v = *reinterpret_cast<const float4*>(hp);
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(hp);
    h[0] = v.x; h[1] = v.y;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float rr = sigmoid_f(s[r][0]), zz = sigmoid_f(s[r][1]);
    const float nn = tanhf(s[r][2] + rr * s[r][3]);
    o[r] = carry<W>((1.0f - zz) * nn + zz * h[r]);
  }
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(out) = make_float4(o[0], o[1], o[2], o[3]);
  else
    *reinterpret_cast<float2*>(out) = make_float2(o[0], o[1]);
}

// Stage one head's weight (3H rows of `cols`) transposed into dst at row
// stride ld, zeros in the pad unit's columns: gru_fwd.cuh's staging in
// float32, the same layout element by element in bf16.
__device__ inline void stage_transposed(float* dst, const float* src, int H,
                                        int cols, int ld) {
  vcx::fwd_stage_transposed(dst, src, H, cols, ld);
}
__device__ inline void stage_transposed(bf16* dst, const bf16* src, int H,
                                        int cols, int ld) {
  const int G = 3 * H;
  for (int e = threadIdx.x; e < G * cols; e += blockDim.x) {
    const int g = e % G, c = e / G;
    dst[c * ld + vcx::fwd_weight_col(g, H)] = __ldg(src + (i64)g * cols + c);
  }
  if (H % 2)
    for (int e = threadIdx.x; e < 3 * cols; e += blockDim.x)
      dst[(e / 3) * ld + (e % 3) * (H + 1) + H] = __float2bfloat16_rn(0.0f);
}

// The two halves of a cluster barrier: arrive releases this thread's
// earlier writes (the readout's stores into the peers' shared memory);
// wait returns once every thread of the cluster has arrived and acquires
// their writes.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// One block (K2) or one block of a cluster (K1, CLUSTER) over its batch
// tiles, the k of a step split over S lanes, weights of type W;
// kResidentThreads threads, dynamic shared memory resident_smem_floats(a.nh,
// a.bt, P * O, a.H, a.O, noise buffers: K1, bf16 weights).
template <bool CLUSTER, int S, typename W>
__device__ void resident_body(const ResidentArgs<W>& a) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kHalf = sizeof(W) == 2;
  const int H = a.H, O = a.O, D = a.P * O, G = 3 * H, T = a.T, bt = a.bt;
  const int U = vcx::fwd_units(H), ld = res_weight_stride(H, kHalf);
  const int ldr = res_row_ld(H), hst = ldr * bt;
  const i64 wfl = res_weights_floats(D, H, kHalf);
  int rank = 0, size = 1, group = blockIdx.x, n_groups = gridDim.x;
  if constexpr (CLUSTER) {
    cg::cluster_group cl = cg::this_cluster();
    rank = (int)cl.block_rank();
    size = (int)cl.num_blocks();
    group = blockIdx.x / size;
    n_groups = gridDim.x / size;
  }
  // This block's heads: [head0, head0 + nh).
  const int head0 = rank * (a.P / size) + min(rank, a.P % size);
  const int nh = a.P / size + (rank < a.P % size ? 1 : 0);
  const int col0 = head0 * O, ncols = nh * O;
  float* w = smem;
  float* ro = w + a.nh * wfl;
  float* rob = ro + vcx::round4(a.nh * O * ldr);
  float* xs = rob + vcx::round4(a.nh * O);
  float* hs = xs + 2 * D * bt;
  float* nz = hs + 2 * a.nh * hst;
  const int xbuf = D * bt, hbuf = a.nh * hst, nbuf = a.nh * O * bt;

  for (int i = 0; i < nh; ++i) {
    W* wi = reinterpret_cast<W*>(w + i * wfl);
    stage_transposed(wi, a.w_ih + (i64)(head0 + i) * G * D, H, D, ld);
    stage_transposed(wi + D * ld, a.w_hh + (i64)(head0 + i) * G * H, H, H, ld);
  }
  for (int e = threadIdx.x; e < ncols * ldr; e += blockDim.x) {
    const int k = e % ldr, c = e / ldr;
    ro[e] = k < H ? to_f(a.ro_w[(i64)(col0 + c) * H + k]) : 0.0f;
  }
  for (int e = threadIdx.x; e < ncols; e += blockDim.x)
    rob[e] = to_f(a.ro_b[col0 + e]);

  // The thread tiles cover the block's heads taken as nh * bt rows: a
  // tile's 4 rows never straddle two heads (bt is a multiple of 4).
  int ks, j, r0;
  res_thread_tile<S>(U, a.nh * bt, ks, j, r0);
  const int hl = r0 / bt;
  r0 %= bt;
  const bool gate = threadIdx.x < gate_threads(a.nh, bt, H, S) && hl < nh;
  const unsigned mask = __ballot_sync(0xffffffffu, gate);
  float br[2], bz[2], bxn[2], bhn[2];
  {
    const int i = head0 + (gate ? hl : 0);
    const W* bih = a.b_ih + (i64)i * G;
    const W* bhh = a.b_hh + (i64)i * G;
    // Lane 0 of a split starts its partials from the biases, the others
    // from zero, so each sum holds them once.
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const bool on = gate && ks == 0 && j + u < H;
      br[u] = on ? to_f(bih[j + u]) + to_f(bhh[j + u]) : 0.0f;
      bz[u] = on ? to_f(bih[H + j + u]) + to_f(bhh[H + j + u]) : 0.0f;
      bxn[u] = on ? to_f(bih[2 * H + j + u]) : 0.0f;
      bhn[u] = on ? to_f(bhh[2 * H + j + u]) : 0.0f;
    }
  }
  const W* wx = reinterpret_cast<const W*>(w + (gate ? hl : 0) * wfl);
  const W* wh = wx + D * ld;
  const int hme = (gate ? hl : 0) * hst;   // this lane's head in a buffer
  // The state this lane finishes: unit j + (ks & 1), its rows.
  const int h_at = hme + (j + (ks & 1)) * bt + r0 + gate_row<S>(ks);

  const int n_tiles = (a.B + bt - 1) / bt;
  for (int tile = group; tile < n_tiles; tile += n_groups) {
    const int row0 = tile * bt;
    if (a.noise != nullptr) prefetch_noise(nz, a, col0, ncols, row0, 0);
    for (int e = threadIdx.x; e < nh * U * bt; e += blockDim.x) {
      const int b = e % bt, k = (e / bt) % U, h = e / (U * bt);
      const int row = row0 + b;
      hs[h * hst + k * bt + b] =
          row < a.B && k < H ? a.h0[(i64)row * H + k] : 0.0f;
    }
    for (int e = threadIdx.x; e < D * bt; e += blockDim.x) {
      const int b = e % bt, c = e / bt, row = row0 + b;
      xs[e] = a.x0 != nullptr && row < a.B ? a.x0[(i64)row * D + c] : 0.0f;
    }
    vcx::cp_async_wait_all();
    __syncthreads();

    // A step: the hidden half of the gate product (local state only); for
    // K1, the wait for the cluster barrier the last step's readout arrived
    // at (x_t is then in every block), so the barrier's latency hides
    // behind that half; the input half and the gate math; a block barrier;
    // the readout of x_{t+1} into every block, then (K1) arrive or (K2) a
    // block barrier.
    for (int t = 0, k = 0; t < T; ++t, k ^= 1) {
      GateAcc acc;
      if (gate) {
#pragma unroll
        for (int r = 0; r < vcx::kFwdRows; ++r)
#pragma unroll
          for (int u = 0; u < vcx::kFwdUnits; ++u) {
            acc.r[r][u] = br[u];
            acc.z[r][u] = bz[u];
            acc.xn[r][u] = bxn[u];
            acc.hn[r][u] = bhn[u];
          }
        gate_product<true, S>(acc, hs + k * hbuf + hme + r0, wh, H, ks, j, U,
                              ld, bt);
      }
      if constexpr (CLUSTER) {
        if (t > 0) cluster_wait();
      }
      // Behind the wait: the readout of step t - 1, the last reader of the
      // buffer this fills, is done in every thread.
      if (a.noise != nullptr && t + 1 < T)
        prefetch_noise(nz + (k ^ 1) * nbuf, a, col0, ncols, row0, t + 1);
      if (gate) {
        gate_product<false, S>(acc, xs + k * xbuf + r0, wx, D, ks, j, U, ld,
                               bt);
        gate_finish<S, W>(acc, mask, ks, hs + k * hbuf + h_at,
                          hs + (k ^ 1) * hbuf + h_at);
      }
      if (a.noise != nullptr) {   // this step's noise has landed
        if (t + 1 < T)
          vcx::cp_async_wait_one();
        else
          vcx::cp_async_wait_all();
      }
      __syncthreads();

      // Readout of this block's columns, (column, row) a thread, rows
      // fastest; four partial sums over k in a fixed order.
      for (int e = threadIdx.x; e < ncols * bt; e += blockDim.x) {
        const int b = e % bt, c = e / bt;
        const float* hv = hs + (k ^ 1) * hbuf + (c / O) * hst + b;
        const float* wv = ro + c * ldr;
        float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
        int q = 0;
#pragma unroll 4
        for (; q + 4 <= H; q += 4) {
          s0 = fmaf(hv[q * bt], wv[q], s0);
          s1 = fmaf(hv[(q + 1) * bt], wv[q + 1], s1);
          s2 = fmaf(hv[(q + 2) * bt], wv[q + 2], s2);
          s3 = fmaf(hv[(q + 3) * bt], wv[q + 3], s3);
        }
        for (; q < H; ++q) s0 = fmaf(hv[q * bt], wv[q], s0);
        float v = (s0 + s1) + (s2 + s3) + rob[c];
        if (a.noise != nullptr) v += a.noise_scale * nz[k * nbuf + e];
        v = carry<W>(v);
        const int row = row0 + b, col = col0 + c;
        if (row < a.B) a.out[((i64)row * T + t) * D + col] = v;
        float* dst = xs + (k ^ 1) * xbuf + col * bt + b;
        if constexpr (CLUSTER) {
          cg::cluster_group cl = cg::this_cluster();
          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = v;
        } else {
          *dst = v;
        }
      }
      if constexpr (CLUSTER) {
        cluster_arrive();
        // After the tile's last step, every peer's stores have landed and
        // its reads are done before this block starts the next tile's
        // buffers or exits.
        if (t + 1 == T) cluster_wait();
      } else {
        __syncthreads();
      }
    }
  }
}

template <int S, typename W>
__global__ void __launch_bounds__(kResidentThreads)
crvae_free_run_resident_kernel(ResidentArgs<W> a) {
  resident_body<true, S, W>(a);
}

template <int S, typename W>
__global__ void __launch_bounds__(kResidentThreads)
errvae_sample_resident_kernel(ResidentArgs<W> a) {
  resident_body<false, S, W>(a);
}

// The kernels at split 2 or 4 (resident_ok checks the split).
template <typename W>
using ResidentKernel = void (*)(ResidentArgs<W>);
template <typename W>
ResidentKernel<W> crvae_kernel(int split) {
  return split == 4 ? crvae_free_run_resident_kernel<4, W>
                    : crvae_free_run_resident_kernel<2, W>;
}
template <typename W>
ResidentKernel<W> errvae_kernel(int split) {
  return split == 4 ? errvae_sample_resident_kernel<4, W>
                    : errvae_sample_resident_kernel<2, W>;
}

// Whether a resident launch of these sizes is one the kernels take: bt a
// multiple of 4, a split of 2 or 4 whose gate tiles fit the block.
bool resident_ok(int B, int T, int H, int nh, int bt, int split) {
  return B >= 1 && T >= 1 && H >= 1 && bt >= 4 && bt % 4 == 0 &&
         (split == 2 || split == 4) &&
         gate_threads(nh, bt, H, split) <= kResidentThreads;
}

// Set K1's shared-memory limit (and, above 8 blocks, its non-portable
// cluster permission) and fill a launch configuration with the cluster
// dimension in attr.  K1's blocks always hold the noise buffers.
template <typename W>
cudaError_t cluster_config(ResidentKernel<W> kern, const ResidentArgs<W>& a,
                           int cluster, int n_clusters, cudaStream_t s,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const size_t smem = resident_smem_floats(a.nh, a.bt, a.P, a.H, 1, true,
                                           sizeof(W) == 2) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(n_clusters * cluster));
  cfg.blockDim = dim3(kResidentThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename W>
ResidentArgs<W> crvae_args(const float* x0, const float* h0,
                           const float* noise, const void* w_ih,
                           const void* w_hh, const void* b_ih,
                           const void* b_hh, const void* ro_w,
                           const void* ro_b, float* out, int B, int T, int P,
                           int H, float noise_scale, int cluster, int bt) {
  return ResidentArgs<W>{
      x0, h0, noise, static_cast<const W*>(w_ih), static_cast<const W*>(w_hh),
      static_cast<const W*>(b_ih), static_cast<const W*>(b_hh),
      static_cast<const W*>(ro_w), static_cast<const W*>(ro_b), out, B, T, P,
      H, 1, bt, (P + cluster - 1) / cluster, noise_scale};
}

template <typename W>
int crvae_streamed(const float* x0, const float* h0, const float* noise,
                   const void* w_ih_t, const void* w_hh_t, const void* b_ih,
                   const void* b_hh, const void* ro_w, const void* ro_b,
                   float* out, int B, int T, int P, int H, float noise_scale,
                   int bt, void* stream) {
  RolloutArgs<W> a{x0, h0, noise, static_cast<const W*>(w_ih_t),
                   static_cast<const W*>(w_hh_t), static_cast<const W*>(b_ih),
                   static_cast<const W*>(b_hh), static_cast<const W*>(ro_w),
                   static_cast<const W*>(ro_b), out, B, T, P, H, 1,
                   noise_scale};
  return (int)launch(true, a, bt, stream);
}

template <typename W>
int errvae_streamed(const float* h0, const void* w_ih_t, const void* w_hh_t,
                    const void* b_ih, const void* b_hh, const void* ro_w,
                    const void* ro_b, float* out, int B, int T, int D, int H,
                    int bt, void* stream) {
  RolloutArgs<W> a{nullptr, h0, nullptr, static_cast<const W*>(w_ih_t),
                   static_cast<const W*>(w_hh_t), static_cast<const W*>(b_ih),
                   static_cast<const W*>(b_hh), static_cast<const W*>(ro_w),
                   static_cast<const W*>(ro_b), out, B, T, 1, H, D, 0.0f};
  return (int)launch(false, a, bt, stream);
}

template <typename W>
int crvae_resident(const float* x0, const float* h0, const float* noise,
                   const void* w_ih, const void* w_hh, const void* b_ih,
                   const void* b_hh, const void* ro_w, const void* ro_b,
                   float* out, int B, int T, int P, int H, float noise_scale,
                   int cluster, int bt, int split, int n_clusters,
                   void* stream) {
  if (cluster < 1 || cluster > P || n_clusters < 1 ||
      !resident_ok(B, T, H, (P + cluster - 1) / cluster, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a =
      crvae_args<W>(x0, h0, noise, w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, out, B,
                    T, P, H, noise_scale, cluster, bt);
  const ResidentKernel<W> kern = crvae_kernel<W>(split);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kern, a, cluster, n_clusters,
                                 static_cast<cudaStream_t>(stream), cfg, attr);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <typename W>
int crvae_max_clusters(int P, int H, int cluster, int bt, int split,
                       int* out) {
  if (cluster < 1 || cluster > P ||
      !resident_ok(1, 1, H, (P + cluster - 1) / cluster, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a =
      crvae_args<W>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, 1, 1, P, H, 0.0f,
                    cluster, bt);
  const ResidentKernel<W> kern = crvae_kernel<W>(split);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = cluster_config(kern, a, cluster, 1, nullptr, cfg, attr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(out, kern, &cfg);
}

template <typename W>
int errvae_resident(const float* h0, const void* w_ih, const void* w_hh,
                    const void* b_ih, const void* b_hh, const void* ro_w,
                    const void* ro_b, float* out, int B, int T, int D, int H,
                    int bt, int split, void* stream) {
  if (D < 1 || !resident_ok(B, T, H, 1, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a{
      nullptr, h0, nullptr, static_cast<const W*>(w_ih),
      static_cast<const W*>(w_hh), static_cast<const W*>(b_ih),
      static_cast<const W*>(b_hh), static_cast<const W*>(ro_w),
      static_cast<const W*>(ro_b), out, B, T, 1, H, D, bt, 1, 0.0f};
  const ResidentKernel<W> kern = errvae_kernel<W>(split);
  const size_t smem =
      resident_smem_floats(1, bt, D, H, D, false, sizeof(W) == 2) *
      sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(B + bt - 1) / bt, kResidentThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point below has a twin with the suffix _bf16 that takes the
// weights (w_ih, w_hh, b_ih, b_hh, ro_w, ro_b) as bfloat16; x0, h0 and the
// noise are float32 either way (in bf16, holding bf16 values), and so is
// the output.

// CRVAE free run, streamed route.  x0 (B, D), h0 (B, H) shared by all
// heads, noise (B, T, D); weights in the (in, 3H) layout; readout w
// (P, 1, H), b (P, 1).  Writes out (B, T, D), D = P.  Returns a cudaError_t.
int vcx_crvae_free_run_streamed(const float* x0, const float* h0,
                                const float* noise, const void* w_ih_t,
                                const void* w_hh_t, const void* b_ih,
                                const void* b_hh, const void* ro_w,
                                const void* ro_b, float* out, int B, int T,
                                int P, int H, float noise_scale, int bt,
                                void* stream) {
  return crvae_streamed<float>(x0, h0, noise, w_ih_t, w_hh_t, b_ih, b_hh,
                               ro_w, ro_b, out, B, T, P, H, noise_scale, bt,
                               stream);
}
int vcx_crvae_free_run_streamed_bf16(const float* x0, const float* h0,
                                     const float* noise, const void* w_ih_t,
                                     const void* w_hh_t, const void* b_ih,
                                     const void* b_hh, const void* ro_w,
                                     const void* ro_b, float* out, int B,
                                     int T, int P, int H, float noise_scale,
                                     int bt, void* stream) {
  return crvae_streamed<bf16>(x0, h0, noise, w_ih_t, w_hh_t, b_ih, b_hh,
                              ro_w, ro_b, out, B, T, P, H, noise_scale, bt,
                              stream);
}

// ErrorVAE free run from x0 = 0, streamed route.  h0 (B, H); weights
// (1, D, 3H), (1, H, 3H), (1, 3H); readout w (D, H), b (D,).  Writes out
// (B, T, D).
int vcx_errvae_sample_streamed(const float* h0, const void* w_ih_t,
                               const void* w_hh_t, const void* b_ih,
                               const void* b_hh, const void* ro_w,
                               const void* ro_b, float* out, int B, int T,
                               int D, int H, int bt, void* stream) {
  return errvae_streamed<float>(h0, w_ih_t, w_hh_t, b_ih, b_hh, ro_w, ro_b,
                                out, B, T, D, H, bt, stream);
}
int vcx_errvae_sample_streamed_bf16(const float* h0, const void* w_ih_t,
                                    const void* w_hh_t, const void* b_ih,
                                    const void* b_hh, const void* ro_w,
                                    const void* ro_b, float* out, int B,
                                    int T, int D, int H, int bt,
                                    void* stream) {
  return errvae_streamed<bf16>(h0, w_ih_t, w_hh_t, b_ih, b_hh, ro_w, ro_b,
                               out, B, T, D, H, bt, stream);
}

// CRVAE free run, resident route: clusters of `cluster` blocks, tiles of bt
// rows, the k of a step split over `split` lanes, n_clusters persistent
// clusters.  Weights in torch's layout: w_ih (P, 3H, D), w_hh (P, 3H, H),
// b (P, 3H); readout w (P, 1, H), b (P, 1).
int vcx_crvae_free_run_resident(const float* x0, const float* h0,
                                const float* noise, const void* w_ih,
                                const void* w_hh, const void* b_ih,
                                const void* b_hh, const void* ro_w,
                                const void* ro_b, float* out, int B, int T,
                                int P, int H, float noise_scale, int cluster,
                                int bt, int split, int n_clusters,
                                void* stream) {
  return crvae_resident<float>(x0, h0, noise, w_ih, w_hh, b_ih, b_hh, ro_w,
                               ro_b, out, B, T, P, H, noise_scale, cluster,
                               bt, split, n_clusters, stream);
}
int vcx_crvae_free_run_resident_bf16(const float* x0, const float* h0,
                                     const float* noise, const void* w_ih,
                                     const void* w_hh, const void* b_ih,
                                     const void* b_hh, const void* ro_w,
                                     const void* ro_b, float* out, int B,
                                     int T, int P, int H, float noise_scale,
                                     int cluster, int bt, int split,
                                     int n_clusters, void* stream) {
  return crvae_resident<bf16>(x0, h0, noise, w_ih, w_hh, b_ih, b_hh, ro_w,
                              ro_b, out, B, T, P, H, noise_scale, cluster, bt,
                              split, n_clusters, stream);
}

// How many clusters of K1's resident kernel (bf16 weights if half) the card
// holds at once at these shapes (cudaOccupancyMaxActiveClusters), into *out.
int vcx_crvae_max_clusters(int P, int H, int cluster, int bt, int split,
                           int half, int* out) {
  return half ? crvae_max_clusters<bf16>(P, H, cluster, bt, split, out)
              : crvae_max_clusters<float>(P, H, cluster, bt, split, out);
}

// ErrorVAE free run from x0 = 0, resident route: one block a tile of bt
// rows, the k of a step split over `split` lanes.  Weights in torch's
// layout: w_ih (3H, D), w_hh (3H, H), b (3H); readout w (D, H), b (D,).
// Writes out (B, T, D).
int vcx_errvae_sample_resident(const float* h0, const void* w_ih,
                               const void* w_hh, const void* b_ih,
                               const void* b_hh, const void* ro_w,
                               const void* ro_b, float* out, int B, int T,
                               int D, int H, int bt, int split,
                               void* stream) {
  return errvae_resident<float>(h0, w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, out,
                                B, T, D, H, bt, split, stream);
}
int vcx_errvae_sample_resident_bf16(const float* h0, const void* w_ih,
                                    const void* w_hh, const void* b_ih,
                                    const void* b_hh, const void* ro_w,
                                    const void* ro_b, float* out, int B,
                                    int T, int D, int H, int bt, int split,
                                    void* stream) {
  return errvae_resident<bf16>(h0, w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, out,
                               B, T, D, H, bt, split, stream);
}

// Bytes of shared memory of a resident block of nh heads of O outputs
// each, tiles of bt rows, input width D, hidden H, bf16 weights if half
// (the wrapper holds its own sizing to this), and its threads, into out[2].
void vcx_resident_block(int nh, int bt, int D, int H, int O, int noise,
                        int half, long long* out) {
  out[0] = resident_smem_floats(nh, bt, D, H, O, noise != 0, half != 0) *
           sizeof(float);
  out[1] = kResidentThreads;
}

// The limits the routes are chosen by, into out[4]: opt-in shared memory
// of a block, shared memory of an SM, SMs, threads of an SM.
int vcx_device_limits(int device, int* out) {
  const cudaDeviceAttr attrs[4] = {
      cudaDevAttrMaxSharedMemoryPerBlockOptin,
      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
      cudaDevAttrMultiProcessorCount,
      cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int k = 0; k < 4; ++k) {
    cudaError_t e = cudaDeviceGetAttribute(out + k, attrs[k], device);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

const char* vcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
