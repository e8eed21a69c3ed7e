// Stacked-head GRU recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of vae_connexe_tpu/ops/pallas_gru.py:
//   gru_forward_kernel <- _fused_recurrence / _fwd_kernel (pallas_gru.py:243, :199)
//   gru_chain_kernel, gru_wgrad_kernel, gru_dx_kernel
//                      <- _fused_recurrence_bwd / _bwd_kernel (:426, :320)
//
// P independent GRU heads over T steps, input shared (B, T, D) or per head
// (P, B, T, D), initial state (P, B, H) read through its strides (a state
// broadcast from one (B, H) tensor has a head stride of 0).
//
// Forward (gru_fwd.cuh).  One block owns one (head, batch tile) pair for all
// T steps; the grid is (batch tiles, heads), and the time loop runs inside
// the block.  The head's W_ih^T and W_hh^T live in shared memory (68 KB at
// D=20, H=64), the input projection is computed per step from x inside the
// kernel as the TPU kernel does, so no (P, B, T, 3H) tensor reaches device
// memory.  The work is f32 multiply-adds (1.65e9 flops at the decoder
// shape, ~0.025 ms of the card's f32 rate); what holds a step back is how
// fast the SMs issue them: each lane holds 4 rows x 2 units x 3 gates of
// accumulators, so that a warp issues 4 shared-memory wavefronts per k for
// 24 multiply-adds a lane, and the k of a step is split over two lanes,
// which doubles the warps that hide each other's load latency.  The next
// step's input rows come in by cp.async during the product, the state is
// double-buffered (one barrier a step) and the weights are staged with
// 16-byte loads.  The tile (cuda_gru.fwd_tile) balances the warps over the
// SMs: 20 rows on 20 heads, 260 blocks, two on every SM but four.  An odd
// H runs with one pad unit.
//
// Wide shapes.  Where the two weights do not fit a block together (hidden
// 128 at D = 40 or 128 on an H100), both B1 and B2's chain keep W_hh^T in
// shared memory and read W_ih^T from a copy in global memory, laid out as
// the staged rows by gru_wih_t_kernel at the start of the same call (a few
// MB; it stays in L2).  cuda_gru.recurrence_route picks the variant from
// the shapes and the card's limits before any launch.
//
// Backward, in two phases; only what the recurrence needs stays serial.
// Their bodies live in gru_bwd.cuh, shared with the phase-1 step (step.cu).
//   1. gru_chain_kernel (gru_chain_wide_kernel on wide shapes), on the
//      forward's grid, walks time in reverse and
//      keeps only the dh chain serial: it writes each step's gate gradients
//      [dbr, dz, da*r, da] to a (P, B, T, 4H) scratch and holds no dW sums:
//      103 KB at the decoder shape's tile of 20 rows, two blocks per SM, so
//      its 260 blocks run in one wave.  It is bound by the shared-memory
//      loads and multiply-adds of each step.
//   2. gru_wgrad_kernel, parallel over the B*T rows, forms dW and db as
//      register-tiled f32 products over fixed chunks of B*T; each block
//      writes one partial, and the wrapper sums the partials in a fixed
//      order.  gru_dx_kernel writes dx = gx @ W_ih per head when the input
//      needs a gradient.
// No float atomics: every sum runs in a fixed order and two calls on the
// same inputs give bitwise-equal gradients.
//
// Bound.  At the phase-1 decoder shape (P=20, B=256, T=10, D=20, H=64) the
// forward is 1.65e9 f32 flops against ~14 MB of output: bound by f32 FMA
// throughput (~0.025 ms on an H100 SXM).  The backward does the forward's
// products again (the gates are rematerialised), d h_prev and the two
// weight-gradient products: ~4.6e9 flops, ~0.07 ms; the gh scratch adds
// 52 MB written once and read once (~0.03 ms of HBM time, mostly served
// from the 50 MB L2).

#include "gru_bwd.cuh"
#include "gru_fwd.cuh"

namespace {

using vcx::GruArgs;
using vcx::i64;
using vcx::WgradArgs;

template <bool WIDE>
__global__ void __launch_bounds__(vcx::kFwdMaxThreads)
    gru_forward_kernel(GruArgs a, const float* wih_t) {
  vcx::gru_fwd_body<WIDE>(a, wih_t);
}

// W_ih^T for the wide kernels, which read it from global memory instead of
// staging it: dst[i][c][col] (rows x ld floats a head) = w_ih[i][g][c] for
// c < D and col = (g / H) * gs + g % H, zero everywhere else.
__global__ void gru_wih_t_kernel(const float* w_ih, float* dst, int P, int D,
                                 int H, int rows, int ld, int gs) {
  const i64 n = (i64)P * rows * ld;
  for (i64 e = blockIdx.x * (i64)blockDim.x + threadIdx.x; e < n;
       e += (i64)gridDim.x * blockDim.x) {
    const int col = (int)(e % ld), c = (int)(e / ld % rows);
    const i64 i = e / ((i64)ld * rows);
    const int gate = col / gs, u = col % gs;
    dst[e] = c < D && gate < 3 && u < H
                 ? w_ih[(i * 3 * H + gate * H + u) * D + c]
                 : 0.0f;
  }
}

cudaError_t launch_wih_t(const GruArgs& a, float* dst, int rows, int ld,
                         int gs, cudaStream_t st) {
  const i64 n = (i64)a.P * rows * ld;
  const int blocks = (int)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  gru_wih_t_kernel<<<blocks, 256, 0, st>>>(a.w_ih, dst, a.P, a.D, a.H, rows,
                                           ld, gs);
  return cudaGetLastError();
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_chain_kernel(GruArgs a) {
  vcx::gru_chain_body<RPT, false>(a);
}

// B2's chain for widths whose two weights do not fit a block (hidden 128 on
// an H100): W_hh^T stays in shared memory, W_ih^T is read from wih_t, a
// copy in global memory laid out as the staged one ([round4(D)][3H + 1] a
// head, zero pads; gru_wih_t_kernel), which gru_bwd.cuh's chain_preacts
// reads through the same pointer.  Otherwise gru_chain_body<RPT, false>
// step for step, so both give the same gate gradients.
__host__ __device__ inline i64 chain_wide_smem_floats(int bt, int D, int H) {
  return vcx::chain_smem_floats(bt, D, H) - (i64)vcx::round4(D) * (3 * H + 1);
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
    gru_chain_wide_kernel(GruArgs a, const float* wih_t) {
  using namespace vcx;
  extern __shared__ __align__(16) float smem[];
  const int i = blockIdx.y, H = a.H, D = a.D, G = 3 * H, bt = a.bt;
  const int gs = round4(G), hp = round4(H), dp = round4(D), g1 = G + 1;
  const int tid = threadIdx.x, j = tid % H, r0 = (tid / H) * RPT;
  const int row0 = blockIdx.x * bt;
  ChainSmem s;
  s.w.wih = const_cast<float*>(wih_t) + (i64)i * dp * g1;
  s.w.whh = smem;
  s.w.bih = smem + hp * g1;
  s.w.bhh = s.w.bih + G;
  s.w.h = s.w.x = nullptr;
  s.h[0] = smem + ((hp * g1 + 2 * G + 3) & ~3);
  s.h[1] = s.h[0] + bt * hp;
  s.x[0] = s.h[1] + bt * hp;
  s.x[1] = s.x[0] + bt * dp;
  s.ghid = s.x[1] + bt * dp;
  s.dout[0] = s.ghid + bt * gs;
  s.dout[1] = s.dout[0] + bt * H;
  GruHead w;
  GruInput in;
  GruTile tl;
  head_views<false>(a, i, w, in, tl);
  prefetch_step<false>(a, i, s, 0, a.T - 1);  // in flight while W_hh stages
  // stage_chain without W_ih^T: W_hh^T, the biases and every pad a float4
  // walk reads.
  stage_transposed(s.w.whh, w.w_hh, G, H, g1, nullptr);
  for (int e = tid; e < G; e += blockDim.x) {
    s.w.bih[e] = w.b_ih[e];
    s.w.bhh[e] = w.b_hh[e];
  }
  for (int e = tid; e < (hp - H) * g1; e += blockDim.x)
    s.w.whh[H * g1 + e] = 0.0f;
  for (int k = tid; k < hp; k += blockDim.x) s.w.whh[k * g1 + G] = 0.0f;
  if (hp > H)
    for (int e = tid; e < bt * hp; e += blockDim.x)
      if (e % hp >= H) s.h[0][e] = s.h[1][e] = 0.0f;
  if (dp > D)
    for (int e = tid; e < bt * dp; e += blockDim.x)
      if (e % dp >= D) s.x[0][e] = s.x[1][e] = 0.0f;
  for (int e = tid; e < bt * gs; e += blockDim.x) s.ghid[e] = 0.0f;
  cp_async_wait_all();
  __syncthreads();

  float* gh = a.gh + (i64)i * a.B * a.T * 4 * H;
  const float* wrow = s.w.whh + j * g1;  // W_hh[g][j] = whh[j * g1 + g]
  float dh[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) dh[r] = 0.0f;

  for (int t = a.T - 1, k = 0; t >= 0; --t, k ^= 1) {
    if (t > 0) prefetch_step<false>(a, i, s, k ^ 1, t - 1);
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
    cp_async_wait_all();
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = row0 + r0 + r;
    if (row < a.B) a.dh0[((i64)i * a.B + row) * H + j] = dh[r];
  }
}

__global__ void __launch_bounds__(vcx::kWThreads) gru_wgrad_kernel(WgradArgs a) {
  vcx::gru_wgrad_body<false>(a);
}

// dx[k][d] = sum_g gx[k][g] W_ih[g][d] for kDxRows rows k of one head;
// grid (row blocks, heads), W_ih of the head staged in shared memory.
constexpr int kDxRows = 32;

__global__ void __launch_bounds__(vcx::kWThreads) gru_dx_kernel(WgradArgs a) {
  extern __shared__ float wsm[];           // [3H][D]
  const int i = blockIdx.y, H = a.H, D = a.D, G = 3 * H, K = a.B * a.T;
  const float* w = a.w_ih + (i64)i * G * D;
  for (int e = threadIdx.x; e < G * D; e += blockDim.x) wsm[e] = w[e];
  __syncthreads();
  const float* gh = a.gh + (i64)i * K * 4 * H;
  float* dx = a.dx + (i64)i * K * D;
  const int k0 = blockIdx.x * kDxRows;
  for (int e = threadIdx.x; e < kDxRows * D; e += blockDim.x) {
    const int k = k0 + e / D, d = e % D;
    if (k >= K) break;
    const float* row = gh + (i64)k * 4 * H;
    float acc = 0.0f;
    for (int g = 0; g < 2 * H; ++g) acc = fmaf(row[g], wsm[g * D + d], acc);
    for (int g = 2 * H; g < G; ++g)
      acc = fmaf(row[g + H], wsm[g * D + d], acc);
    dx[(i64)k * D + d] = acc;
  }
}

// ---- Launches ---------------------------------------------------------------

const vcx::ChainKernel kChainKernels[8] = {
    &gru_chain_kernel<1>, &gru_chain_kernel<2>, &gru_chain_kernel<3>,
    &gru_chain_kernel<4>, &gru_chain_kernel<5>, &gru_chain_kernel<6>,
    &gru_chain_kernel<7>, &gru_chain_kernel<8>};

// Tiles: any multiple of 4 rows up to 32; threads vcx::fwd_tile_threads(bt,
// H).  wih_t: null, or room for (P, D, fwd_weight_stride(H)) floats, which
// selects the wide kernel (W_ih^T read from there, written first).
cudaError_t launch_forward(const GruArgs& a, float* wih_t, cudaStream_t st) {
  const int threads = vcx::fwd_tile_threads(a.bt, a.H);
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 || a.bt < 4 ||
      a.bt > 32 || a.bt % 4 != 0 || threads > vcx::kFwdMaxThreads)
    return cudaErrorInvalidValue;
  const bool wide = wih_t != nullptr;
  const int ld = vcx::fwd_weight_stride(a.H);
  if (wide) {
    cudaError_t e = launch_wih_t(a, wih_t, a.D, ld, vcx::fwd_units(a.H), st);
    if (e != cudaSuccess) return e;
  }
  auto kern = wide ? &gru_forward_kernel<true> : &gru_forward_kernel<false>;
  const size_t smem =
      (size_t)vcx::fwd_tile_smem_floats(a.bt, a.D, a.H, wide) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  kern<<<grid, threads, smem, st>>>(a, wih_t);
  return cudaGetLastError();
}

typedef void (*ChainWideKernel)(GruArgs, const float*);

const ChainWideKernel kChainWideKernels[8] = {
    &gru_chain_wide_kernel<1>, &gru_chain_wide_kernel<2>,
    &gru_chain_wide_kernel<3>, &gru_chain_wide_kernel<4>,
    &gru_chain_wide_kernel<5>, &gru_chain_wide_kernel<6>,
    &gru_chain_wide_kernel<7>, &gru_chain_wide_kernel<8>};

// The chain on a.bt-row tiles (tiles as vcx::launch_chain).  wih_t: null,
// or room for (P, round4(D), 3H + 1) floats, which selects the wide chain.
cudaError_t launch_chain_any(const GruArgs& a, float* wih_t,
                             cudaStream_t st) {
  if (wih_t == nullptr) return vcx::launch_chain(kChainKernels, a, st);
  const int rpt = vcx::rows_per_thread(a.bt);
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 || a.bt < 1 ||
      a.bt > 32 || a.bt % rpt != 0 || a.H * (a.bt / rpt) > vcx::kMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e =
      launch_wih_t(a, wih_t, vcx::round4(a.D), 3 * a.H + 1, a.H, st);
  if (e != cudaSuccess) return e;
  const ChainWideKernel kern = kChainWideKernels[rpt - 1];
  const size_t smem = (size_t)chain_wide_smem_floats(a.bt, a.D, a.H) *
                      sizeof(float);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  kern<<<grid, a.H * (a.bt / rpt), smem, st>>>(a, wih_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Forward: outs (P, B, T, H) from x, the stacked weights and h0.  wih_t:
// null, or scratch for the wide kernel (launch_forward).
int vcx_gru_forward(const float* x, i64 sxp, i64 sxb, i64 sxt,
                    const float* w_ih, const float* w_hh, const float* b_ih,
                    const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                    float* outs, float* wih_t, int P, int B, int T, int D,
                    int H, int bt, void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b, outs,
            nullptr, nullptr, nullptr, P, B, T, D, H, bt};
  return (int)launch_forward(a, wih_t, static_cast<cudaStream_t>(stream));
}

// Backward phase 1: from the forward's inputs, outs and douts (P, B, T, H),
// writes the gate gradients gh (P, B, T, 4H) and dh0 (P, B, H); batch
// tiles of bt rows.  wih_t: null, or scratch for the wide chain
// (launch_chain_any).
int vcx_gru_bwd_chain(const float* x, i64 sxp, i64 sxb, i64 sxt,
                      const float* w_ih, const float* w_hh, const float* b_ih,
                      const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                      const float* outs, const float* douts, float* gh,
                      float* dh0, float* wih_t, int P, int B, int T, int D,
                      int H, int bt, void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b,
            const_cast<float*>(outs), douts, gh, dh0, P, B, T, D, H, bt};
  return (int)launch_chain_any(a, wih_t, static_cast<cudaStream_t>(stream));
}

// Backward phase 2: from gh, x, h0 and outs, writes the per-(head, split)
// partials part (P, splits, 3H * (H + D + 2)) = [dW_hh, dW_ih, db_hh,
// db_ih] and, unless dx is null, per-head dx (P, B, T, D).
int vcx_gru_bwd_wgrad(const float* gh, const float* x, i64 sxp, i64 sxb,
                      i64 sxt, const float* h0, i64 sh0p, i64 sh0b,
                      const float* outs, const float* w_ih, float* dx,
                      float* part, int P, int B, int T, int D, int H,
                      int splits, int chunk, void* stream) {
  WgradArgs a{gh, x, sxp, sxb, sxt, h0, sh0p, sh0b, outs, w_ih, dx,
              part, P, B, T, D, H, splits, chunk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = vcx::launch_wgrad(&gru_wgrad_kernel, a, st);
  if (e != cudaSuccess || dx == nullptr) return (int)e;
  const size_t smem = (size_t)3 * H * D * sizeof(float);
  e = cudaFuncSetAttribute(gru_dx_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 dgrid((unsigned)((B * T + kDxRows - 1) / kDxRows), (unsigned)P);
  gru_dx_kernel<<<dgrid, vcx::kWThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// B2 whole: the chain, then the weight gradients, on one stream (one call
// from the wrapper instead of two).
int vcx_gru_backward(const float* x, i64 sxp, i64 sxb, i64 sxt,
                     const float* w_ih, const float* w_hh, const float* b_ih,
                     const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                     const float* outs, const float* douts, float* gh,
                     float* dh0, float* dx, float* part, float* wih_t, int P,
                     int B, int T, int D, int H, int bt, int splits,
                     int chunk, void* stream) {
  const int e = vcx_gru_bwd_chain(x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh,
                                  h0, sh0p, sh0b, outs, douts, gh, dh0, wih_t,
                                  P, B, T, D, H, bt, stream);
  if (e != 0) return e;
  return vcx_gru_bwd_wgrad(gh, x, sxp, sxb, sxt, h0, sh0p, sh0b, outs, w_ih,
                           dx, part, P, B, T, D, H, splits, chunk, stream);
}

// out[0..3]: the largest dynamic shared memory a block may opt in to, the
// shared memory of one SM, the SM count and the threads an SM holds.
// Returns a cudaError_t.
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
