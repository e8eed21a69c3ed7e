// Stacked-head GRU recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of vae_connexe_tpu/ops/pallas_gru.py:
//   gru_forward_kernel (on wide shapes gru_xproj_kernel<3> and
//   gru_forward_wide_kernel)
//                      <- _fused_recurrence / _fwd_kernel (pallas_gru.py:243, :199)
//   gru_chain_kernel, gru_wgrad_kernel, gru_dx_kernel (on wide shapes
//   gru_xproj_kernel<4> and gru_chain_wide_kernel for the chain)
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
// 128 at D = 40 or 128 on an H100), B1 and B2's chain run gru_wide.cuh's
// design: the input projection of every step as one product on the
// tensor cores first (B1: into a (P, B, T, 3H) scratch, as the TPU kernel
// fills its xp scratch), then the walk on clusters of 2 blocks that split
// W_hh's units, its products on the tensor cores in three TF32 passes.
// At lorenz96_scaled's decoder heads (P=40, B=512, T=30, D=40, H=128) the
// forward is 79.3 GFLOP (1.18 ms at the H100's 67 TFLOP/s of f32, 0.48 at
// the 165 TFLOP/s of a 3xTF32 product); the scratch adds 0.94 GB written
// once and read once (~0.56 ms at 3.35 TB/s), where the earlier design
// read W_ih^T from L2 at every step.  Measured there (NVIDIA H100 80GB
// HBM3, 700 W, tools/torch_gru_fwd_tiles.py --wide): 2.15 ms, the walk
// 1.60 and the projection 0.52, against the earlier design's 3.06.
// cuda_gru.recurrence_route picks the variant from the shapes and the
// card's limits before any launch.
//
// Backward, in two phases; only what the recurrence needs stays serial.
// Their bodies live in gru_bwd.cuh, shared with the phase-1 step (step.cu).
//   1. gru_chain_kernel, on the forward's grid, walks time in reverse and
//      keeps only the dh chain serial: it writes each step's gate gradients
//      [dbr, dz, da*r, da] to a (P, B, T, 4H) scratch and holds no dW sums:
//      103 KB at the decoder shape's tile of 20 rows, two blocks per SM, so
//      its 260 blocks run in one wave.  It is bound by the shared-memory
//      loads and multiply-adds of each step.
//      On wide shapes, gru_xproj_kernel then gru_chain_wide_kernel
//      (gru_wide.cuh): the input half of every step's gates is one parallel
//      product written into gh's first 3H columns before the walk, as the
//      TPU kernel fills its xp scratch, and the walk runs on clusters of 2
//      blocks that split W_hh's units, so that each block stages half of
//      it and holds a tile of 16-64 rows, its products on the tensor cores
//      (see below).
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
//
// The wide chain.  At lorenz96_scaled's decoder heads (P=40, B=512, T=30,
// D=40, H=128) the chain's work is the rematerialised gates (79.3 GFLOP)
// and d h_prev (60.4 GFLOP): 2.09 ms at the H100's 67 TFLOP/s of f32; its
// gh (1.26 GB) is written once, ~0.38 ms at 3.35 TB/s, which the walk
// overlaps.  The earlier wide chain was the hidden-64 body with W_ih^T
// moved to global memory: 8-row tiles (W_hh^T's 197 KB left no room for
// more), a weight load for every 2 rows, and W_ih x_t recomputed at every
// step from L2 inside the serial loop: 11.0 ms, 20 waves of 2560 blocks
// (NVIDIA H100 80GB HBM3, 700 W, tools/torch_gru_bwd_tiles.py).  The design
// here answers each of those: the projection leaves the walk (one parallel
// product); a cluster of 2 blocks splits W_hh by units, so a block stages
// 98 KB and holds 32 rows; and the products run on the tensor
// cores, three TF32 passes a float32 product, fed by ldmatrix, where the
// CUDA cores sat at ~55% of their rate on the loads that fed them.  The
// price is one cluster barrier a step and the partials of d h_prev sent
// through distributed shared memory (bt x U floats a block-step).  What
// remains (tools/torch_gru_wide_probe.py): the products, the gate math's
// transcendentals, gh's traffic, the barrier, the projection's stores.

#include "gru_bwd.cuh"
#include "gru_fwd.cuh"
#include "gru_wide.cuh"

namespace {

using vcx::GruArgs;
using vcx::i64;
using vcx::WgradArgs;

__global__ void __launch_bounds__(vcx::kFwdMaxThreads)
    gru_forward_kernel(GruArgs a) {
  vcx::gru_fwd_body(a);
}

// B1 on wide shapes (gru_wide.cuh): after the projection into xp, the walk
// on clusters of 2 blocks that split W_hh's units.  MAXT: the threads a
// block may have, which sets the registers a thread may take.
template <int MAXT>
__global__ void __cluster_dims__(vcx::kWideCluster, 1, 1)
    __launch_bounds__(MAXT, 1) gru_forward_wide_kernel(GruArgs a) {
  vcx::gru_fwd_wide_body(a);
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_chain_kernel(GruArgs a) {
  vcx::gru_chain_body<RPT, false>(a);
}

// The input projection (gru_wide.cuh) into rows of GW * H floats: B2's gh
// (GW = 4) or B1's xp (GW = 3).
template <int GW>
__global__ void __launch_bounds__(vcx::kXpThreads, 2)
    gru_xproj_kernel(GruArgs a) {
  vcx::gru_xproj_body<GW>(a);
}

// B2's chain on wide shapes (gru_wide.cuh): after the projection into gh,
// the reverse walk on clusters of 2 blocks that split W_hh's units; NJ =
// vcx::wide_dh_tiles(H).
template <int NJ>
__global__ void __cluster_dims__(vcx::kWideCluster, 1, 1)
    __launch_bounds__(vcx::kWideMaxThreads, 1)
    gru_chain_wide_kernel(GruArgs a) {
  vcx::gru_chain_wide_body<NJ>(a);
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

template <int GW>
cudaError_t launch_xproj(const GruArgs& a, cudaStream_t st) {
  const dim3 grid((unsigned)((a.B * a.T + vcx::kXpRows - 1) / vcx::kXpRows),
                  (unsigned)((3 * a.H + vcx::kXpCols - 1) / vcx::kXpCols),
                  (unsigned)a.P);
  gru_xproj_kernel<GW><<<grid, vcx::kXpThreads, 0, st>>>(a);
  return cudaGetLastError();
}

// The wide forward: the projection into xp = a.gh ((P, B, T, 3H) floats),
// then the walk on clusters of vcx::kWideCluster blocks over a.bt-row
// tiles (vcx::wide_tile_ok), at most vcx::kWideFwdMaxThreads threads.
cudaError_t launch_forward_wide(const GruArgs& a, cudaStream_t st) {
  const int threads = vcx::wide_threads(a.bt, a.H);
  if (a.P > 65535 || !vcx::wide_tile_ok(a.bt) ||
      threads > vcx::kWideFwdMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e = launch_xproj<3>(a, st);
  if (e != cudaSuccess) return e;
  auto kern = threads <= vcx::kWideMaxThreads
                  ? &gru_forward_wide_kernel<vcx::kWideMaxThreads>
                  : &gru_forward_wide_kernel<vcx::kWideFwdMaxThreads>;
  const size_t smem =
      (size_t)vcx::wide_fwd_smem_floats(a.bt, a.H) * sizeof(float);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(
      (unsigned)((a.B + a.bt - 1) / a.bt * vcx::kWideCluster), (unsigned)a.P);
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// B1 on tiles of a.bt rows: gru_forward_kernel (any multiple of 4 rows up
// to 32; threads vcx::fwd_tile_threads(bt, H)), or, when xp is not null,
// the wide forward with xp as its (P, B, T, 3H) scratch.
cudaError_t launch_forward(GruArgs a, float* xp, cudaStream_t st) {
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1)
    return cudaErrorInvalidValue;
  if (xp != nullptr) {
    a.gh = xp;
    return launch_forward_wide(a, st);
  }
  const int threads = vcx::fwd_tile_threads(a.bt, a.H);
  if (a.bt < 4 || a.bt > 32 || a.bt % 4 != 0 ||
      threads > vcx::kFwdMaxThreads)
    return cudaErrorInvalidValue;
  const size_t smem =
      (size_t)vcx::fwd_tile_smem_floats(a.bt, a.D, a.H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      gru_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  gru_forward_kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The wide chain: the projection into gh, then the walk on clusters of
// vcx::kWideCluster blocks over a.bt-row tiles (vcx::wide_tile_ok).
cudaError_t launch_chain_wide(const GruArgs& a, cudaStream_t st) {
  if (a.P < 1 || a.P > 65535 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 ||
      !vcx::wide_tile_ok(a.bt) ||
      vcx::wide_threads(a.bt, a.H) > vcx::kWideMaxThreads)
    return cudaErrorInvalidValue;
  cudaError_t e = launch_xproj<4>(a, st);
  if (e != cudaSuccess) return e;
  auto kern = vcx::wide_dh_tiles(a.H) == 4 ? &gru_chain_wide_kernel<4>
                                           : &gru_chain_wide_kernel<2>;
  const size_t smem = (size_t)vcx::wide_smem_floats(a.bt, a.H) * sizeof(float);
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(
      (unsigned)((a.B + a.bt - 1) / a.bt * vcx::kWideCluster), (unsigned)a.P);
  kern<<<grid, vcx::wide_threads(a.bt, a.H), smem, st>>>(a);
  return cudaGetLastError();
}

// The chain on a.bt-row tiles: gru_chain_kernel (tiles as vcx::launch_chain),
// or if `wide` the wide chain.
cudaError_t launch_chain_any(const GruArgs& a, int wide, cudaStream_t st) {
  if (!wide) return vcx::launch_chain(kChainKernels, a, st);
  return launch_chain_wide(a, st);
}

}  // namespace

extern "C" {

// Forward: outs (P, B, T, H) from x, the stacked weights and h0.  xp:
// null, or the (P, B, T, 3H) scratch of the wide forward (launch_forward).
int vcx_gru_forward(const float* x, i64 sxp, i64 sxb, i64 sxt,
                    const float* w_ih, const float* w_hh, const float* b_ih,
                    const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                    float* outs, float* xp, int P, int B, int T, int D,
                    int H, int bt, void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b, outs,
            nullptr, nullptr, nullptr, P, B, T, D, H, bt};
  return (int)launch_forward(a, xp, static_cast<cudaStream_t>(stream));
}

// Backward phase 1: from the forward's inputs, outs and douts (P, B, T, H),
// writes the gate gradients gh (P, B, T, 4H) and dh0 (P, B, H); batch
// tiles of bt rows.  wide: 0 for gru_chain_kernel, 1 for the wide chain
// (launch_chain_any).
int vcx_gru_bwd_chain(const float* x, i64 sxp, i64 sxb, i64 sxt,
                      const float* w_ih, const float* w_hh, const float* b_ih,
                      const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                      const float* outs, const float* douts, float* gh,
                      float* dh0, int P, int B, int T, int D, int H, int bt,
                      int wide, void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b,
            const_cast<float*>(outs), douts, gh, dh0, P, B, T, D, H, bt};
  return (int)launch_chain_any(a, wide, static_cast<cudaStream_t>(stream));
}

// The wide chain's input projection alone: gh[..., :3H] = x W_ih^T + b_ih
// for every head, row and step (the other columns untouched).
int vcx_gru_xproj(const float* x, i64 sxp, i64 sxb, i64 sxt,
                  const float* w_ih, const float* b_ih, float* gh, int P,
                  int B, int T, int D, int H, void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, nullptr, b_ih, nullptr, nullptr, 0, 0,
            nullptr, nullptr, gh, nullptr, P, B, T, D, H, 0};
  return (int)launch_xproj<4>(a, static_cast<cudaStream_t>(stream));
}

// The wide chain's block at a tile of bt rows and hidden H: out[0] =
// dynamic shared memory (bytes), out[1] = threads, out[2] = cluster size.
void vcx_wide_chain_block(int bt, int H, long long* out) {
  out[0] = vcx::wide_smem_floats(bt, H) * (long long)sizeof(float);
  out[1] = vcx::wide_threads(bt, H);
  out[2] = vcx::kWideCluster;
}

// The wide forward's block at a tile of bt rows and hidden H: out[0] =
// dynamic shared memory (bytes), out[1] = threads, out[2] = cluster size.
void vcx_wide_fwd_block(int bt, int H, long long* out) {
  out[0] = vcx::wide_fwd_smem_floats(bt, H) * (long long)sizeof(float);
  out[1] = vcx::wide_threads(bt, H);
  out[2] = vcx::kWideCluster;
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
                     float* dh0, float* dx, float* part, int P, int B, int T,
                     int D, int H, int bt, int wide, int splits, int chunk,
                     void* stream) {
  const int e = vcx_gru_bwd_chain(x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh,
                                  h0, sh0p, sh0b, outs, douts, gh, dh0, P, B,
                                  T, D, H, bt, wide, stream);
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
