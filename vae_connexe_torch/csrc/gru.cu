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
// Forward.  One block owns one (head, batch tile) pair for all T steps; the
// grid is (batch tiles, heads), and the time loop runs inside the block
// (gru_tile.cuh).  The head's W_ih^T and W_hh^T live in shared memory (63 KB
// at D=20, H=64), the input projection is computed per step from x inside
// the kernel as the TPU kernel does, so no (P, B, T, 3H) tensor reaches
// device memory.
//
// Backward, in two phases; only what the recurrence needs stays serial.
// Their bodies live in gru_bwd.cuh, shared with the phase-1 step (step.cu).
//   1. gru_chain_kernel, on the forward's grid, walks time in reverse and
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

namespace {

using vcx::GruArgs;
using vcx::i64;
using vcx::WgradArgs;

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_forward_kernel(GruArgs a) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  vcx::GruHead w;
  vcx::GruInput in;
  vcx::GruTile tl;
  vcx::head_views<false>(a, i, w, in, tl);
  const vcx::GruSmem s = vcx::carve(smem, a.bt, a.D, a.H);
  vcx::gru_forward_tile<RPT>(w, in, tl, s, false);
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_chain_kernel(GruArgs a) {
  vcx::gru_chain_body<RPT, false>(a);
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

template <int RPT>
cudaError_t launch_forward_rpt(const GruArgs& a, cudaStream_t st) {
  if (a.bt % RPT != 0) return cudaErrorInvalidValue;
  void (*kern)(GruArgs) = &gru_forward_kernel<RPT>;
  const size_t smem = (size_t)vcx::fwd_smem_floats(a.bt, a.D, a.H) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  const int threads = a.H * (a.bt / RPT);
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

// Threads H * (bt / rpt), rpt = vcx::rows_per_thread(bt) rows a thread.
// The forward takes tiles 1, 2, 4, ..., 32; the chain also any multiple of
// 4 up to 32 (vcx::launch_chain).
cudaError_t launch_forward(const GruArgs& a, void* stream) {
  const int rpt = vcx::rows_per_thread(a.bt);
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 || a.bt < 1 ||
      a.bt > 32 || a.H * (a.bt / rpt) > vcx::kMaxThreads)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rpt) {
    case 1: return launch_forward_rpt<1>(a, st);
    case 2: return launch_forward_rpt<2>(a, st);
    case 4: return launch_forward_rpt<4>(a, st);
    case 8: return launch_forward_rpt<8>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Forward: outs (P, B, T, H) from x, the stacked weights and h0.
int vcx_gru_forward(const float* x, i64 sxp, i64 sxb, i64 sxt,
                    const float* w_ih, const float* w_hh, const float* b_ih,
                    const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                    float* outs, int P, int B, int T, int D, int H, int bt,
                    void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b, outs,
            nullptr, nullptr, nullptr, P, B, T, D, H, bt};
  return (int)launch_forward(a, stream);
}

// Backward phase 1: from the forward's inputs, outs and douts (P, B, T, H),
// writes the gate gradients gh (P, B, T, 4H) and dh0 (P, B, H); batch
// tiles of bt rows.
int vcx_gru_bwd_chain(const float* x, i64 sxp, i64 sxb, i64 sxt,
                      const float* w_ih, const float* w_hh, const float* b_ih,
                      const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                      const float* outs, const float* douts, float* gh,
                      float* dh0, int P, int B, int T, int D, int H, int bt,
                      void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b,
            const_cast<float*>(outs), douts, gh, dh0, P, B, T, D, H, bt};
  return (int)vcx::launch_chain(kChainKernels, a,
                               static_cast<cudaStream_t>(stream));
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
                     int D, int H, int bt, int splits, int chunk,
                     void* stream) {
  const int e = vcx_gru_bwd_chain(x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh,
                                  h0, sh0p, sh0b, outs, douts, gh, dh0, P, B,
                                  T, D, H, bt, stream);
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
