// Stacked-head GRU recurrence for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU kernels of vae_connexe_tpu/ops/pallas_gru.py:
//   gru_forward_kernel  <- _fused_recurrence / _fwd_kernel (pallas_gru.py:243, :199)
//   gru_backward_kernel <- _fused_recurrence_bwd / _bwd_kernel (:426, :320)
//
// P independent GRU heads over T steps, input shared (B, T, D) or per head
// (P, B, T, D), initial state (P, B, H) read through its strides (a state
// broadcast from one (B, H) tensor has a head stride of 0).
//
// Design.  One block owns one (head, batch tile) pair for all T steps; the
// grid is (batch tiles, heads), and the time loop runs inside the block
// (gru_tile.cuh).  The head's W_ih^T and W_hh^T live in shared memory (63 KB
// at D=20, H=64), the input projection is computed per step from x inside
// the kernel as the TPU kernel does, so no (P, B, T, 3H) tensor reaches
// device memory.  The backward walks time in reverse on the same grid,
// rematerialises the gates from the forward's outputs, and accumulates
// dW/db for its (head, tile) in shared memory; each block writes one
// partial, and the wrapper sums the partials in a fixed order (no float
// atomics, so a step is deterministic).  With a shared input the per-head
// dx partials are summed by the wrapper too.
//
// Bound.  At the phase-1 decoder shape (P=20, B=256, T=10, D=20, H=64) the
// forward is 1.65e9 f32 flops against ~14 MB of output: bound by f32 FMA
// throughput (~0.025 ms on an H100 SXM).  The backward does about twice the
// forward's products.  This first version is held back by the sequential
// time loop of each block and by one block per SM in the backward (its
// accumulators take ~140 KB of shared memory); register-held accumulators
// and tensor-core products are the next steps.

#include "gru_tile.cuh"

namespace {

using vcx::i64;

struct GruArgs {
  const float* x;      // (B, T, D) or (P, B, T, D), strides below
  i64 sxp, sxb, sxt;   // sxp = 0 for a shared input
  const float* w_ih;   // (P, 3H, D)
  const float* w_hh;   // (P, 3H, H)
  const float* b_ih;   // (P, 3H)
  const float* b_hh;   // (P, 3H)
  const float* h0;     // (P, B, H) through strides sh0p, sh0b
  i64 sh0p, sh0b;
  float* outs;         // (P, B, T, H)
  // backward only
  const float* douts;  // (P, B, T, H)
  float* dx;           // (P, B, T, D) per-head partials, or nullptr
  float* dwih;         // (P, nbt, 3H, D) partials
  float* dwhh;         // (P, nbt, 3H, H)
  float* dbih;         // (P, nbt, 3H)
  float* dbhh;         // (P, nbt, 3H)
  float* dh0;          // (P, B, H)
  int P, B, T, D, H, bt;
};

__device__ inline void head_views(const GruArgs& a, int i, vcx::GruHead& w,
                                  vcx::GruInput& in, vcx::GruTile& tl) {
  const int G = 3 * a.H;
  w = {a.w_ih + (i64)i * G * a.D, a.w_hh + (i64)i * G * a.H,
       a.b_ih + (i64)i * G, a.b_hh + (i64)i * G, nullptr, a.D, a.H};
  in = {a.x + (i64)i * a.sxp, a.sxb, a.sxt, 0, 0};
  tl = {a.B, a.T, (int)blockIdx.x * a.bt, a.bt, a.h0 + (i64)i * a.sh0p,
        a.sh0b, a.outs + (i64)i * a.B * a.T * a.H};
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_forward_kernel(GruArgs a) {
  extern __shared__ float smem[];
  const int i = blockIdx.y;
  vcx::GruHead w;
  vcx::GruInput in;
  vcx::GruTile tl;
  head_views(a, i, w, in, tl);
  const vcx::GruSmem s = vcx::carve(smem, a.bt, a.D, a.H, false);
  vcx::gru_forward_tile<RPT>(w, in, tl, s, false);
}

template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads) gru_backward_kernel(GruArgs a) {
  extern __shared__ float smem[];
  const int i = blockIdx.y, tile = blockIdx.x, nbt = gridDim.x;
  const int G = 3 * a.H;
  vcx::GruHead w;
  vcx::GruInput in;
  vcx::GruTile tl;
  head_views(a, i, w, in, tl);
  const vcx::GruSmem s = vcx::carve(smem, a.bt, a.D, a.H, true);
  const i64 bth = (i64)a.B * a.T;
  vcx::GruBwdIO io{a.douts + (i64)i * bth * a.H, nullptr, nullptr, nullptr,
                   a.dx == nullptr ? nullptr : a.dx + (i64)i * bth * a.D,
                   a.dh0 + (i64)i * a.B * a.H};
  vcx::gru_backward_tile<RPT>(w, in, tl, s, io, false);
  __syncthreads();
  const i64 part = (i64)i * nbt + tile;
  vcx::store_block(a.dwih + part * G * a.D, s.dwih, G * a.D);
  vcx::store_block(a.dwhh + part * G * a.H, s.dwhh, G * a.H);
  vcx::store_block(a.dbih + part * G, s.dbih, G);
  vcx::store_block(a.dbhh + part * G, s.dbhh, G);
}

template <int RPT>
cudaError_t launch_rpt(bool backward, const GruArgs& a, cudaStream_t st) {
  void (*kern)(GruArgs) =
      backward ? &gru_backward_kernel<RPT> : &gru_forward_kernel<RPT>;
  const i64 floats = backward ? vcx::bwd_smem_floats(a.bt, a.D, a.H)
                              : vcx::fwd_smem_floats(a.bt, a.D, a.H);
  const size_t smem = (size_t)floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)((a.B + a.bt - 1) / a.bt), (unsigned)a.P);
  const int threads = a.H * (a.bt / RPT);
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

cudaError_t launch(bool backward, const GruArgs& a, void* stream) {
  if (a.P < 1 || a.B < 1 || a.T < 1 || a.D < 1 || a.H < 1 ||
      a.H * (a.bt < 4 ? a.bt : 4) > vcx::kMaxThreads)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (a.bt) {
    case 1: case 2: case 4: return launch_rpt<1>(backward, a, st);
    case 8: return launch_rpt<2>(backward, a, st);
    case 16: return launch_rpt<4>(backward, a, st);
    case 32: return launch_rpt<8>(backward, a, st);
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
            nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
            P, B, T, D, H, bt};
  return (int)launch(false, a, stream);
}

// Backward: from the forward's inputs and outs and douts (P, B, T, H),
// writes per-(head, tile) dW/db partials, dh0 (P, B, H) and, unless dx is
// null, per-head dx (P, B, T, D).
int vcx_gru_backward(const float* x, i64 sxp, i64 sxb, i64 sxt,
                     const float* w_ih, const float* w_hh, const float* b_ih,
                     const float* b_hh, const float* h0, i64 sh0p, i64 sh0b,
                     const float* outs, const float* douts, float* dx,
                     float* dwih, float* dwhh, float* dbih, float* dbhh,
                     float* dh0, int P, int B, int T, int D, int H, int bt,
                     void* stream) {
  GruArgs a{x, sxp, sxb, sxt, w_ih, w_hh, b_ih, b_hh, h0, sh0p, sh0b,
            const_cast<float*>(outs), douts, dx, dwih, dwhh, dbih, dbhh, dh0,
            P, B, T, D, H, bt};
  return (int)launch(true, a, stream);
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
