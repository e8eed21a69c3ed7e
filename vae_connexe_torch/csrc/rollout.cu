// Whole-rollout generation kernels for Hopper (sm_90a), plain C interface.
//
// Replaces the two Pallas TPU serving kernels of
// vae_connexe_tpu/ops/pallas_rollout.py:
//   crvae_free_run_kernel  <- _crvae_kernel  (pallas_rollout.py:117)
//   errvae_sample_kernel   <- _errvae_kernel (pallas_rollout.py:204)
//
// Both are one free-running GRU recurrence with a readout whose output is
// the next step's input, so they share one block body, rollout_tile<BT>:
//   P heads, each a GRU of width H over the shared input x (width D) and a
//   readout of O outputs per head; D = P * O.
//   CRVAE free run: P = p heads, O = 1, x_{t+1} = concat_i(readout_i(h_i))
//                   + noise_scale * noise[:, t].
//   ErrorVAE sample: P = 1, O = D, x_0 = 0, no noise.
//
// Design.  Batch rows never interact, so one block owns a tile of BT rows
// for all heads and all T steps, with the time loop inside the block: no
// grid-wide synchronisation (the TPU kernel ran its batch tiles as a
// sequential grid instead).  Hidden states of all heads live in shared
// memory, double-buffered (every unit of a head reads the head's whole old
// row, so the new row goes to the other buffer behind a barrier); x is
// assembled in shared memory behind a second barrier.  One thread computes
// one (head, unit) pair for all BT rows, so each weight it loads serves BT
// rows; a narrow tile (a single stream) gets up to 1024 threads.
// Weights (1.3 MB at p=20, H=64) do not fit in shared memory: they
// stream from L2 every step, in the (in, 3H) layout so that the 32 units of
// a warp read 32 neighbouring floats.
//
// Bound.  At the serving shape (p=20, H=64, B=3072, T=21) K1 is ~4.2e10
// f32 flops against ~13 MB of input and output: bound by f32 FMA
// throughput (0.62 ms on an H100 SXM).  At B=1 the 21-step dependency
// chain bounds it instead.  This version is held back by the weights it
// re-reads from L2 once per tile and step, and by L2 latency: the k-loops
// are unrolled so that several loads are in flight, and a narrow tile gets
// more threads.  Weights split over a thread-block cluster are the next
// step.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

struct RolloutArgs {
  const float* x0;      // (B, D), or nullptr for a zero start
  const float* h0;      // (B, H), every head's initial state
  const float* noise;   // (B, T, D), or nullptr for none
  const float* w_ih_t;  // (P, D, 3H), gates [r; z; n] along the last axis
  const float* w_hh_t;  // (P, H, 3H)
  const float* b_ih;    // (P, 3H)
  const float* b_hh;    // (P, 3H)
  const float* ro_w;    // (P, O, H)
  const float* ro_b;    // (P, O)
  float* out;           // (B, T, D)
  int B, T, P, H, O;
  float noise_scale;
};

// Threads per block: a tile of few rows gets many threads, so that a single
// stream spreads its p*H units over the SM; a wide tile keeps its
// accumulators (4 * BT a thread) in registers.
template <int BT>
constexpr int max_threads() { return BT <= 2 ? 1024 : 2048 / BT; }

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int BT>
__device__ __forceinline__ void rollout_tile(const RolloutArgs& a) {
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
      const float* wi = a.w_ih_t + (size_t)i * D * G;
      const float* wh = a.w_hh_t + (size_t)i * H * G;
      const float* hi = h_cur + i * head_stride;
      const float* bi = a.b_ih + (size_t)i * G;
      const float* bh = a.b_hh + (size_t)i * G;
      const float br = __ldg(bi + j) + __ldg(bh + j);
      const float bz = __ldg(bi + H + j) + __ldg(bh + H + j);
      const float bxn = __ldg(bi + 2 * H + j), bhn = __ldg(bh + 2 * H + j);
      float ar[BT], az[BT], axn[BT], ahn[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) {
        ar[b] = br; az[b] = bz; axn[b] = bxn; ahn[b] = bhn;
      }
      // Unrolled so that several steps' weight loads are in flight at once:
      // each comes from L2, and one at a time would leave the SM waiting.
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float* w = wi + (size_t)k * G + j;
        const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
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
        const float* w = wh + (size_t)k * G + j;
        const float wr = __ldg(w), wz = __ldg(w + H), wn = __ldg(w + 2 * H);
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
        hn[b * H + j] = (1.0f - z) * n + z * hi[b * H + j];
      }
    }
    __syncthreads();

    // Readout: x[b, i*O + o] = h_i[b] . ro_w[i, o] + ro_b[i, o] (+ noise).
    for (int e = tid; e < BT * D; e += nth) {
      const int b = e / D, c = e % D, i = c / O;
      const float* hv = h_next + i * head_stride + b * H;
      const float* w = a.ro_w + (size_t)c * H;   // (P, O, H) row i*O + o = c
      float acc = __ldg(a.ro_b + c);
#pragma unroll 4
      for (int k = 0; k < H; ++k) acc = fmaf(hv[k], __ldg(w + k), acc);
      const int row = row0 + b;
      if (row < a.B) {
        const size_t off = ((size_t)row * a.T + t) * D + c;
        if (a.noise != nullptr) acc += a.noise_scale * a.noise[off];
        a.out[off] = acc;
      }
      x[e] = acc;
    }
    __syncthreads();
    float* tmp = h_cur; h_cur = h_next; h_next = tmp;
  }
}

template <int BT>
__global__ void __launch_bounds__(max_threads<BT>())
crvae_free_run_kernel(RolloutArgs a) { rollout_tile<BT>(a); }

template <int BT>
__global__ void __launch_bounds__(max_threads<BT>())
errvae_sample_kernel(RolloutArgs a) { rollout_tile<BT>(a); }

template <int BT>
cudaError_t launch_tile(bool crvae, const RolloutArgs& a, cudaStream_t s) {
  void (*kern)(RolloutArgs) =
      crvae ? &crvae_free_run_kernel<BT> : &errvae_sample_kernel<BT>;
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

cudaError_t launch(bool crvae, const RolloutArgs& a, int bt, void* stream) {
  if (a.B < 1 || a.T < 1 || a.P < 1 || a.H < 1 || a.O < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bt) {
    case 1: return launch_tile<1>(crvae, a, s);
    case 2: return launch_tile<2>(crvae, a, s);
    case 4: return launch_tile<4>(crvae, a, s);
    case 8: return launch_tile<8>(crvae, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// CRVAE free run.  x0 (B, D), h0 (B, H) shared by all heads, noise
// (B, T, D); weights in the (in, 3H) layout; readout w (P, 1, H), b (P, 1).
// Writes out (B, T, D), D = P.  Returns a cudaError_t.
int vcx_crvae_free_run(const float* x0, const float* h0, const float* noise,
                       const float* w_ih_t, const float* w_hh_t,
                       const float* b_ih, const float* b_hh,
                       const float* ro_w, const float* ro_b, float* out,
                       int B, int T, int P, int H, float noise_scale, int bt,
                       void* stream) {
  RolloutArgs a{x0, h0, noise, w_ih_t, w_hh_t, b_ih, b_hh, ro_w, ro_b, out,
                B, T, P, H, 1, noise_scale};
  return (int)launch(true, a, bt, stream);
}

// ErrorVAE free run from x0 = 0.  h0 (B, H); weights (1, D, 3H), (1, H, 3H),
// (1, 3H); readout w (D, H), b (D,).  Writes out (B, T, D).
int vcx_errvae_sample(const float* h0, const float* w_ih_t,
                      const float* w_hh_t, const float* b_ih,
                      const float* b_hh, const float* ro_w, const float* ro_b,
                      float* out, int B, int T, int D, int H, int bt,
                      void* stream) {
  RolloutArgs a{nullptr, h0, nullptr, w_ih_t, w_hh_t, b_ih, b_hh, ro_w, ro_b,
                out, B, T, 1, H, D, 0.0f};
  return (int)launch(false, a, bt, stream);
}

// Largest dynamic shared memory a block may opt in to on `device`, in
// bytes; negative on error.
int vcx_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

const char* vcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
