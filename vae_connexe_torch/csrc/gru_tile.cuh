// One GRU head over one batch tile, forward: the block body shared by the
// recurrence kernels (gru.cu) and the phase-1 step (step.cu), with the
// staging helpers the backward chain (gru_bwd.cuh) reuses.
//
// A block owns one (head, batch tile) pair for every time step, with the
// time loop inside the block.  Heads never feed each other and batch rows
// never interact, so blocks need no synchronisation between them (the TPU
// kernels instead ran their tiles as a sequential grid and carried state
// from one grid step to the next in scratch).
//
// Layout in shared memory (floats):
//   wih [D][G1]  W_ih^T, G1 = 3H + 1: the pad makes both a walk along the
//                gate axis (32 units of a warp) and a walk along the input
//                axis (the backward chain's d h_prev) bank-conflict free.
//   whh [H][G1]  W_hh^T, same padding.
//   bih, bhh [3H]
//   h   [bt][H]  the current state.
//   x   [bt][D]  the step's input.
//
// Threads: blockDim.x = H * (bt / RPT).  Thread (j, rg) = (tid % H, tid / H)
// computes unit j of the RPT rows rg*RPT ... rg*RPT + RPT - 1, so each
// weight it reads from shared memory serves RPT rows.
//
// Gate math is torch nn.GRU's (r, z, n; the hidden bias of n inside the
// reset product), as vae_connexe_tpu/ops/gru.py and pallas_gru.py.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace vcx {

typedef long long i64;

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// One head's weights, torch layout.  mask: optional (D,) multiplier of the
// input columns (the parents mask of a CRVAE head), applied as W_ih is
// staged, so the kernel runs on the masked weights.
struct GruHead {
  const float* w_ih;   // (3H, D), rows [r; z; n]
  const float* w_hh;   // (3H, H)
  const float* b_ih;   // (3H)
  const float* b_hh;   // (3H)
  const float* mask;   // (D) or nullptr
  int D, H;
};

// The input of step t for tile row b (batch row row0 + b):
//   0 when zero_first and t == 0, or when the row is past B;
//   else x[row * sxb + (t + t_off) * sxt + d].
struct GruInput {
  const float* x;
  i64 sxb, sxt;
  int t_off, zero_first;
};

// The tile and where its states go.  h0 rows at h0 + row * sh0b (nullptr:
// zeros); outs is this head's (B, T, H) output, contiguous.
struct GruTile {
  int B, T, row0, bt;
  const float* h0;
  i64 sh0b;
  float* outs;
};

struct GruSmem {
  float *wih, *whh, *bih, *bhh, *h, *x;
};

// Floats of shared memory of a forward tile.
__host__ __device__ inline i64 fwd_smem_floats(int bt, int D, int H) {
  const i64 g1 = 3 * H + 1;
  return (i64)D * g1 + (i64)H * g1 + 6 * H + (i64)bt * H + (i64)bt * D;
}

// Carve the regions out of `base` (fwd_smem_floats).
__device__ inline GruSmem carve(float* base, int bt, int D, int H) {
  const int g1 = 3 * H + 1;
  GruSmem s;
  s.wih = base;
  s.whh = s.wih + D * g1;
  s.bih = s.whh + H * g1;
  s.bhh = s.bih + 3 * H;
  s.h = s.bhh + 3 * H;
  s.x = s.h + bt * H;
  return s;
}

// W (rows, cols) row-major -> dst[c * g1 + r], times mask[c] if given.
__device__ inline void stage_transposed(float* dst, const float* w, int rows,
                                        int cols, int g1,
                                        const float* mask) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
    const int r = e / cols, c = e % cols;
    float v = w[e];
    if (mask != nullptr) v *= mask[c];
    dst[c * g1 + r] = v;
  }
}

__device__ inline void stage_weights(const GruHead& w, const GruSmem& s) {
  const int G = 3 * w.H, g1 = G + 1;
  stage_transposed(s.wih, w.w_ih, G, w.D, g1, w.mask);
  stage_transposed(s.whh, w.w_hh, G, w.H, g1, nullptr);
  for (int e = threadIdx.x; e < G; e += blockDim.x) {
    s.bih[e] = w.b_ih[e];
    s.bhh[e] = w.b_hh[e];
  }
}

__device__ inline void stage_x(float* xs, const GruInput& in,
                               const GruTile& tl, int t, int D) {
  const bool zero = in.zero_first && t == 0;
  for (int e = threadIdx.x; e < tl.bt * D; e += blockDim.x) {
    const int b = e / D, d = e % D, row = tl.row0 + b;
    float v = 0.0f;
    if (!zero && row < tl.B)
      v = in.x[(i64)row * in.sxb + (i64)(t + in.t_off) * in.sxt + d];
    xs[e] = v;
  }
}

// The initial state of every tile row (zeros without h0 or past B).
__device__ inline void stage_h0(float* hs, const GruTile& tl, int H) {
  for (int e = threadIdx.x; e < tl.bt * H; e += blockDim.x) {
    const int b = e / H, k = e % H, row = tl.row0 + b;
    hs[e] = row < tl.B && tl.h0 != nullptr ? tl.h0[(i64)row * tl.sh0b + k]
                                           : 0.0f;
  }
}

// Pre-activations of unit j for the thread's RPT rows from the staged x and
// h: ar, az = input + hidden projections (both biases), axn = input
// projection of n (with b_in), ahn = hidden projection of n (with b_hn).
template <int RPT>
__device__ __forceinline__ void preacts(const GruSmem& s, int D, int H, int j,
                                        int r0, float* ar, float* az,
                                        float* axn, float* ahn) {
  const int g1 = 3 * H + 1;
  const float br = s.bih[j] + s.bhh[j];
  const float bz = s.bih[H + j] + s.bhh[H + j];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    ar[r] = br;
    az[r] = bz;
    axn[r] = s.bih[2 * H + j];
    ahn[r] = s.bhh[2 * H + j];
  }
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    const float* w = s.wih + k * g1 + j;
    const float wr = w[0], wz = w[H], wn = w[2 * H];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float v = s.x[(r0 + r) * D + k];
      ar[r] = fmaf(v, wr, ar[r]);
      az[r] = fmaf(v, wz, az[r]);
      axn[r] = fmaf(v, wn, axn[r]);
    }
  }
#pragma unroll 4
  for (int k = 0; k < H; ++k) {
    const float* w = s.whh + k * g1 + j;
    const float wr = w[0], wz = w[H], wn = w[2 * H];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float v = s.h[(r0 + r) * H + k];
      ar[r] = fmaf(v, wr, ar[r]);
      az[r] = fmaf(v, wz, az[r]);
      ahn[r] = fmaf(v, wn, ahn[r]);
    }
  }
}

// Forward over tl.T steps; writes every step's state to tl.outs (valid rows
// only).  Stages the weights unless `staged`.  On return s.h holds the last
// state of every tile row and all threads have passed a barrier.
template <int RPT>
__device__ void gru_forward_tile(const GruHead& w, const GruInput& in,
                                 const GruTile& tl, const GruSmem& s,
                                 bool staged) {
  const int H = w.H, D = w.D;
  const int j = threadIdx.x % H, r0 = (threadIdx.x / H) * RPT;
  if (!staged) stage_weights(w, s);
  stage_h0(s.h, tl, H);
  stage_x(s.x, in, tl, 0, D);
  __syncthreads();
  for (int t = 0; t < tl.T; ++t) {
    float ar[RPT], az[RPT], axn[RPT], ahn[RPT], hn[RPT];
    preacts<RPT>(s, D, H, j, r0, ar, az, axn, ahn);
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const float rr = sigmoid_f(ar[r]), zz = sigmoid_f(az[r]);
      const float nn = tanhf(axn[r] + rr * ahn[r]);
      hn[r] = (1.0f - zz) * nn + zz * s.h[(r0 + r) * H + j];
    }
    __syncthreads();                 // every read of s.h and s.x is done
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      s.h[(r0 + r) * H + j] = hn[r];
      const int row = tl.row0 + r0 + r;
      if (row < tl.B) tl.outs[((i64)row * tl.T + t) * H + j] = hn[r];
    }
    if (t + 1 < tl.T) stage_x(s.x, in, tl, t + 1, D);
    __syncthreads();
  }
}

// Deterministic block sum of one value per thread; every thread gets it.
// red: shared scratch of blockDim.x floats (blockDim.x a power of two or
// not: the tree folds the tail).
__device__ inline float block_sum(float v, float* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int n = blockDim.x; n > 1;) {
    const int half = (n + 1) / 2;
    if (tid < n - half) red[tid] += red[tid + half];
    __syncthreads();
    n = half;
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// Threads a block may have: 4 row groups of H <= 128 units.  The bound
// leaves a thread 128 registers, which the RPT = 8 accumulators need.
constexpr int kMaxThreads = 512;

// The RPT of a batch tile of bt rows (bt in 1, 2, 4, ..., 32): at most 4
// row groups, so a block has at most 4H threads.
__host__ __device__ inline int rows_per_thread(int bt) {
  return bt <= 4 ? 1 : bt / 4;
}

}  // namespace vcx
