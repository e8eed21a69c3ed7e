// B1's block body: the forward of one GRU head over one batch tile, for all
// T steps, register-tiled for Hopper.  Launched by gru.cu's
// gru_forward_kernel only; the phase-1 step (step.cu) keeps gru_tile.cuh's
// body.
//
// A block owns one (head, batch tile) pair for every step, with the time
// loop inside the block, as gru_tile.cuh's body does.  What differs is how
// a step's product is fed from shared memory.
//
// Thread tile: 4 rows x 2 units x the 3 gates, with the k of the D + H
// inputs split over 2 neighbouring lanes (32 accumulators a lane: r, z,
// and the input and hidden parts of n).  Per k a lane loads one float4 of
// state (its 4 rows, k-major) and three float2s of weights (its 2 units of
// each gate) for 24 multiply-adds; the two lanes of a split then swap the
// partials of one unit each by a shuffle (in a fixed order: two calls give
// bitwise-equal outputs), and each finishes the gate math of one unit.
// The 16 (unit pair, row group) tiles of a warp are 8 pairs x 2 row
// groups, and the weights' row stride is 16 past a multiple of 32 floats,
// so a warp's loads meet no bank conflict: 4 wavefronts a warp per k for
// 24 multiply-adds a lane (gru_tile.cuh: 7 for 12).  The split doubles the
// warps an SM holds (20 at the decoder shape), which hides the latency of
// the loads that a lone warp waits on.
//
// Layout in shared memory (floats), every region 16-byte aligned:
//   w  [D + H][ld]   W_ih^T then W_hh^T, ld = fwd_weight_stride(H) >= 3U,
//                    U = fwd_units(H) (H rounded up to even: an odd width
//                    runs with a pad unit of zero weights); row k holds
//                    the gates r, z, n of every unit, so a lane's 2 units
//                    are one float2
//   x  [2][D][bt]    the step's input, transposed, two buffers: the next
//                    step's is copied in by cp.async during this one
//   h  [2][U][bt]    the state, transposed, two buffers: step t reads
//                    buffer t & 1 and writes buffer (t + 1) & 1
// so a step needs one barrier.  The weights are staged once per block with
// 16-byte global loads where a row's length allows it.
//
// Widths whose two weights do not fit a block together (hidden 128 with D
// = 40 or 128 on an H100: 269-410 KB) run gru_wide.cuh's forward instead.
//
// Gate math is torch nn.GRU's (r, z, n; the hidden bias of n inside the
// reset product), as gru_tile.cuh.

#pragma once

#include <stdint.h>

#include "gru_bwd.cuh"

namespace vcx {

// A thread's tile: 4 rows x 2 units, its k split over 2 lanes.
constexpr int kFwdRows = 4, kFwdUnits = 2, kFwdSplit = 2, kFwdMaxThreads = 512;

// Units the thread tiles cover: H, or H + 1 for an odd H.  The pad unit's
// weights and biases are zero and its state is never written out.
__host__ __device__ inline int fwd_units(int H) { return (H + 1) & ~1; }

// Row stride of the staged weights: 3 fwd_units(H) padded to 16 past a
// multiple of 32 floats, so the two lanes of a k split read rows k and
// k + 1 from disjoint banks.  Gate g of unit u sits at g * fwd_units(H) + u.
__host__ __device__ inline int fwd_weight_stride(int H) {
  const int g = 3 * fwd_units(H);
  return g + (48 - g % 32) % 32;
}

// Floats of the staged weights: W_ih^T and W_hh^T.
__host__ __device__ inline i64 fwd_weights_floats(int D, int H) {
  return ((i64)(D + H) * fwd_weight_stride(H) + 3) & ~3LL;
}

// Floats of shared memory of a block of bt rows (bt a multiple of 4).
__host__ __device__ inline i64 fwd_tile_smem_floats(int bt, int D, int H) {
  return fwd_weights_floats(D, H) + 2LL * bt * (D + fwd_units(H));
}

__host__ __device__ inline int fwd_tile_threads(int bt, int H) {
  return (fwd_units(H) / kFwdUnits) * (bt / kFwdRows) * kFwdSplit;
}

// Column of gate row g (of 3H) in a staged row of W^T.
__host__ __device__ __forceinline__ int fwd_weight_col(int g, int H) {
  return (g / H) * fwd_units(H) + g % H;
}

// dst[c * ld + fwd_weight_col(g)] = src[g * cols + c] for the 3H rows of
// one head's weight, and zeros in the pad unit's columns; 16-byte loads
// when the rows allow them.
__device__ inline void fwd_stage_transposed(float* dst, const float* src,
                                            int H, int cols, int ld) {
  const int G = 3 * H;
  if (cols % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n = G * (cols / 4);
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      const int g = e % G, c = 4 * (e / G), col = fwd_weight_col(g, H);
      const float4 v =
          __ldg(reinterpret_cast<const float4*>(src + (i64)g * cols + c));
      dst[c * ld + col] = v.x;
      dst[(c + 1) * ld + col] = v.y;
      dst[(c + 2) * ld + col] = v.z;
      dst[(c + 3) * ld + col] = v.w;
    }
  } else {
    for (int e = threadIdx.x; e < G * cols; e += blockDim.x) {
      const int g = e % G, c = e / G;
      dst[c * ld + fwd_weight_col(g, H)] = __ldg(src + (i64)g * cols + c);
    }
  }
  if (H % 2)
    for (int e = threadIdx.x; e < 3 * cols; e += blockDim.x)
      dst[(e / 3) * ld + (e % 3) * (H + 1) + H] = 0.0f;
}

// Copy step t's input rows into xs [D][bt] (zeros past B); commits a group.
__device__ inline void fwd_prefetch_x(float* xs, const GruArgs& a,
                                      const float* x, int row0, int t) {
  const int bt = a.bt;
  for (int e = threadIdx.x; e < bt * a.D; e += blockDim.x) {
    const int b = e % bt, d = e / bt, row = row0 + b;
    const bool ok = row < a.B;
    cp_async_f32(xs + e, x + (i64)(ok ? row : 0) * a.sxb + (i64)t * a.sxt + d,
                 ok);
  }
  cp_async_commit();
}

// The thread's half of the k split (ks, the lane's low bit), first unit j
// (even) and first row r0 (a multiple of 4).  Where the unit pairs come in
// eights, the 16 (pair, row group) tiles of a warp are 8 pairs x 2 row
// groups; else a warp spans every pair first.
__device__ __forceinline__ void fwd_thread_tile(int H, int bt, int& ks,
                                                int& j, int& r0) {
  const int pairs = H / kFwdUnits, groups = bt / kFwdRows;
  const int t = threadIdx.x / kFwdSplit;
  int u, g;
  if (pairs % 8 == 0) {
    const int c = t / 8;
    u = (c / groups) * 8 + t % 8;
    g = c % groups;
  } else {
    u = t % pairs;
    g = t / pairs;
  }
  ks = threadIdx.x % kFwdSplit;
  j = kFwdUnits * u;
  r0 = kFwdRows * g;
}

// Sum of the two lanes' partials of unit j + ks (the other lane keeps the
// other unit): the lane sends the partial it does not keep.
__device__ __forceinline__ float fwd_pair_sum(unsigned mask, int ks,
                                              float u0, float u1) {
  const float mine = ks ? u1 : u0;
  return mine + __shfl_xor_sync(mask, ks ? u0 : u1, 1);
}

// Grid (batch tiles, heads), fwd_tile_threads(a.bt, a.H) threads, dynamic
// shared memory fwd_tile_smem_floats(a.bt, a.D, a.H); bt a multiple of 4.
__device__ inline void gru_fwd_body(const GruArgs& a) {
  extern __shared__ __align__(16) float smem[];
  const unsigned mask = __activemask();
  const int i = blockIdx.y, H = a.H, D = a.D, G = 3 * H, T = a.T, bt = a.bt;
  const int U = fwd_units(H), ld = fwd_weight_stride(H), row0 = blockIdx.x * bt;
  float* whh = smem + D * ld;
  const float* wx = smem;
  float* xs = smem + fwd_weights_floats(D, H);
  float* hs = xs + 2 * bt * D;
  const float* x = a.x + (i64)i * a.sxp;
  fwd_prefetch_x(xs, a, x, row0, 0);   // in flight while the weights stage

  fwd_stage_transposed(smem, a.w_ih + (i64)i * G * D, H, D, ld);
  fwd_stage_transposed(whh, a.w_hh + (i64)i * G * H, H, H, ld);
  const float* h0 = a.h0 + (i64)i * a.sh0p;
  for (int e = threadIdx.x; e < bt * U; e += blockDim.x) {
    const int b = e % bt, k = e / bt, row = row0 + b;
    hs[e] = row < a.B && k < H ? h0[(i64)row * a.sh0b + k] : 0.0f;
  }

  int ks, j, r0;
  fwd_thread_tile(U, bt, ks, j, r0);
  const float* bih = a.b_ih + (i64)i * G;
  const float* bhh = a.b_hh + (i64)i * G;
  // Lane 0 of a split starts its partials from the biases, lane 1 from
  // zero, so each sum holds them once.
  float br[kFwdUnits], bz[kFwdUnits], bxn[kFwdUnits], bhn[kFwdUnits];
#pragma unroll
  for (int u = 0; u < kFwdUnits; ++u) {
    const bool on = ks == 0 && j + u < H;
    br[u] = on ? bih[j + u] + bhh[j + u] : 0.0f;
    bz[u] = on ? bih[H + j + u] + bhh[H + j + u] : 0.0f;
    bxn[u] = on ? bih[2 * H + j + u] : 0.0f;
    bhn[u] = on ? bhh[2 * H + j + u] : 0.0f;
  }
  const int uj = j + ks;               // the unit this lane finishes
  float* outs = a.outs + (i64)i * a.B * T * H;
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0, k = 0; t < T; ++t, k ^= 1) {
    if (t + 1 < T) fwd_prefetch_x(xs + (k ^ 1) * bt * D, a, x, row0, t + 1);
    float ar[kFwdRows][kFwdUnits], az[kFwdRows][kFwdUnits];
    float axn[kFwdRows][kFwdUnits], ahn[kFwdRows][kFwdUnits];
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r)
#pragma unroll
      for (int u = 0; u < kFwdUnits; ++u) {
        ar[r][u] = br[u];
        az[r][u] = bz[u];
        axn[r][u] = bxn[u];
        ahn[r][u] = bhn[u];
      }
    const float* xk = xs + k * bt * D + r0;
#pragma unroll 2
    for (int c = ks; c < D; c += kFwdSplit) {
      const float4 v = *reinterpret_cast<const float4*>(xk + c * bt);
      const float* wp = wx + c * ld + j;
      const float2 wr = *reinterpret_cast<const float2*>(wp);
      const float2 wz = *reinterpret_cast<const float2*>(wp + U);
      const float2 wn = *reinterpret_cast<const float2*>(wp + 2 * U);
      const float vr[kFwdRows] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r) {
        ar[r][0] = fmaf(vr[r], wr.x, ar[r][0]);
        ar[r][1] = fmaf(vr[r], wr.y, ar[r][1]);
        az[r][0] = fmaf(vr[r], wz.x, az[r][0]);
        az[r][1] = fmaf(vr[r], wz.y, az[r][1]);
        axn[r][0] = fmaf(vr[r], wn.x, axn[r][0]);
        axn[r][1] = fmaf(vr[r], wn.y, axn[r][1]);
      }
    }
    const float* hk = hs + k * bt * U;
#pragma unroll 4
    for (int c = ks; c < H; c += kFwdSplit) {
      const float4 v = *reinterpret_cast<const float4*>(hk + c * bt + r0);
      const float* wp = whh + c * ld + j;
      const float2 wr = *reinterpret_cast<const float2*>(wp);
      const float2 wz = *reinterpret_cast<const float2*>(wp + U);
      const float2 wn = *reinterpret_cast<const float2*>(wp + 2 * U);
      const float vr[kFwdRows] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int r = 0; r < kFwdRows; ++r) {
        ar[r][0] = fmaf(vr[r], wr.x, ar[r][0]);
        ar[r][1] = fmaf(vr[r], wr.y, ar[r][1]);
        az[r][0] = fmaf(vr[r], wz.x, az[r][0]);
        az[r][1] = fmaf(vr[r], wz.y, az[r][1]);
        ahn[r][0] = fmaf(vr[r], wn.x, ahn[r][0]);
        ahn[r][1] = fmaf(vr[r], wn.y, ahn[r][1]);
      }
    }
    const float4 p = *reinterpret_cast<const float4*>(hk + uj * bt + r0);
    const float hp[kFwdRows] = {p.x, p.y, p.z, p.w};
    float hn[kFwdRows];
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      const float sr = fwd_pair_sum(mask, ks, ar[r][0], ar[r][1]);
      const float sz = fwd_pair_sum(mask, ks, az[r][0], az[r][1]);
      const float sxn = fwd_pair_sum(mask, ks, axn[r][0], axn[r][1]);
      const float shn = fwd_pair_sum(mask, ks, ahn[r][0], ahn[r][1]);
      const float rr = sigmoid_f(sr), zz = sigmoid_f(sz);
      const float nn = tanhf(sxn + rr * shn);
      hn[r] = (1.0f - zz) * nn + zz * hp[r];
    }
    *reinterpret_cast<float4*>(hs + (k ^ 1) * bt * U + uj * bt + r0) =
        make_float4(hn[0], hn[1], hn[2], hn[3]);
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
      const int row = row0 + r0 + r;
      if (row < a.B && uj < H) outs[((i64)row * T + t) * H + uj] = hn[r];
    }
    cp_async_wait_all();       // the next step's input rows have landed
    __syncthreads();           // ... and every read of this step is done
  }
}

}  // namespace vcx
