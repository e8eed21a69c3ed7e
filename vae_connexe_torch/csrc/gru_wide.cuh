// B1's forward and B2's chain for hidden widths whose W_hh does not fit a
// block beside a useful tile (hidden 128 on an H100).  gru.cu launches, in
// one call each:
//
//   1. gru_xproj_body: the input half of every step's gates, W_ih x_t +
//      b_ih for all B*T rows of a head at once, as the TPU kernel fills
//      its xp scratch before its time loop (vae_connexe_tpu/ops/
//      pallas_gru.py _fill_xp_scratch), on the tensor cores: 128 rows x
//      128 columns a block, so each weight staged feeds 128 rows.  The
//      chain writes it into the first 3H columns of the gate-gradient
//      scratch gh (P, B, T, 4H), the forward into a scratch xp (P, B, T,
//      3H) of its own (GW: the row's width in units of H).
//   2. gru_chain_wide_body: the reverse walk, on a thread-block cluster of
//      C = kWideCluster = 2 blocks per (head, batch tile).  Block r of the
//      cluster owns the units [r U, r U + U) (U = H' / C, H' = H rounded up
//      to 32) and stages those units' rows of W_hh, all three gates,
//      untransposed (98 KB a block at H = 128).  A cluster of 4 was tried
//      and dropped: at hidden 128 it holds no more rows a round than 2 and
//      pays three peers' partials and a wider barrier a step.  At each
//      step t it reads its rows' and units' xp[t] from gh, computes the
//      hidden half h_{t-1} W_hh^T of its gates, the gate gradients [dbr,
//      dz, da*r, da] (overwriting the xp slots it read: a block reads and
//      writes only its own rows and units), and its partial of ghid W_hh
//      over its 3U gates for all H' units.  Each partial goes to the block
//      that owns those units through distributed shared memory; after one
//      cluster barrier a step every block adds the C partials of its units
//      in rank order.
//   3. gru_fwd_wide_body: B1's time loop on the same clusters and the same
//      staged W_hh rows, after the projection into xp.  A step is one
//      product, h_{t-1} W_hh^T for the block's rows and units, then the
//      gate math in registers beside xp[t]; each block writes its units of
//      h_t to outs, to its own h buffer and through DSMEM to its peer's,
//      under one split cluster barrier a step: the product over the
//      block's own half of h_t runs between arrive and wait, the peer's
//      half after the wait.  The earlier wide forward was the hidden-64
//      body with W_hh^T staged alone (16-row tiles, one block an SM, each
//      staged weight feeding 16 rows) and W_ih^T read from a global copy
//      at every step: 3.07 ms at lorenz96_scaled's heads, 2.6x its float32
//      bound (NVIDIA H100 80GB HBM3, 700 W).
//
// Every product (the projection, the hidden half, and d h_prev = ghid
// W_hh) runs on the tensor cores as float32 products split into three
// TF32 passes (mma.sync m16n8k8: a_lo b_hi + a_hi b_lo + a_hi b_hi, the
// halves cut by a mask), which keeps a float32 product's accuracy to
// about 2^-20: the gate gradients stay within rtol 1e-3 / atol 1e-4 of
// the float32 plain version (~4e-6 apart at lorenz96_scaled's heads), the
// forward's outputs within 1e-5.  On the CUDA cores (the first design of
// this chain, 4 rows x 2 units a thread) the products were bound by the
// shared-memory loads that feed them: a warp's LDS.128 costs 4 cycles of
// the SM's 32 floats a cycle however many lanes share an address, so 2.4
// multiply-adds a loaded float left them at ~55% of the f32 rate.  An
// ldmatrix tile feeds 6 to 8 mma instead.
//   - the hidden half (wide_hidden_mma, both walks): a warp owns 16 rows
//     x 16 units, the three gates of each (six 16 x 8 accumulator tiles);
//     per 8 k it loads one A tile of h_prev and, per gate, both unit
//     halves' B tiles of W_hh, each by one ldmatrix.  Lane (gid, tig) =
//     (lane / 4, lane % 4) then holds rows gid, gid + 8 and units 2 tig,
//     2 tig + 1, 8 + 2 tig, 9 + 2 tig of the item, all three gates of
//     each: the gate math runs where the sums are.
//   - d h_prev: an item of 16 rows x 8 NJ units (NJ accumulator tiles, 4
//     where U is a multiple of 32, else 2, so that no item straddles two
//     blocks' units: H' = 160 at H = 129-132, U = 80); per 8 gates one
//     ldmatrix of ghid and single loads of W_hh read across its rows (k =
//     gate, n = unit; two-way bank conflicts).
// Both walk the one staged copy of W_hh, rows of H' + 4 floats (4 banks
// past a multiple of 32).  In the chain, h_prev rows of the next step come
// in by cp.async while a step computes; in both walks the xp (and douts)
// values of the next step come in by plain loads issued after the gate
// math, into registers, and land during the barrier and the product.
//
// Shared memory of the chain (floats), every region 16-byte aligned:
//   w    [3U][KS]      W_hh rows of the block's units (gate g, unit u at
//                      row g U + u), k along the row, KS = H' + 4; rows of
//                      pad units and columns past H are zero
//   bhh  [3U]          b_hh of those rows
//   h    [2][bt][KS]   h_prev rows of a step, two buffers, zero past H
//   ghid [bt][GS]      the step's [dbr, dz, da*r] of the block's units,
//                      GS = 3U + 4
//   ex   [2][C][bt][US] partials of d h_prev for the block's units, one
//                      slot per source block, two buffers by step parity,
//                      US = U + 4
// The forward keeps w, bhh and h alone (wide_fwd_smem_floats).
//
// No float atomics: every sum has a fixed order (the mma's, then the C
// partials by rank; the forward's two halves of k in a fixed order per
// rank), so two calls give bitwise-equal results.

#pragma once

#include <cooperative_groups.h>
#include <stdint.h>

#include "gru_bwd.cuh"

namespace vcx {

namespace cg = cooperative_groups;

// Tensor-core helpers (sm_80 and later).  ldsm_x4: four 8 x 4-float
// matrices from shared memory, lanes 8 j ... 8 j + 7 giving the 16-byte row
// addresses of matrix j; lane l receives element (l / 4, l % 4) of each.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
// x as hi + lo: hi is x cut to a TF32 mantissa (10 bits) by a mask, lo =
// x - hi exactly, which the mma reads cut to 10 bits too.  The three
// products hi*hi + hi*lo + lo*hi then miss a float32 product by about
// 2^-20 of it.  (A mask and a subtraction issue at the full rate, where a
// conversion instruction would not.)
__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  hi = x & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}
// d += A B for a 16 x 8 tile of A (rows x k, a: fragments) and an 8 x 8
// tile of B (k x n: b0, b1), float32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---- 1. The input projection --------------------------------------------

constexpr int kXpRows = 128, kXpCols = 128, kXpK = 8, kXpThreads = 256;
constexpr int kXpStride = kXpK + 4;   // floats a staged row: 12, no conflict
constexpr int kXpLoads = kXpK * kXpRows / kXpThreads;   // 4 a thread

// gh[i][k][n] = b_ih[i][n] + sum_d x_i[k][d] w_ih[i][n][d] for the rows k =
// b*T + t of head i and n < 3H, on the tensor cores in three TF32 passes;
// a row of gh holds GW * H floats (4: the chain's gh, 3: the forward's
// xp).
// Grid (row tiles, column tiles, heads), kXpThreads threads: warp (wm, wn)
// = (warp / 2, warp % 2) owns rows 32 wm ... 32 wm + 31 and columns
// 64 wn ... 64 wn + 63 of the tile, two 16-row by eight 8-column
// accumulator tiles.  D is walked in chunks of kXpK, both operands staged
// row-major (x rows, W_ih rows), two buffers: the next chunk's global
// loads are in flight in registers while this one is multiplied, and a
// chunk needs one barrier.
template <int GW>
__device__ inline void gru_xproj_body(const GruArgs& a) {
  __shared__ __align__(16) float xs[2][kXpRows * kXpStride];
  __shared__ __align__(16) float ws[2][kXpCols * kXpStride];
  const int i = blockIdx.z, H = a.H, D = a.D, G = 3 * H, T = a.T;
  const int K = a.B * T, m0 = blockIdx.x * kXpRows, n0 = blockIdx.y * kXpCols;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1, gid = lane >> 2, tig = lane & 3;
  const int dl = tid % kXpK, ml = tid / kXpK;   // what this thread loads
  const float* x = a.x + (i64)i * a.sxp;
  const float* w = a.w_ih + (i64)i * G * D;
  // Load q of this thread is row (column) ml + 32 q of the tile; its x row
  // offset once (no division in the loop), -1 past the rows.
  i64 xoff[kXpLoads];
#pragma unroll
  for (int q = 0; q < kXpLoads; ++q) {
    const int k = m0 + ml + 32 * q, b = k / T;
    xoff[q] = k < K ? (i64)b * a.sxb + (i64)(k - b * T) * a.sxt : -1;
  }
  float xv[kXpLoads], wv[kXpLoads];
  auto load = [&](int d0) {
    const bool dok = d0 + dl < D;
#pragma unroll
    for (int q = 0; q < kXpLoads; ++q) {
      const int n = n0 + ml + 32 * q;
      xv[q] = dok && xoff[q] >= 0 ? x[xoff[q] + d0 + dl] : 0.0f;
      wv[q] = dok && n < G ? w[(i64)n * D + d0 + dl] : 0.0f;
    }
  };
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.0f;
  // ldmatrix row addresses: A tile mt's rows, B tile pair np's rows.
  const int a_off = (wm * 32 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kXpStride +
                    (lane >> 4) * 4;
  const int b_off = (wn * 64 + (lane >> 4) * 8 + (lane & 7)) * kXpStride +
                    ((lane >> 3) & 1) * 4;
  load(0);
  for (int d0 = 0, st = 0; d0 < D; d0 += kXpK, st ^= 1) {
#pragma unroll
    for (int q = 0; q < kXpLoads; ++q) {
      xs[st][(ml + 32 * q) * kXpStride + dl] = xv[q];
      ws[st][(ml + 32 * q) * kXpStride + dl] = wv[q];
    }
    __syncthreads();
    if (d0 + kXpK < D) load(d0 + kXpK);
    unsigned ahi[2][4], alo[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      unsigned af[4];
      ldsm_x4(af, xs[st] + a_off + mt * 16 * kXpStride);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(af[q], ahi[mt][q], alo[mt][q]);
    }
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned bf[4], bhi[4], blo[4];
      ldsm_x4(bf, ws[st] + b_off + np * 16 * kXpStride);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(bf[q], bhi[q], blo[q]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          float (&c)[4] = acc[mt][2 * np + h];
          mma_tf32(c, alo[mt], bhi[2 * h], bhi[2 * h + 1]);
          mma_tf32(c, ahi[mt], blo[2 * h], blo[2 * h + 1]);
          mma_tf32(c, ahi[mt], bhi[2 * h], bhi[2 * h + 1]);
        }
    }
  }
  // Accumulator (mt, nt)[q]: row 32 wm + 16 mt + gid + 8 (q / 2), column
  // 64 wn + 8 nt + 2 tig + q % 2 of the tile; a float2 a row's pair.
  float* gh = a.gh + (i64)i * K * GW * H;
  const float* bih = a.b_ih + (i64)i * G;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int n = n0 + wn * 64 + nt * 8 + 2 * tig;
    const float b0 = n < G ? bih[n] : 0.0f, b1 = n + 1 < G ? bih[n + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int k = m0 + wm * 32 + mt * 16 + gid + 8 * ri;
        if (k >= K) continue;
        float* o = gh + (i64)k * GW * H + n;
        const float v0 = acc[mt][nt][2 * ri] + b0;
        const float v1 = acc[mt][nt][2 * ri + 1] + b1;
        // n even and a row of GW H floats even: 8-byte aligned.
        if (n + 1 < G && (GW % 2 == 0 || H % 2 == 0)) {
          *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
        } else {
          if (n < G) o[0] = v0;
          if (n + 1 < G) o[1] = v1;
        }
      }
  }
}

// ---- 2. The reverse walk ------------------------------------------------

// 16-byte asynchronous copy global -> shared; copies zeros unless `valid`.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

constexpr int kWideMaxThreads = 256, kWideCluster = 2;

// H' (units padded to 16 a block of the cluster: a multiple of 32) and U
// (units of a block).
__host__ __device__ inline int wide_hpad(int H) {
  const int q = 16 * kWideCluster;
  return (H + q - 1) / q * q;
}
__host__ __device__ inline int wide_units(int H) {
  return wide_hpad(H) / kWideCluster;
}
// Accumulator tiles of 8 units in a d h_prev item: 4 (32 units) where they
// divide a block's units, else 2, so that an item's units have one owner.
__host__ __device__ inline int wide_dh_tiles(int H) {
  return wide_units(H) % 32 == 0 ? 4 : 2;
}
// Tiles: 16, 32, 48 or 64 rows.
__host__ __device__ inline bool wide_tile_ok(int bt) {
  return bt >= 16 && bt <= 64 && bt % 16 == 0;
}
// One warp a (16 rows, 16 units) item.
__host__ __device__ inline int wide_threads(int bt, int H) {
  return 32 * (wide_units(H) / 16) * (bt / 16);
}
__host__ __device__ inline i64 wide_smem_floats(int bt, int H) {
  const i64 U = wide_units(H), KS = wide_hpad(H) + 4;
  return 3 * U * KS + 3 * U + 2LL * bt * KS + (i64)bt * (3 * U + 4) +
         2LL * kWideCluster * bt * (U + 4);
}

// Split cluster barrier: this thread's writes released / the cluster's
// acquired.
__device__ __forceinline__ void wide_cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void wide_cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Stage head i's W_hh rows of the units [u0, u0 + U) into w (gate g, unit
// u at row g U + u, rows of KS floats; zero past H and in pad units'
// rows) by cp.async, 16 bytes a copy where the rows allow it (one group
// committed), and their b_hh into bhh.
__device__ inline void wide_stage_whh(float* w, float* bhh, const GruArgs& a,
                                      int i, int u0, int U, int HP, int KS) {
  const int H = a.H, tid = threadIdx.x, nthreads = blockDim.x;
  const float* whh = a.w_hh + (i64)i * 3 * H * H;
  if (H % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w_hh) & 15) == 0) {
    const int k4 = HP / 4;
    for (int e = tid; e < 3 * U * k4; e += nthreads) {
      const int c = e / k4, k = 4 * (e - c * k4), g = c / U, j = u0 + c % U;
      const bool ok = j < H && k < H;
      cp_async_16(w + c * KS + k, ok ? whh + ((i64)g * H + j) * H + k : whh,
                  ok);
    }
  } else {
    for (int e = tid; e < 3 * U * HP; e += nthreads) {
      const int c = e / HP, k = e - c * HP, g = c / U, j = u0 + c % U;
      const bool ok = j < H && k < H;
      cp_async_f32(w + c * KS + k, ok ? whh + ((i64)g * H + j) * H + k : whh,
                   ok);
    }
  }
  cp_async_commit();
  for (int c = tid; c < 3 * U; c += nthreads) {
    const int g = c / U, j = u0 + c % U;
    bhh[c] = j < H ? a.b_hh[(i64)i * 3 * H + g * H + j] : 0.0f;
  }
}

// The hidden half of a warp's (16 rows, 16 units) item: acc[g][h] +=
// h_prev W_hh^T over k in [k0, k1) (multiples of 8) for gate g and units
// 8 h ... 8 h + 7, on the tensor cores in three TF32 passes (a_lo b_hi,
// a_hi b_lo, a_hi b_hi).  ap: this lane's ldmatrix row of the item's A
// tile (h_prev rows); brow: its row of the B tiles of gate 0 (W_hh rows),
// gate g gs floats further.  Per 8 k a warp loads one A tile of h_prev
// and, per gate, the B tiles of both unit halves, each by one ldmatrix.
__device__ __forceinline__ void wide_hidden_mma(float (&acc)[3][2][4],
                                                const float* ap,
                                                const float* brow, int gs,
                                                int k0, int k1) {
#pragma unroll 2
  for (int k = k0; k < k1; k += 8) {
    unsigned af[4], ahi[4], alo[4];
    ldsm_x4(af, ap + k);
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(af[q], ahi[q], alo[q]);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      unsigned bf[4], bhi[4], blo[4];
      ldsm_x4(bf, brow + g * gs + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(bf[q], bhi[q], blo[q]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mma_tf32(acc[g][h], alo, bhi[2 * h], bhi[2 * h + 1]);
        mma_tf32(acc[g][h], ahi, blo[2 * h], blo[2 * h + 1]);
        mma_tf32(acc[g][h], ahi, bhi[2 * h], bhi[2 * h + 1]);
      }
    }
  }
}

__device__ __forceinline__ void wide_zero(float (&acc)[3][2][4]) {
#pragma unroll
  for (int g = 0; g < 3; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[g][h][q] = 0.0f;
}

// Grid (C * batch tiles, P) in clusters of C along x; wide_threads(a.bt,
// a.H) threads; dynamic shared memory wide_smem_floats(a.bt, a.H); NJ =
// wide_dh_tiles(a.H).  gh's first 3H columns hold xp (gru_xproj_body) on
// entry.
template <int NJ>
__device__ inline void gru_chain_wide_body(const GruArgs& a) {
  constexpr int C = kWideCluster;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int i = blockIdx.y, H = a.H, T = a.T, B = a.B, bt = a.bt;
  const int HP = wide_hpad(H), U = HP / C, KS = HP + 4;
  const int GS = 3 * U + 4, US = U + 4;
  const int row0 = (int)(blockIdx.x / C) * bt, u0 = rank * U;
  float* w = smem;
  float* bhh = w + 3 * U * KS;
  float* hb = bhh + 3 * U;
  float* ghid = hb + 2 * bt * KS;
  float* ex = ghid + bt * GS;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  // This warp's gate item: rows hr*16 ..., units hu*16 ... of the block.
  // Lane (gid, tig) = (lane / 4, lane % 4) holds, by the mma's accumulator
  // layout, rows gid + 8 ri (ri < 2) and units 8 h + 2 tig + ci (h, ci < 2)
  // of it, the three gates of each: its 8 items are e = 4 ri + 2 h + ci.
  const int ublocks = U / 16, hr = warp / ublocks, hu = warp % ublocks;
  const int gid = lane >> 2, tig = lane & 3;
  auto item_row = [&](int e) { return hr * 16 + gid + 8 * (e >> 2); };
  auto item_unit = [&](int e) {
    return hu * 16 + 8 * ((e >> 1) & 1) + 2 * tig + (e & 1);
  };
  const i64 bth = (i64)B * T;
  const float* outs = a.outs + (i64)i * bth * H;
  const float* douts = a.douts + (i64)i * bth * H;
  const float* h0 = a.h0 + (i64)i * a.sh0p;
  float* gh = a.gh + (i64)i * bth * 4 * H;

  // h_prev of step t (outs[t-1], or h0) into buffer `dst`, rows past B 0;
  // 16 bytes a copy from outs where its rows allow it.
  const bool vec = H % 4 == 0 && (reinterpret_cast<uintptr_t>(outs) & 15) == 0;
  auto prefetch_h = [&](float* dst, int t) {
    if (t > 0 && vec) {
      const int h4 = H / 4;
      for (int e = tid; e < bt * h4; e += nthreads) {
        const int b = e / h4, c = 4 * (e - b * h4), row = row0 + b;
        const bool ok = row < B;
        const float* src = outs + ((i64)(ok ? row : 0) * T + t - 1) * H + c;
        cp_async_16(dst + b * KS + c, src, ok);
      }
      cp_async_commit();
      return;
    }
    for (int e = tid; e < bt * H; e += nthreads) {
      const int b = e / H, c = e - b * H, row = row0 + b;
      const bool ok = row < B;
      const i64 rr = ok ? row : 0;
      const float* src = t > 0 ? outs + (rr * T + t - 1) * H + c
                               : h0 + rr * a.sh0b + c;
      cp_async_f32(dst + b * KS + c, src, ok);
    }
    cp_async_commit();
  };
  // xp (r, z, n) and douts of the lane's items at step t; items e and
  // e + 1 (e even) are one row's neighbouring units, read as float2s when
  // H is even.
  float xr[8], xz[8], xn[8], dt[8];
  auto load_step = [&](int t) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int row = row0 + item_row(e), j = u0 + item_unit(e);
      const i64 rt = (i64)row * T + t;
      const float* x = gh + rt * 4 * H + j;
      const float* o = douts + rt * H + j;
      if (H % 2 == 0) {
        const bool ok = row < B && j < H;
        const float2 z2 = make_float2(0.0f, 0.0f);
        const float2 r = ok ? *reinterpret_cast<const float2*>(x) : z2;
        const float2 z = ok ? *reinterpret_cast<const float2*>(x + H) : z2;
        const float2 n = ok ? *reinterpret_cast<const float2*>(x + 2 * H) : z2;
        const float2 d = ok ? __ldg(reinterpret_cast<const float2*>(o)) : z2;
        xr[e] = r.x, xr[e + 1] = r.y, xz[e] = z.x, xz[e + 1] = z.y;
        xn[e] = n.x, xn[e + 1] = n.y, dt[e] = d.x, dt[e + 1] = d.y;
        continue;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool ok = row < B && j + c < H;
        xr[e + c] = ok ? x[c] : 0.0f;
        xz[e + c] = ok ? x[H + c] : 0.0f;
        xn[e + c] = ok ? x[2 * H + c] : 0.0f;
        dt[e + c] = ok ? __ldg(o + c) : 0.0f;
      }
    }
  };

  // Stage the block's W_hh rows and b_hh; zero the pad columns of h.
  wide_stage_whh(w, bhh, a, i, u0, U, HP, KS);
  if (HP > H)
    for (int e = tid; e < 2 * bt * (HP - H); e += nthreads)
      hb[(e / (HP - H)) * KS + H + e % (HP - H)] = 0.0f;
  prefetch_h(hb, T - 1);
  load_step(T - 1);
  cp_async_wait_all();
  cl.sync();   // the weights have landed; every block of the cluster runs

  // The hidden half of the gates, h_prev W_hh^T for the warp's 16 rows and
  // 16 units' three gates (wide_hidden_mma): acc[g][h] is the accumulator
  // tile of gate g and units 8 h ... 8 h + 7.
  float acc[3][2][4];
  const float* arow = hb + (hr * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * KS +
                      (lane >> 4) * 4;
  const float* brow = w + (hu * 16 + (lane >> 4) * 8 + (lane & 7)) * KS +
                      ((lane >> 3) & 1) * 4;
  auto hidden = [&](int buf) {
    wide_zero(acc);
    wide_hidden_mma(acc, arow + buf * bt * KS, brow, U * KS, 0, HP);
  };

  float carry[8];   // d h of the lane's items
#pragma unroll
  for (int e = 0; e < 8; ++e) carry[e] = 0.0f;
  hidden(0);

  // Step t: gate math (needs the carry), d h_prev partials to their owners,
  // arrive at the cluster barrier; then the next step's hidden half, which
  // needs no partial, runs while the barrier completes; then wait and add
  // the partials.  Buffer kb holds h_prev of step t.
  for (int t = T - 1, kb = 0; t >= 0; --t, kb ^= 1) {
    const float* hcur = hb + kb * bt * KS;
    // Gate math (torch's n gate), the gate gradients to ghid and gh.
    float zd[8], go[4][8];   // go: [dbr, dz, da*r, da] of each item
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int b = item_row(e), row = row0 + b;
      const int jl = item_unit(e), j = u0 + jl;
      const int h = (e >> 1) & 1, q = 2 * (e >> 2) + (e & 1);
      const float rr = sigmoid_f(acc[0][h][q] + xr[e] + bhh[jl]);
      const float zz = sigmoid_f(acc[1][h][q] + xz[e] + bhh[U + jl]);
      const float hn = acc[2][h][q] + bhh[2 * U + jl];
      const float nn = tanhf(xn[e] + rr * hn);
      const float hv = hcur[b * KS + j];
      const float d = carry[e] + dt[e];
      const float dz = d * (hv - nn) * zz * (1.0f - zz);
      const float da = d * (1.0f - zz) * (1.0f - nn * nn);
      const float dbr = da * hn * rr * (1.0f - rr);
      const float dar = da * rr;
      ghid[b * GS + jl] = dbr;
      ghid[b * GS + U + jl] = dz;
      ghid[b * GS + 2 * U + jl] = dar;
      go[0][e] = dbr, go[1][e] = dz, go[2][e] = dar, go[3][e] = da;
      zd[e] = d * zz;
    }
    // The gate gradients to gh, a float2 a neighbouring pair of units.
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int row = row0 + item_row(e), j = u0 + item_unit(e);
      float* o = gh + ((i64)row * T + t) * 4 * H + j;
      if (H % 2 == 0) {
        if (row < B && j < H)
#pragma unroll
          for (int g = 0; g < 4; ++g)
            *reinterpret_cast<float2*>(o + g * H) =
                make_float2(go[g][e], go[g][e + 1]);
        continue;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (row < B && j + c < H)
#pragma unroll
          for (int g = 0; g < 4; ++g) o[g * H + c] = go[g][e + c];
    }
    if (t > 0) {
      // Both land during the d h_prev product: the xp and douts values of
      // step t - 1, and its h_prev into the other buffer (last read by the
      // gate math of step t + 1, two barriers ago).
      load_step(t - 1);
      prefetch_h(hb + (kb ^ 1) * bt * KS, t - 1);
    }
    __syncthreads();               // ghid is whole

    // d h_prev partials: ghid W_hh over the block's 3U gates for all H'
    // units, on the tensor cores in three TF32 passes, each item's to the
    // block that owns its units.  An item is 16 rows x 8 NJ units (NJ
    // 8-unit accumulator tiles); per 8 gates a warp loads one A tile of
    // ghid by ldmatrix and W_hh's B tiles, read across its rows (k = gate,
    // n = unit), by single loads.
    const int kblocks = HP / (8 * NJ), items = (bt / 16) * kblocks;
    for (int it = warp; it < items; it += nwarps) {
      const int dr = it / kblocks, dk = it - dr * kblocks;
      float dacc[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        dacc[j][0] = dacc[j][1] = dacc[j][2] = dacc[j][3] = 0.0f;
      const float* ap = ghid + (dr * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   GS + (lane >> 4) * 4;
      const float* bp = w + tig * KS + dk * 8 * NJ + gid;
#pragma unroll 2
      for (int c = 0; c < 3 * U; c += 8) {
        unsigned af[4], ahi[4], alo[4];
        ldsm_x4(af, ap + c);
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(af[q], ahi[q], alo[q]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          unsigned bhi[2], blo[2];
          split_tf32(__float_as_uint(bp[c * KS + 8 * j]), bhi[0], blo[0]);
          split_tf32(__float_as_uint(bp[(c + 4) * KS + 8 * j]), bhi[1],
                     blo[1]);
          mma_tf32(dacc[j], alo, bhi[0], bhi[1]);
          mma_tf32(dacc[j], ahi, blo[0], blo[1]);
          mma_tf32(dacc[j], ahi, bhi[0], bhi[1]);
        }
      }
      const int owner = dk * 8 * NJ / U;
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        float* dst = ex + ((kb * C + rank) * bt + dr * 16 + gid + 8 * ri) * US +
                     dk * 8 * NJ - owner * U + 2 * tig;
        if (owner != rank) dst = cl.map_shared_rank(dst, owner);
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(dacc[j][2 * ri], dacc[j][2 * ri + 1]);
      }
    }
    // This thread's partials are out and its reads of ghid are done.
    wide_cluster_arrive();
    if (t > 0) {
      cp_async_wait_all();         // step t - 1's h_prev has landed
      __syncthreads();
      hidden(kb ^ 1);
    }
    // Every partial of step t has landed in its owner.
    wide_cluster_wait();

#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float* s = ex + (kb * C * bt + item_row(e)) * US + item_unit(e);
      float sum = s[0];
#pragma unroll
      for (int src = 1; src < C; ++src) sum += s[src * bt * US];
      carry[e] = zd[e] + sum;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const int row = row0 + item_row(e), j = u0 + item_unit(e);
    if (row < B && j < H) a.dh0[((i64)i * B + row) * H + j] = carry[e];
  }
}

// ---- 3. B1's forward walk ----------------------------------------------

constexpr int kWideFwdMaxThreads = 512;

// Shared memory of a forward block (floats): the block's W_hh rows (3U of
// KS = H' + 4), b_hh of those rows, and two buffers of h rows [bt][KS].
__host__ __device__ inline i64 wide_fwd_smem_floats(int bt, int H) {
  const i64 U = wide_units(H), KS = wide_hpad(H) + 4;
  return 3 * U * KS + 3 * U + 2LL * bt * KS;
}

// outs (P, B, T, H) of the recurrence, h_0 = h0 (P, B, H) through its
// strides, from xp = a.gh (P, B, T, 3H) = x W_ih^T + b_ih
// (gru_xproj_body<3>) and W_hh, b_hh.  Grid (C * batch tiles, P) in
// clusters of C = 2 along x; wide_threads(a.bt, a.H) threads, a warp a
// (16 rows, 16 units) item as in the chain; dynamic shared memory
// wide_fwd_smem_floats(a.bt, a.H).
//
// Block r owns the units [r U, r U + U) and keeps every unit of h in its
// two buffers: step t reads buffer t & 1 (h_{t-1}; h0 at t = 0) and writes
// its units of h_t into buffer (t + 1) & 1, its own and, through DSMEM,
// its peer's.  Then it arrives at the cluster barrier, syncs the block and
// runs the next step's product over its own units of h_t (k in [r U, r U
// + U)), waits, and adds the product over the peer's units.  The buffer a
// step writes was last read, in both blocks, before the barrier the
// writer has waited at since, so one barrier a step suffices; the last
// step writes no buffer, so no block touches another's shared memory
// after its last wait.
__device__ inline void gru_fwd_wide_body(const GruArgs& a) {
  constexpr int C = kWideCluster;
  static_assert(C == 2, "the forward sends h_t to one peer");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cl = cg::this_cluster();
  const int rank = (int)cl.block_rank();
  const int i = blockIdx.y, H = a.H, T = a.T, B = a.B, bt = a.bt;
  const int HP = wide_hpad(H), U = HP / C, KS = HP + 4;
  const int row0 = (int)(blockIdx.x / C) * bt, u0 = rank * U;
  float* w = smem;
  float* bhh = w + 3 * U * KS;
  float* hb = bhh + 3 * U;
  float* peer = cl.map_shared_rank(hb, rank ^ 1);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  // The warp's item and the lane's 8 (row, unit) pairs e = 4 ri + 2 h +
  // ci, as in the chain.
  const int ublocks = U / 16, hr = warp / ublocks, hu = warp % ublocks;
  const int gid = lane >> 2, tig = lane & 3;
  auto item_row = [&](int e) { return hr * 16 + gid + 8 * (e >> 2); };
  auto item_unit = [&](int e) {
    return hu * 16 + 8 * ((e >> 1) & 1) + 2 * tig + (e & 1);
  };
  const i64 bth = (i64)B * T;
  const float* xp = a.gh + (i64)i * bth * 3 * H;
  float* outs = a.outs + (i64)i * bth * H;
  const float* h0 = a.h0 + (i64)i * a.sh0p;

  // xp (r, z, n) of the lane's items at step t, float2s where H is even.
  float pr[8], pz[8], pn[8];
  auto load_xp = [&](int t) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int row = row0 + item_row(e), j = u0 + item_unit(e);
      const float* src = xp + ((i64)row * T + t) * 3 * H + j;
      if (H % 2 == 0) {
        const bool ok = row < B && j < H;
        const float2 z2 = make_float2(0.0f, 0.0f);
        const float2 r = ok ? __ldg(reinterpret_cast<const float2*>(src)) : z2;
        const float2 z =
            ok ? __ldg(reinterpret_cast<const float2*>(src + H)) : z2;
        const float2 n =
            ok ? __ldg(reinterpret_cast<const float2*>(src + 2 * H)) : z2;
        pr[e] = r.x, pr[e + 1] = r.y, pz[e] = z.x, pz[e + 1] = z.y;
        pn[e] = n.x, pn[e + 1] = n.y;
        continue;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const bool ok = row < B && j + c < H;
        pr[e + c] = ok ? __ldg(src + c) : 0.0f;
        pz[e + c] = ok ? __ldg(src + H + c) : 0.0f;
        pn[e + c] = ok ? __ldg(src + 2 * H + c) : 0.0f;
      }
    }
  };

  // Stage the block's W_hh rows and b_hh, and h0 into buffer 0.
  wide_stage_whh(w, bhh, a, i, u0, U, HP, KS);
  for (int e = tid; e < bt * HP; e += nthreads) {
    const int b = e / HP, k = e - b * HP, row = row0 + b;
    hb[b * KS + k] = row < B && k < H ? h0[(i64)row * a.sh0b + k] : 0.0f;
  }
  load_xp(0);
  cp_async_wait_all();
  cl.sync();   // the weights and h0 are in; the peer runs

  float acc[3][2][4];
  const float* arow = hb + (hr * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * KS +
                      (lane >> 4) * 4;
  const float* brow = w + (hu * 16 + (lane >> 4) * 8 + (lane & 7)) * KS +
                      ((lane >> 3) & 1) * 4;
  const int k_own = u0, k_peer = (rank ^ 1) * U;
  wide_zero(acc);
  wide_hidden_mma(acc, arow, brow, U * KS, 0, HP);

  for (int t = 0, kb = 0; t < T; ++t, kb ^= 1) {
    // Gate math (torch's), where the sums are; pad units stay 0.
    const float* hcur = hb + kb * bt * KS;
    float hv[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int jl = item_unit(e), j = u0 + jl;
      const int h = (e >> 1) & 1, q = 2 * (e >> 2) + (e & 1);
      const float gr = sigmoid_f(pr[e] + (acc[0][h][q] + bhh[jl]));
      const float gz = sigmoid_f(pz[e] + (acc[1][h][q] + bhh[U + jl]));
      const float gn = tanhf(pn[e] + gr * (acc[2][h][q] + bhh[2 * U + jl]));
      const float hp = hcur[item_row(e) * KS + j];
      hv[e] = j < H ? (1.0f - gz) * gn + gz * hp : 0.0f;
    }
    // Each pair of neighbouring units to outs (a float2 where H is even).
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int row = row0 + item_row(e), j = u0 + item_unit(e);
      float* o = outs + ((i64)row * T + t) * H + j;
      if (H % 2 == 0) {
        if (row < B && j < H)
          *reinterpret_cast<float2*>(o) = make_float2(hv[e], hv[e + 1]);
        continue;
      }
#pragma unroll
      for (int c = 0; c < 2; ++c)
        if (row < B && j + c < H) o[c] = hv[e + c];
    }
    if (t + 1 == T) break;
    // h_t of the block's units into both blocks' next buffer.
    float* nxt = hb + (kb ^ 1) * bt * KS;
    float* nxt_peer = peer + (kb ^ 1) * bt * KS;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      const int off = item_row(e) * KS + u0 + item_unit(e);
      const float2 v = make_float2(hv[e], hv[e + 1]);
      *reinterpret_cast<float2*>(nxt + off) = v;
      *reinterpret_cast<float2*>(nxt_peer + off) = v;
    }
    load_xp(t + 1);            // lands during the barrier and the product
    wide_cluster_arrive();     // this thread's h_t is out
    __syncthreads();           // the block's units of h_t are in nxt
    wide_zero(acc);
    wide_hidden_mma(acc, arow + (kb ^ 1) * bt * KS, brow, U * KS, k_own,
                    k_own + U);
    wide_cluster_wait();       // the peer's units of h_t have landed
    wide_hidden_mma(acc, arow + (kb ^ 1) * bt * KS, brow, U * KS, k_peer,
                    k_peer + U);
  }
}

}  // namespace vcx
