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
// Streamed (stream_step, for shapes whose weights do not fit a block: one
// head at hidden 128 with D = 40 is 269 KB in float32).  A time step is one
// launch of grid (batch tiles of M rows, P heads); the kernel boundary is
// the step's barrier, and nothing waits on the host between steps.  Block
// (tile, head i) stages its rows of [x_t | h_i] in shared memory, streams
// head i's weights from L2 through a ring of 8-row chunks, each one bulk
// copy of the TMA engine completing on an mbarrier, and computes its
// M x 3H gates as a register-tiled product: TR rows x TU units x the 3
// gates a thread, so each weight a thread loads from shared memory feeds
// TR rows and each chunk the block loads feeds all M.  The GRU update is
// the product's epilogue and writes h_i back in place (only this block
// owns h_i for these rows); the block then computes head i's readout for
// its rows, adds the noise and stores out[:, t] and the next of two x
// buffers.  M is picked by the wrapper (cuda_rollout.stream_tile): the
// widest tile that still gives every SM a block (P x tiles >= SMs), so at
// B = 1 the P heads' weight reads spread over P SMs instead of one.
//   What the card showed (H100; tools/torch_rollout_tiles.py sweeps M):
//   from 16 rows the product is bound by the issue of its multiply-adds
//   and shared-memory loads, not by L2, so the thread tile is 8 x 2 (64
//   accumulators, 128 registers) and M stops at 32, two blocks an SM (at
//   64 rows one block holds an SM, which idles through its tile load,
//   epilogue and readout).  At a small batch a step is a chain of
//   latencies: the tile of 4 (8) rows splits the chunks over 4 (2) groups
//   of threads, whose sums meet in shared memory in a fixed order; and a
//   step after the first is a programmatic dependent launch, which starts
//   its weight copies while the step before finishes and waits
//   (griddepcontrol) only before it reads the state.  One cooperative
//   launch of all T steps (a grid barrier a step, h kept in shared memory)
//   was tried where the card holds a step's grid: at B = 1 it ran p = 40
//   in 0.1821 ms against the T launches' 0.1862 and K2 in 0.1916 against
//   0.1871, so the launches do not set the pace at those shapes; it gained
//   13% only at p = 128 and 15% at p = 40, B = 37, too little for a second
//   launch mode of every kernel (PERF.md, tools/torch_rollout_tiles.py).
//
// Bound.  At the serving shape (p=20, H=64, B=3072, T=21) K1 is ~4.2e10
// f32 flops against ~13 MB of input and output: bound by f32 FMA
// throughput (0.62 ms on an H100 SXM).  On the resident route the
// arithmetic is the limit, on the busiest block of a cluster (3 heads of
// 20 on 7 blocks).  On the streamed route at p=40, H=128, B=3072 it is
// 3.3e11 flops (4.98 ms at 67 TFLOP/s); the body adds the state's round
// trip through HBM (P x B x H x 4 bytes read and written a step: 126 MB at
// p=40) and L2 reads of P x B / M x 258 KB a step.  At B=1 neither bound
// applies: the 21-step dependency chain (a gate product, a readout, a
// barrier or launch a step) sets the time.
//
// Storage type.  Both routes take float32 weights and bfloat16 weights
// (bf16 serving: JAX's _free_run and ErrorVAE.sample with
// dtype=bfloat16).  In bf16 the weights, biases and readout stay bf16 in
// memory, the products are accumulated and the gate math done in float32,
// and each step's new state and emitted x are rounded to the nearest bf16
// (carry<W>), as JAX's bf16 carries are; x0, h0 and the noise arrive as
// float32 and are rounded to bf16 as they are read, and the output is
// float32.  The streamed
// route instantiates stream_step for both types, carry<float> being the
// identity; its ring holds float32 weights in both (its wrapper widens
// bf16 ones, exactly): its product is bound by issue, not by L2 bytes, and
// converting each bf16 weight in the inner loop, or each chunk once a
// block in shared memory, made bf16 slower than float32 there.
//
// Resident route in bf16 (mma_body, its own kernels crvae_free_run_mma_kernel
// and errvae_sample_mma_kernel; resident_body is the float32 body).  The
// carries are bf16 values, so [x_t | h_i] is a bf16 matrix exactly, and the
// gate product runs on the tensor cores: mma.sync m16n8k16, bf16 operands,
// float32 accumulators.  The weights' torch layout (3H, K), K contiguous,
// is the instruction's column-major B operand as it is: a block stages each
// of its heads' rows once, untransposed, as [W_ih row | zeros to Kx | W_hh
// row | zeros to Kx + Kh] (Kx, Kh: D and H rounded up to 16; units rounded
// up to 8 a gate, zero rows past H).  x and each head's state live in
// shared memory as bf16 rows (two buffers each), so ldmatrix reads the A
// fragments; every row stride is 8 elements past a multiple of 16, so the
// 8 rows an ldmatrix phase reads start 4 words apart modulo 32 banks, free
// of conflicts (weights too).  A warp's item is 16 rows x 8 units of one
// head, with the r, z and n rows of those units together: its four
// accumulators (r, z, the input and the hidden part of n) hold the same
// (row, unit) pairs in the same lane, so the GRU update is a register
// epilogue in float32 (sigmoid_f, tanhf, carry), written back as bf16
// pairs.  The accumulators start from the biases; the hidden half (W_hh h,
// local) comes first, and K1's cluster wait sits between it and the input
// half of a warp's first item, as in resident_body.  The readout is one
// thread's dot over H a (row, column), from the bf16 state, in
// resident_body's order; K1 stores x_{t+1} as bf16 into every peer's x
// buffer; K2's readout (D outputs) runs on mma.sync too.  The tile sweep
// (tools/torch_rollout_tiles.py --bf16) also times a build in which each
// mma starts from zero and its k16 partial joins the running sum by a
// rounded float32 add.
//   Bound: at p=20, H=64, B=3072, T=21 K1 is 4.2e10 flops, 0.042 ms at the
// 989 TFLOP/s of wgmma, the rate the bounds in PERF.md use; mma.sync issues
// from one warp at a time and tops out below it.  The body is bound first
// by the shared-memory reads of its fragments (1280 bytes an item and k16
// for 3 mma: about a third of the tensor rate at 128 bytes a clock) and by
// the gate math on the CUDA cores (two sigmoids and a tanh a row and unit);
// at B=1 by the 21-step chain of a product, a readout and a barrier.  wgmma
// was not taken: its tiles are 64 rows a warpgroup against batch tiles of
// 16-96 rows (one live row at B=1), and its asynchronous issue and fences
// add latency to every link of that chain.

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

// Block (tile, head i) of a step's launch, shared memory in this order,
// every region 16-byte aligned:
//   bars [8]      one mbarrier a ring stage
//   ring [S][kStreamChunk][3][Hp]  chunks of head i's packed float32
//                 weights, S = stream_stages(M): two rounds of the KS
//                 groups' chunks (at least 4), one round in flight ahead
//   tile [Kp][M]  its rows of [x_t | h_i], transposed (float32): x in rows
//                 [0, Dp), h_i in rows [Dp, Kp); zeros in the pad rows
//   ro   [O][H+4] head i's readout rows (float32; 4 past H so that rows of
//                 neighbouring columns start in other banks)
//   bias [6H + O] head i's b_ih, b_hh and readout biases (float32)
// The chunks, ro and the biases do not depend on the step before and are
// started before the block waits for it; ro and the biases are read only
// after the product.  The ring then holds the groups' partial sums.
// Weights in global memory, packed by the wrapper: (P, Kp, 3, Hp) float32,
// row k the gates r, z, n of every unit: W_ih^T rows, zero rows to Dp,
// W_hh^T rows, zero rows to Kp = Dp + Hp; units past H zero.  A chunk is
// then one contiguous run of bytes.  Dp rounds D up to a chunk, so a chunk
// is all input or all state (the n gate keeps the two apart); Hp rounds H
// up to 32.
// State scratch (P, Hp, Bp) and x scratch (2, Dp, Bp), both transposed and
// padded to whole tiles (Bp), so that a step's tile is copied in by
// 16-byte cp.async with no mask; step 0 reads x0 (B, D) and h0 (B, H)
// instead.  Step t reads x buffer t & 1 and writes (t + 1) & 1; only block
// (tile, i) reads or writes h_i of its rows, so the state is updated in
// place.
constexpr int kStreamChunk = 8, kStreamMaxStages = 8;
constexpr int kStreamBarBytes = kStreamMaxStages * 8;
constexpr int kStreamTiles[4] = {32, 16, 8, 4};

__host__ __device__ inline int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
__host__ __device__ inline int stream_dp(int D) {
  return round_up(D, kStreamChunk);
}
__host__ __device__ inline int stream_hp(int H) { return round_up(H, 32); }
// Row stride (in floats) of the staged readout rows.
__host__ __device__ inline int stream_ro_ld(int H) { return H + 4; }

// A thread tile: TR rows x TU units x the 3 gates, over 1 / KS of the
// chunks: 4 x 1 split 4 ways at 4 rows, 4 x 2 split 2 ways at 8, 8 x 2
// (64 accumulators a thread: r, z and the two parts of n) from 16.  A small
// tile is a small batch, whose step is a chain of latencies: the split
// puts KS groups of threads on its chunks at once.
__host__ __device__ inline int stream_rows(int M) { return M >= 16 ? 8 : 4; }
__host__ __device__ inline int stream_units(int M) { return M >= 8 ? 2 : 1; }
__host__ __device__ inline int stream_split(int M) {
  return M >= 16 ? 1 : (M == 8 ? 2 : 4);
}
// Threads of one group (a thread tile each) and of the block.
__host__ __device__ inline int stream_group(int M, int H) {
  return M / stream_rows(M) * (stream_hp(H) / stream_units(M));
}
__host__ __device__ inline int stream_threads(int M, int H) {
  return stream_split(M) * stream_group(M, H);
}
// Ring stages: the chunks of the KS groups' step and of the next one.
__host__ __device__ constexpr int stream_stages_of(int KS) {
  return KS * 2 > 4 ? KS * 2 : 4;
}
__host__ __device__ inline int stream_stages(int M) {
  return stream_stages_of(stream_split(M));
}
// A warp's lanes: RW row groups x UW unit groups, UW a power of two that
// divides the unit groups, as many as make a lane's weight load of one
// gate 128 bytes a warp (one wavefront), at most 32.  False where the
// tiles do not cover whole warps.
__host__ __device__ inline bool stream_layout(int M, int H, int& RW,
                                              int& UW) {
  const int NR = M / stream_rows(M), NU = stream_hp(H) / stream_units(M);
  UW = 32 / stream_units(M);
  while (UW > 1 && NU % UW != 0) UW /= 2;
  RW = 32 / UW;
  if (RW > NR) {
    RW = NR;
    UW = 32 / RW;
  }
  return NR % RW == 0 && NU % UW == 0 && RW * UW == 32;
}
// The most threads each instantiation takes (its __launch_bounds__): 512
// at 64 accumulators a thread (128 registers), else 1024.
__host__ __device__ constexpr int stream_max_threads(int TR, int TU) {
  return TR * TU <= 8 ? 1024 : 512;
}
// Bytes of the regions of a streamed block (after the barriers).
__host__ __device__ inline i64 stream_chunk_elems(int H) {
  return (i64)kStreamChunk * 3 * stream_hp(H);
}
__host__ __device__ inline i64 stream_ring_bytes(int M, int H) {
  return stream_stages(M) * stream_chunk_elems(H) * 4;
}
__host__ __device__ inline i64 stream_tile_bytes(int M, int D, int H) {
  return (i64)(stream_dp(D) + stream_hp(H)) * M * 4;
}
__host__ __device__ inline i64 stream_ro_bytes(int H, int O) {
  return (i64)O * stream_ro_ld(H) * 4;
}
__host__ __device__ inline i64 stream_smem_bytes(int M, int D, int H, int O) {
  return kStreamBarBytes + stream_ring_bytes(M, H) +
         stream_tile_bytes(M, D, H) + stream_ro_bytes(H, O) +
         ((6LL * H + O) * 4 + 15) / 16 * 16;
}

template <typename W>
struct StreamArgs {
  // x0, h0 and the noise are float32; in bf16 the kernel rounds each to
  // bf16 as it reads it (the resident route's too).
  const float* x0;      // (B, D), or nullptr for a zero start
  const float* h0;      // (B, H), every head's initial state
  const float* noise;   // (B, T, D), or nullptr for none
  const float* w;       // (P, Kp, 3, Hp), packed as above, float32
  const W* b_ih;        // (P, 3H)
  const W* b_hh;        // (P, 3H)
  const W* ro_w;        // (P, O, H)
  const W* ro_b;        // (P, O)
  float* out;           // (B, T, D)
  float* h;             // (P, Hp, Bp) state scratch
  float* x;             // (2, Dp, Bp) x scratch, zero in the pad columns
  int B, Bp, T, P, H, O, M;
  float noise_scale;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
// The ring's barriers: each counts one arrival (the thread that starts a
// stage's copy) and the copy's bytes.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// Start one bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global src into shared dst; bar completes its phase when
// they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// Programmatic dependent launch: a step's launch may start while the step
// before it finishes; wait_prior_step returns once that step has completed
// and its writes are visible, and allow_next_step lets the next step's
// blocks be scheduled.
__device__ __forceinline__ void wait_prior_step() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void allow_next_step() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// Wait until bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Copy `rows` rows of `cols` weights from src (row stride src_ld) into
// shared dst as float32 (row stride dst_ld): 16-byte cp.async for float32
// rows of whole 16-byte pieces at 16-byte aligned addresses, else one
// weight at a time, widened (bf16, and widths no shape of the repo has).
template <typename W>
__device__ __forceinline__ void stage_rows(float* dst, int dst_ld,
                                           const W* src, i64 src_ld,
                                           int rows, int cols) {
  const bool vec = sizeof(W) == 4 && cols % 4 == 0 && dst_ld % 4 == 0 &&
                   src_ld % 4 == 0 &&
                   reinterpret_cast<size_t>(src) % 16 == 0 &&
                   reinterpret_cast<size_t>(dst) % 16 == 0;
  if (vec) {
    const int pieces = cols / 4;
    for (int e = threadIdx.x; e < rows * pieces; e += blockDim.x) {
      const int r = e / pieces, q = e % pieces;
      cp_async16(dst + r * dst_ld + q * 4, src + r * src_ld + q * 4);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, q = e % cols;
      dst[r * dst_ld + q] = to_f(src[r * src_ld + q]);
    }
  }
}

// TU consecutive units' weights (float32) of one gate at p.
template <int TU>
__device__ __forceinline__ void ld_units(const float* p, float (&w)[TU]) {
  if constexpr (TU == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *p;
  }
}

// A thread's gate sums: TR rows x TU units of r, z, and the input and
// hidden parts of n.
template <int TR, int TU>
struct StreamAcc {
  float r[TR][TU], z[TR][TU];
  float xn[TR][TU], hn[TR][TU];
};

// Add one chunk's rows: v (tile row k0, the thread's TR rows; row stride
// M), w (float32 chunk, the thread's units of gate r; row stride 3 Hp).
// HIDDEN: the chunk is state rows, whose n product goes to the hidden part.
template <bool HIDDEN, int TR, int TU>
__device__ __forceinline__ void stream_chunk(StreamAcc<TR, TU>& a,
                                             const float* v, const float* w,
                                             int M, int Hp) {
#pragma unroll
  for (int kk = 0; kk < kStreamChunk; ++kk) {
    float xr[TR];
#pragma unroll
    for (int q = 0; q < TR / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(v + kk * M + 4 * q);
      xr[4 * q] = x.x; xr[4 * q + 1] = x.y;
      xr[4 * q + 2] = x.z; xr[4 * q + 3] = x.w;
    }
    float wr[TU], wz[TU], wn[TU];
    const float* row = w + kk * 3 * Hp;
    ld_units<TU>(row, wr);
    ld_units<TU>(row + Hp, wz);
    ld_units<TU>(row + 2 * Hp, wn);
    float(&an)[TR][TU] = HIDDEN ? a.hn : a.xn;
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int u = 0; u < TU; ++u) {
        a.r[r][u] = fmaf(xr[r], wr[u], a.r[r][u]);
        a.z[r][u] = fmaf(xr[r], wz[u], a.z[r][u]);
        an[r][u] = fmaf(xr[r], wn[u], an[r][u]);
      }
  }
}

template <int TR, int TU>
__device__ __forceinline__ void stream_chunk_at(StreamAcc<TR, TU>& a,
                                                bool hidden, const float* v,
                                                const float* w, int M,
                                                int Hp) {
  if (hidden)
    stream_chunk<true, TR, TU>(a, v, w, M, Hp);
  else
    stream_chunk<false, TR, TU>(a, v, w, M, Hp);
}

// Step t of block (tile blockIdx.x, head blockIdx.y): the gate product of
// its M rows as a register-tiled product over the chunks, the GRU update
// in its epilogue (h_i written back in place), then the head's readout
// (O columns) plus the noise, stored to out[:, t] and the next x buffer.
// Every sum is taken in a fixed order, so two calls are bitwise equal.
template <int TR, int TU, int KS, typename W>
__device__ __forceinline__ void stream_step(const StreamArgs<W>& a, int t) {
  extern __shared__ __align__(16) unsigned char stream_smem[];
  constexpr int S = stream_stages_of(KS);
  const int M = a.M, H = a.H, Hp = stream_hp(H), O = a.O, D = a.P * O;
  const int Dp = stream_dp(D), Kp = Dp + Hp, Bp = a.Bp;
  const int ldr = stream_ro_ld(H);
  const int i = blockIdx.y, row0 = blockIdx.x * M;
  const int tid = threadIdx.x, nth = blockDim.x;
  const int ce = (int)stream_chunk_elems(H);
  unsigned long long* bars =
      reinterpret_cast<unsigned long long*>(stream_smem);
  unsigned char* at = stream_smem + kStreamBarBytes;
  float* ring = reinterpret_cast<float*>(at);
  at += stream_ring_bytes(M, H);
  float* tile = reinterpret_cast<float*>(at);
  at += stream_tile_bytes(M, D, H);
  float* ro = reinterpret_cast<float*>(at);
  float* bias = ro + O * ldr;
  const float* wg = a.w + (i64)i * Kp * 3 * Hp;
  const int n_chunks = Kp / kStreamChunk;

  // What does not depend on the step before, while it may still run:
  // thread 0 starts the first S - KS chunks' bulk copies; ro and the biases
  // (float32 by cp.async, bf16 widened by plain loads).
  auto load_chunk = [&](int c) {
    if (tid == 0 && c < n_chunks)
      bulk_load(ring + (c % S) * ce, wg + (i64)c * ce, ce * 4, bars + c % S);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) mbar_init(bars + s);
    mbar_init_fence();
    for (int c = 0; c < S - KS; ++c) load_chunk(c);
  }
  stage_rows(ro, ldr, a.ro_w + (i64)i * O * H, H, O, H);
  stage_rows(bias, 3 * H, a.b_ih + (i64)i * 3 * H, 0, 1, 3 * H);
  stage_rows(bias + 3 * H, 3 * H, a.b_hh + (i64)i * 3 * H, 0, 1, 3 * H);
  stage_rows(bias + 6 * H, O, a.ro_b + (i64)i * O, 0, 1, O);

  // The step's tile, once the step before has written it: step 0 from x0
  // and h0 (masked, transposed), later steps by cp.async from the scratch
  // buffers.
  wait_prior_step();
  const int quads = M / 4;
  if (t == 0) {
    for (int e = tid; e < Kp * M; e += nth) {
      const int m = e % M, k = e / M, row = row0 + m;
      float v = 0.0f;
      if (row < a.B) {
        if (k < D)
          v = a.x0 != nullptr ? a.x0[(i64)row * D + k] : 0.0f;
        else if (k >= Dp && k - Dp < H)
          v = a.h0[(i64)row * H + (k - Dp)];
      }
      tile[e] = carry<W>(v);
    }
  } else {
    const float* xs = a.x + (i64)(t & 1) * Dp * Bp + row0;
    const float* hs = a.h + (i64)i * Hp * Bp + row0;
    for (int e = tid; e < Kp * quads; e += nth) {
      const int q = e % quads, k = e / quads;
      const float* src = k < Dp ? xs + (i64)k * Bp : hs + (i64)(k - Dp) * Bp;
      cp_async16(tile + k * M + 4 * q, src + 4 * q);
    }
  }
  vcx::cp_async_commit();
  vcx::cp_async_wait_all();

  // The thread tile of group g: a warp covers RW row groups x UW unit
  // groups.
  int RW, UW;
  stream_layout(M, H, RW, UW);
  const int WU = Hp / TU / UW, NB = stream_group(M, H);
  const int g = tid / NB, b = tid % NB;
  const int lane = b & 31, warp = b >> 5;
  const int j = ((warp % WU) * UW + lane % UW) * TU;
  const int r0 = ((warp / WU) * RW + lane / UW) * TR;

  StreamAcc<TR, TU> acc;
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int u = 0; u < TU; ++u)
      acc.r[r][u] = acc.z[r][u] = acc.xn[r][u] = acc.hn[r][u] = 0.0f;

  // One barrier a round of KS chunks, group g taking chunk c0 + g: after
  // it, every group is done with the last round's chunks, whose stages the
  // copies of the round after this one then refill; a chunk is read once
  // its own barrier completes.
  for (int c0 = 0; c0 < n_chunks; c0 += KS) {
    __syncthreads();
    for (int c = c0 + S - KS; c < c0 + S; ++c) load_chunk(c);
    const int c = c0 + g;
    if (c < n_chunks) {
      mbar_wait(bars + c % S, (c / S) & 1);
      stream_chunk_at(acc, c * kStreamChunk >= Dp,
                      tile + c * kStreamChunk * M + r0,
                      ring + (c % S) * ce + j, M, Hp);
    }
  }
  allow_next_step();
  __syncthreads();              // every read of the tile and ring is done

  // The groups' sums meet in the ring, [KS][4][TR][TU][NB], and group 0
  // adds them in group order.
  if constexpr (KS > 1) {
    auto reduce = [&](float(&v)[TR][TU], int part, bool put) {
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int u = 0; u < TU; ++u) {
          const int q = (part * TR + r) * TU + u;
          if (put) {
            ring[(g * 4 * TR * TU + q) * NB + b] = v[r][u];
          } else {
            float x = ring[q * NB + b];
            for (int h = 1; h < KS; ++h)
              x += ring[(h * 4 * TR * TU + q) * NB + b];
            v[r][u] = x;
          }
        }
    };
    reduce(acc.r, 0, true);
    reduce(acc.z, 1, true);
    reduce(acc.xn, 2, true);
    reduce(acc.hn, 3, true);
    __syncthreads();
    if (g == 0) {
      reduce(acc.r, 0, false);
      reduce(acc.z, 1, false);
      reduce(acc.xn, 2, false);
      reduce(acc.hn, 3, false);
    }
  }

  // GRU update of the thread's units and rows (group 0), in place in the
  // tile's state rows and in the state scratch; the biases added here.  Pad
  // units (zero weights and biases) stay zero.
  float* hs = tile + Dp * M;
  float* hg = a.h + (i64)i * Hp * Bp + row0;
  const float* bih = bias;
  const float* bhh = bias + 3 * H;
  if (g == 0) {
#pragma unroll
    for (int u = 0; u < TU; ++u) {
      const int uj = j + u;
      const bool on = uj < H;
      const float br = on ? bih[uj] + bhh[uj] : 0.0f;
      const float bz = on ? bih[H + uj] + bhh[H + uj] : 0.0f;
      const float bxn = on ? bih[2 * H + uj] : 0.0f;
      const float bhn = on ? bhh[2 * H + uj] : 0.0f;
#pragma unroll
      for (int q = 0; q < TR / 4; ++q) {
        float* hq = hs + uj * M + r0 + 4 * q;
        const float4 hv = *reinterpret_cast<const float4*>(hq);
        const float hp[4] = {hv.x, hv.y, hv.z, hv.w};
        float o[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = 4 * q + r;
          const float rr = sigmoid_f(acc.r[row][u] + br);
          const float zz = sigmoid_f(acc.z[row][u] + bz);
          const float nn =
              tanhf(acc.xn[row][u] + bxn + rr * (acc.hn[row][u] + bhn));
          o[r] = carry<W>((1.0f - zz) * nn + zz * hp[r]);
        }
        const float4 ov = make_float4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<float4*>(hq) = ov;
        *reinterpret_cast<float4*>(hg + (i64)uj * Bp + r0 + 4 * q) = ov;
      }
    }
  }
  __syncthreads();

  // Readout of the M x O outputs, each by L neighbouring lanes (L the
  // largest power of two up to 32 that still gives every output its lanes
  // in one round; 1 when there are more outputs than threads): lane q sums
  // k = q, q + L, ... over four partial sums, and the L lanes add theirs
  // by shuffles in a fixed order.  Outputs (row, column), rows fastest.
  const int n_out = M * O;
  int L = 1;
  while (L < 32 && n_out * L * 2 <= nth) L *= 2;
  const int span = ((n_out * L + nth - 1) / nth) * nth;
  float* xn = a.x + (i64)((t + 1) & 1) * Dp * Bp;
  for (int e = tid; e < span; e += nth) {
    const int o = e / L, q = e % L;
    const bool on = o < n_out;
    const int m = on ? o % M : 0, c = on ? o / M : 0;
    const float* w = ro + c * ldr;
    const float* hv = hs + m;
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    if (on) {
      int k = q;
      for (; k + 3 * L < H; k += 4 * L) {
        s0 = fmaf(hv[k * M], w[k], s0);
        s1 = fmaf(hv[(k + L) * M], w[k + L], s1);
        s2 = fmaf(hv[(k + 2 * L) * M], w[k + 2 * L], s2);
        s3 = fmaf(hv[(k + 3 * L) * M], w[k + 3 * L], s3);
      }
      for (; k < H; k += L) s0 = fmaf(hv[k * M], w[k], s0);
    }
    float v = (s0 + s1) + (s2 + s3);
    for (int d = 1; d < L; d *= 2) v += __shfl_xor_sync(0xffffffffu, v, d);
    if (!on || q != 0) continue;
    const int col = i * O + c, row = row0 + m;
    v += bias[6 * H + c];
    if (row < a.B) {
      const i64 off = ((i64)row * a.T + t) * D + col;
      if (a.noise != nullptr) v += a.noise_scale * carry<W>(a.noise[off]);
      v = carry<W>(v);
      a.out[off] = v;
    }
    xn[(i64)col * Bp + row] = v;
  }
}

template <int TR, int TU, int KS, typename W>
__global__ void __launch_bounds__(stream_max_threads(TR, TU))
crvae_free_run_kernel(StreamArgs<W> a, int t) {
  stream_step<TR, TU, KS, W>(a, t);
}

template <int TR, int TU, int KS, typename W>
__global__ void __launch_bounds__(stream_max_threads(TR, TU))
errvae_sample_kernel(StreamArgs<W> a, int t) {
  stream_step<TR, TU, KS, W>(a, t);
}

// Whether the streamed kernels take a launch of these sizes: a tile of
// kStreamTiles, the scratch padded to whole tiles, thread tiles that cover
// whole warps, threads within the instantiation's bound.
bool stream_ok(int B, int Bp, int T, int P, int H, int O, int M) {
  bool tile = false;
  for (int m : kStreamTiles) tile = tile || m == M;
  int RW, UW;
  return tile && B >= 1 && T >= 1 && P >= 1 && P <= 65535 && H >= 1 &&
         O >= 1 && Bp == round_up(B, M) && stream_layout(M, H, RW, UW) &&
         stream_threads(M, H) <=
             stream_max_threads(stream_rows(M), stream_units(M));
}

// The T launches of one call, on one stream, with no host synchronisation.
// Steps after the first are programmatic dependent launches of the step
// before (each waits for it in wait_prior_step); the first waits for the
// stream's earlier work, which wrote the packed weights it reads at once.
template <int TR, int TU, int KS, typename W>
cudaError_t launch_stream(bool crvae, const StreamArgs<W>& a,
                          cudaStream_t s) {
  void (*kern)(StreamArgs<W>, int) =
      crvae ? &crvae_free_run_kernel<TR, TU, KS, W>
            : &errvae_sample_kernel<TR, TU, KS, W>;
  const size_t smem = stream_smem_bytes(a.M, a.P * a.O, a.H, a.O);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)(a.Bp / a.M), (unsigned)a.P);
  cfg.blockDim = dim3((unsigned)stream_threads(a.M, a.H));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  for (int t = 0; t < a.T; ++t) {
    cfg.numAttrs = t > 0 ? 1 : 0;
    e = cudaLaunchKernelEx(&cfg, kern, a, t);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// One call: T launches at the tile of a.M.
template <typename W>
int launch_streamed(bool crvae, const StreamArgs<W>& a, void* stream) {
  if (!stream_ok(a.B, a.Bp, a.T, a.P, a.H, a.O, a.M))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.M >= 16) return (int)launch_stream<8, 2, 1, W>(crvae, a, s);
  if (a.M == 8) return (int)launch_stream<4, 2, 2, W>(crvae, a, s);
  return (int)launch_stream<4, 1, 4, W>(crvae, a, s);
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
  if (!half) return vcx::fwd_weights_floats(D, H);
  return ((i64)(D + H) * res_weight_stride(H, true) / 2 + 3) & ~3LL;
}

// Layout in shared memory (floats), every region 16-byte aligned:
//   w   [nh][res_weights_floats(D, H)]  W_ih^T then W_hh^T of each head,
//                                       rows at res_weight_stride(H)
//   ro  [nh * O][res_row_ld(H)]         readout rows, zero past H
//   rob [nh * O]                        readout biases
//   x   [2][D][bt]                      the step's input, transposed
//   h   [2][nh][res_row_ld(H)][bt]      each head's state, transposed
//   nz  [2][nh * O][bt]                 a step's noise columns (if noise)
// x and h are read as float4s of 4 rows, as B1 reads them.
__host__ __device__ inline i64 resident_smem_floats(int nh, int bt, int D,
                                                    int H, int O,
                                                    bool noise) {
  return nh * res_weights_floats(D, H, false) +
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
// stride ld, zeros in the pad unit's columns: gru_fwd.cuh's staging.
__device__ inline void stage_transposed(float* dst, const float* src, int H,
                                        int cols, int ld) {
  vcx::fwd_stage_transposed(dst, src, H, cols, ld);
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
// tiles, the k of a step split over S lanes; instantiated for float32
// weights (bf16 ones run mma_body); kResidentThreads threads, dynamic
// shared memory resident_smem_floats(a.nh, a.bt, P * O, a.H, a.O, noise
// buffers: K1).
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

// ---- Resident route, bf16: the tensor-core body ------------------------------

// Threads of a bf16 resident block: 24 warps that take the step's items (16
// rows x 8 units of one head) in turn; one block an SM, at most 85
// registers a thread.
constexpr int kMmaThreads = 768;
// An item's rows (an mma's m), units (its n) and an mma's k.
constexpr int kMmaRows = 16, kMmaUnits = 8, kMmaK = 16;

// The input and state widths rounded up to an mma's k; the units of a gate
// rounded up to an item's.
__host__ __device__ inline int mma_kx(int D) { return round_up(D, kMmaK); }
__host__ __device__ inline int mma_kh(int H) { return round_up(H, kMmaK); }
__host__ __device__ inline int mma_units(int H) {
  return round_up(H, kMmaUnits);
}
// Row stride (bf16 elements) of rows of n elements, n a multiple of 16: 8
// past it, so that rows start 4 words apart modulo 8 and the 8 rows an
// ldmatrix phase reads meet in disjoint banks.
__host__ __device__ inline int mma_ld(int n) { return n + 8; }
__host__ __device__ inline i64 round16(i64 n) { return (n + 15) & ~15LL; }

// Layout in shared memory (bytes), every region 16-byte aligned:
//   w    [nh][3][Hu][mma_ld(Kx + Kh)] bf16  row (gate, unit) of each head:
//        [W_ih row | 0 to Kx | W_hh row | 0 to Kx + Kh]; zero rows past H
//   bias [nh][4][Hu] float  r and z (b_ih + b_hh), n's input and hidden
//        parts; zero past H
//   ro   K1: [nh * O][round4(H)] float  readout rows, zero past H;
//        K2: [round8(O)][mma_ld(Kh)] bf16  readout rows as the readout
//        mma's B operand, zero past H and O
//   rob  [nh * O] float             readout biases
//   x    [2][bt][mma_ld(Kx)] bf16   the step's input rows, zero past D
//   h    [2][nh][bt][mma_ld(Kh)] bf16  each head's state rows, zero past H
//   nz   [2][nh * O][bt] float      a step's noise columns (if noise)
// (Hu = mma_units(H), Kx = mma_kx(D), Kh = mma_kh(H).)
__host__ __device__ inline i64 mma_w_bytes(int nh, int D, int H) {
  return round16((i64)nh * 3 * mma_units(H) * mma_ld(mma_kx(D) + mma_kh(H)) *
                 2);
}
__host__ __device__ inline i64 mma_bias_bytes(int nh, int H) {
  return round16((i64)nh * 4 * mma_units(H) * 4);
}
__host__ __device__ inline i64 mma_ro_rows_bytes(int nh, int H, int O,
                                                 bool k1) {
  return k1 ? round16((i64)nh * O * vcx::round4(H) * 4)
            : round16((i64)round_up(O, kMmaUnits) * mma_ld(mma_kh(H)) * 2);
}
__host__ __device__ inline i64 mma_ro_bytes(int nh, int H, int O, bool k1) {
  return mma_ro_rows_bytes(nh, H, O, k1) + round16((i64)nh * O * 4);
}
__host__ __device__ inline i64 mma_x_bytes(int bt, int D) {
  return round16(2LL * bt * mma_ld(mma_kx(D)) * 2);
}
__host__ __device__ inline i64 mma_h_bytes(int nh, int bt, int H) {
  return round16(2LL * nh * bt * mma_ld(mma_kh(H)) * 2);
}
// k1: K1's block (float32 readout rows, noise buffers), else K2's.
__host__ __device__ inline i64 mma_smem_bytes(int nh, int bt, int D, int H,
                                              int O, bool k1) {
  return mma_w_bytes(nh, D, H) + mma_bias_bytes(nh, H) +
         mma_ro_bytes(nh, H, O, k1) + mma_x_bytes(bt, D) +
         mma_h_bytes(nh, bt, H) + (k1 ? 2LL * nh * O * bt * 4 : 0);
}

// Four (x4) or two (x2) 8 x 8 bf16 matrices from shared memory, each
// lane's fragment in the layout mma.sync takes; lane l gives the address
// of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p))
               : "memory");
}

// c += A B over one k16: A 16 x 16 (a), B 16 x 8 (b0, b1), float32 sums.
__device__ __forceinline__ void mma16816(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One k span (n_k, a multiple of 16) of an item's r, z and n products.
// act: this lane's ldmatrix row of the 16-row activation tile at the span's
// first k; wrz, wn: its rows of the r and z weights (x4) and of the n
// weights (x2) at that k.
__device__ __forceinline__ void mma_span(float (&r)[4], float (&z)[4],
                                         float (&n)[4], const bf16* act,
                                         const bf16* wrz, const bf16* wn,
                                         int n_k) {
#pragma unroll 2
  for (int k = 0; k < n_k; k += kMmaK) {
    unsigned a[4], b[4], c[2];
    ldsm_x4(a, act + k);
    ldsm_x4(b, wrz + k);
    ldsm_x2(c, wn + k);
    mma16816(r, a, b[0], b[1]);
    mma16816(z, a, b[2], b[3]);
    mma16816(n, a, c[0], c[1]);
  }
}

// A warp's item: head hl of the block, rows [16 mt, 16 mt + 16) of the
// tile, units [8 ug, 8 ug + 8) of each gate.
struct MmaItem {
  int hl, mt, ug;
};
__device__ __forceinline__ MmaItem mma_item(int it, int n_mt, int n_ug) {
  return {it / (n_mt * n_ug), (it / n_ug) % n_mt, it % n_ug};
}

// An item's sums in a lane: r, z and the input and hidden parts of n, at
// (row g, unit 2 q), (g, 2 q + 1), (g + 8, 2 q), (g + 8, 2 q + 1) of its
// tile, g = lane / 4, q = lane % 4.
struct MmaAcc {
  float r[4], z[4], xn[4], hn[4];
};

// The GRU update of a lane's rows row, row + 8 and units u, u + 1: h_prev
// from hp, the new state rounded to bf16 into ho (row stride ld); units
// past H stay zero.  The rows from row - row % 8 + live on are not live
// (past the batch): a half of the tile with none live is skipped by the
// whole warp, and its rows keep their old (finite) state.
__device__ __forceinline__ void mma_update(const MmaAcc& c, const bf16* hp,
                                           bf16* ho, int row, int u, int H,
                                           int ld, int live) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (8 * half >= live) break;
    const int m = row + 8 * half;
    const float2 hv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(hp + m * ld + u));
    const float h2[2] = {hv.x, hv.y};
    float o[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int e = 2 * half + j;
      const float rr = sigmoid_f(c.r[e]), zz = sigmoid_f(c.z[e]);
      const float nn = tanhf(c.xn[e] + rr * c.hn[e]);
      o[j] = u + j < H ? (1.0f - zz) * nn + zz * h2[j] : 0.0f;
    }
    *reinterpret_cast<__nv_bfloat162*>(ho + m * ld + u) =
        __floats2bfloat162_rn(o[0], o[1]);
  }
}

// cp.async of N (4, 8 or 16) bytes, both ends N-byte aligned.
template <int N>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(N)
               : "memory");
}

// Copy `rows` rows of n bf16 (source row stride n) into dst rows of stride
// ws (16-byte aligned): by cp.async in pieces of the widest of 16, 8 and 4
// bytes that the source rows' alignment allows, one element at a time for
// odd n.  Every thread's copies are in flight at once.
__device__ inline void mma_stage_rows(bf16* dst, int ws, const bf16* src,
                                      int rows, int n) {
  const size_t at = reinterpret_cast<size_t>(src);
  int piece = 1;                                   // elements a copy
  for (int e = 8; e >= 2; e /= 2)
    if (n % e == 0 && at % (2 * e) == 0) {
      piece = e;
      break;
    }
  const int per_row = n / piece;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, k = e % per_row * piece;
    bf16* d = dst + (i64)r * ws + k;
    const bf16* s = src + (i64)r * n + k;
    if (piece == 8)
      cp_async_n<16>(d, s);
    else if (piece == 4)
      cp_async_n<8>(d, s);
    else if (piece == 2)
      cp_async_n<4>(d, s);
    else
      *d = *s;
  }
}

// Stage the block's heads' weights (see the layout above) into w, whose
// pads the caller has zeroed: each head's 3H rows of W_ih and of W_hh,
// untransposed, gate g's rows at g Hu.
__device__ inline void mma_stage_weights(bf16* w, const ResidentArgs<bf16>& a,
                                         int head0, int nh, int D) {
  const int H = a.H, G = 3 * H, Kx = mma_kx(D), Hu = mma_units(H);
  const int ws = mma_ld(Kx + mma_kh(H));
  for (int i = 0; i < nh; ++i)
    for (int g = 0; g < 3; ++g) {
      bf16* dst = w + (i64)((i * 3 + g) * Hu) * ws;
      const i64 row = (i64)(head0 + i) * G + g * H;
      mma_stage_rows(dst, ws, a.w_ih + row * D, H, D);
      mma_stage_rows(dst + Kx, ws, a.w_hh + row * H, H, H);
    }
}

// What a lane of mma_body needs for an item: the block's weights, biases
// and buffers, their row strides and widths, and its ldmatrix offsets.
struct MmaLane {
  const bf16* w;        // weights, rows at ws
  const float* bias;    // [nh][4][Hu]
  bf16* xs;             // x buffers, rows at xld, xbuf apart
  bf16* hs;             // state buffers, rows at hld, hbuf apart
  int ws, xld, hld, xbuf, hbuf, bt, H, Hu, Kx, Kh;
  int a_row, a_off;     // the lane's row and k offset in an activation tile
  int rz_off, n_off;    // its rows in the r and z (x4) and n (x2) weights
  int g_row, g_unit;    // its first row and unit of an item's sums
};

// An item's hidden half: its sums from the biases, then W_hh h from state
// buffer k.
__device__ __forceinline__ void mma_hidden_half(const MmaLane& l, MmaAcc& c,
                                                const MmaItem& q, int k) {
  const float* bb = l.bias + q.hl * 4 * l.Hu + q.ug * kMmaUnits + l.g_unit;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    c.r[e] = bb[e & 1];
    c.z[e] = bb[l.Hu + (e & 1)];
    c.xn[e] = bb[2 * l.Hu + (e & 1)];
    c.hn[e] = bb[3 * l.Hu + (e & 1)];
  }
  const bf16* wq =
      l.w + (i64)(q.hl * 3 * l.Hu + q.ug * kMmaUnits) * l.ws + l.Kx;
  mma_span(c.r, c.z, c.hn,
           l.hs + k * l.hbuf + (q.hl * l.bt + q.mt * kMmaRows + l.a_row) *
                                   l.hld + l.a_off,
           wq + l.rz_off, wq + l.n_off, l.Kh);
}

// An item's input half (W_ih x from x buffer k) and its GRU update into
// state buffer k ^ 1, ``live`` rows of the tile live.
__device__ __forceinline__ void mma_input_half(const MmaLane& l, MmaAcc& c,
                                               const MmaItem& q, int k,
                                               int live) {
  const bf16* wq = l.w + (i64)(q.hl * 3 * l.Hu + q.ug * kMmaUnits) * l.ws;
  mma_span(c.r, c.z, c.xn,
           l.xs + k * l.xbuf + (q.mt * kMmaRows + l.a_row) * l.xld + l.a_off,
           wq + l.rz_off, wq + l.n_off, l.Kx);
  const int hb = q.hl * l.bt * l.hld;
  mma_update(c, l.hs + k * l.hbuf + hb, l.hs + (k ^ 1) * l.hbuf + hb,
             q.mt * kMmaRows + l.g_row, q.ug * kMmaUnits + l.g_unit, l.H,
             l.hld, live - q.mt * kMmaRows);
}

// One block (K2) or one block of a cluster (K1, CLUSTER) over its batch
// tiles of bt rows (a multiple of 16), bf16 weights, on the tensor cores
// (see the note at the head of this file); kMmaThreads threads, dynamic
// shared memory mma_smem_bytes(a.nh, a.bt, P * O, a.H, a.O, noise: K1).
template <bool CLUSTER>
__device__ void mma_body(const ResidentArgs<bf16>& a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int H = a.H, O = a.O, D = a.P * O, G = 3 * H, T = a.T, bt = a.bt;
  const int Kx = mma_kx(D), Kh = mma_kh(H), Hu = mma_units(H);
  const int H4 = vcx::round4(H);
  const int ws = mma_ld(Kx + Kh), xld = mma_ld(Kx), hld = mma_ld(Kh);
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
  unsigned char* at = mma_smem;
  bf16* w = reinterpret_cast<bf16*>(at);
  at += mma_w_bytes(a.nh, D, H);
  float* bias = reinterpret_cast<float*>(at);
  at += mma_bias_bytes(a.nh, H);
  float* ro = reinterpret_cast<float*>(at);   // K1
  bf16* rw = reinterpret_cast<bf16*>(at);     // K2
  float* rob = reinterpret_cast<float*>(at + mma_ro_rows_bytes(a.nh, H, O,
                                                               CLUSTER));
  at += mma_ro_bytes(a.nh, H, O, CLUSTER);
  bf16* xs = reinterpret_cast<bf16*>(at);
  at += mma_x_bytes(bt, D);
  bf16* hs = reinterpret_cast<bf16*>(at);
  at += mma_h_bytes(a.nh, bt, H);
  float* nz = reinterpret_cast<float*>(at);
  const int xbuf = bt * xld, hbuf = a.nh * bt * hld, nbuf = a.nh * O * bt;

  // Zero everything from the weights to the state buffers: the weights'
  // and the buffers' pads (columns past D and H, units past H), which no
  // copy or step writes.
  {
    uint4* z = reinterpret_cast<uint4*>(mma_smem);
    const i64 n = (at - mma_smem) / 16;
    for (i64 e = threadIdx.x; e < n; e += blockDim.x)
      z[e] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  mma_stage_weights(w, a, head0, nh, D);
  for (int e = threadIdx.x; e < nh * Hu; e += blockDim.x) {
    const int i = e / Hu, u = e % Hu;
    const bf16* bih = a.b_ih + (i64)(head0 + i) * G;
    const bf16* bhh = a.b_hh + (i64)(head0 + i) * G;
    float* bb = bias + i * 4 * Hu + u;
    const bool on = u < H;
    bb[0] = on ? to_f(bih[u]) + to_f(bhh[u]) : 0.0f;
    bb[Hu] = on ? to_f(bih[H + u]) + to_f(bhh[H + u]) : 0.0f;
    bb[2 * Hu] = on ? to_f(bih[2 * H + u]) : 0.0f;
    bb[3 * Hu] = on ? to_f(bhh[2 * H + u]) : 0.0f;
  }
  if constexpr (CLUSTER) {
    for (int e = threadIdx.x; e < ncols * H4; e += blockDim.x) {
      const int k = e % H4, c = e / H4;
      ro[e] = k < H ? to_f(a.ro_w[(i64)(col0 + c) * H + k]) : 0.0f;
    }
  } else {
    mma_stage_rows(rw, hld, a.ro_w, O, H);
  }
  vcx::cp_async_commit();
  for (int e = threadIdx.x; e < ncols; e += blockDim.x)
    rob[e] = to_f(a.ro_b[col0 + e]);
  // The weights have landed; K1 then waits for every block of the cluster,
  // so that no peer's readout writes into x before it is zeroed.
  vcx::cp_async_wait_all();
  if constexpr (CLUSTER) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5, n_ug = Hu / kMmaUnits;
  // This lane's ldmatrix rows: of the activation tile (matrices rows 0-7 /
  // 8-15 at k, then at k + 8), of the r and z weights (r at k, r at k + 8,
  // z at k, z at k + 8) and of the n weights (at k, at k + 8).
  const MmaLane l{w, bias, xs, hs, ws, xld, hld, xbuf, hbuf, bt, H, Hu, Kx,
                  Kh, lane & 15, (lane >> 4) * 8,
                  ((lane >> 4) * Hu + (lane & 7)) * ws + ((lane >> 3) & 1) * 8,
                  (2 * Hu + (lane & 7)) * ws + ((lane >> 3) & 1) * 8,
                  lane >> 2, 2 * (lane & 3)};

  const int n_tiles = (a.B + bt - 1) / bt;
  for (int tile = group; tile < n_tiles; tile += n_groups) {
    // Items of the tile's 16-row groups that hold a live row (past the
    // batch, a tile's rows are not live and cost no work).
    const int row0 = tile * bt, live = min(bt, a.B - row0);
    const int n_mt = (live + kMmaRows - 1) / kMmaRows;
    const int n_items = nh * n_mt * n_ug;
    if (a.noise != nullptr) prefetch_noise(nz, a, col0, ncols, row0, 0);
    for (int e = threadIdx.x; e < nh * bt * H; e += blockDim.x) {
      const int k = e % H, b = e / H % bt, i = e / (H * bt);
      hs[(i * bt + b) * hld + k] = __float2bfloat16_rn(
          b < live ? a.h0[(i64)(row0 + b) * H + k] : 0.0f);
    }
    for (int e = threadIdx.x; e < bt * D; e += blockDim.x) {
      const int c = e % D, b = e / D;
      xs[b * xld + c] = __float2bfloat16_rn(
          a.x0 != nullptr && b < live ? a.x0[(i64)(row0 + b) * D + c] : 0.0f);
    }
    vcx::cp_async_wait_all();
    __syncthreads();

    // A step: a warp's first item's hidden half; the wait for the last
    // step's readout (K1: the cluster barrier it arrived at, x_t is then in
    // every block; K2: a block barrier); the input half and update of that
    // item and the whole of the warp's other items; a block barrier; the
    // readout of x_{t+1} into every block for the tile's live rows, by the
    // block's last threads first, so that at a small batch warps without
    // items take it while the others start the next step's hidden half;
    // then (K1) arrive.
    for (int t = 0, k = 0; t < T; ++t, k ^= 1) {
      MmaAcc c;
      MmaItem q = mma_item(warp, n_mt, n_ug);
      if (warp < n_items) mma_hidden_half(l, c, q, k);
      if constexpr (CLUSTER) {
        if (t > 0) cluster_wait();
      }
      if constexpr (!CLUSTER) {
        if (t > 0) __syncthreads();
      }
      if (a.noise != nullptr && t + 1 < T)
        prefetch_noise(nz + (k ^ 1) * nbuf, a, col0, ncols, row0, t + 1);
      for (int it = warp; it < n_items; it += n_warps) {
        if (it != warp) {
          q = mma_item(it, n_mt, n_ug);
          mma_hidden_half(l, c, q, k);
        }
        mma_input_half(l, c, q, k, live);
      }
      if (a.noise != nullptr) {   // this step's noise has landed
        if (t + 1 < T)
          vcx::cp_async_wait_one();
        else
          vcx::cp_async_wait_all();
      }
      __syncthreads();

      // The readout of x_{t+1}, by the block's last threads or warps
      // first.  K2: on the tensor cores, an item (16 rows, 8 outputs) a
      // warp, the sums from the readout biases.  K1 (one output a head):
      // (column, row) a thread, rows fastest, four partial sums over k in
      // resident_body's order; stored into every block of the cluster.
      if constexpr (!CLUSTER) {
        const int n_ot = (O + kMmaUnits - 1) / kMmaUnits;
        for (int it = n_warps - 1 - warp; it < n_mt * n_ot; it += n_warps) {
          const int mt = it / n_ot, u0 = it % n_ot * kMmaUnits;
          float acc[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = u0 + l.g_unit + (e & 1);
            acc[e] = col < O ? rob[col] : 0.0f;
          }
          const bf16* act = hs + (k ^ 1) * hbuf +
                            (mt * kMmaRows + l.a_row) * hld + l.a_off;
          const bf16* wr = rw + (u0 + (lane & 7)) * hld + ((lane >> 3) & 1) * 8;
          for (int kk = 0; kk < Kh; kk += kMmaK) {
            unsigned af[4], bf[2];
            ldsm_x4(af, act + kk);
            ldsm_x2(bf, wr + kk);
            mma16816(acc, af, bf[0], bf[1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = mt * kMmaRows + l.g_row + 8 * (e >> 1);
            const int col = u0 + l.g_unit + (e & 1);
            if (row >= live || col >= O) continue;
            const float v = carry<bf16>(acc[e]);
            a.out[((i64)(row0 + row) * T + t) * D + col] = v;
            xs[(k ^ 1) * xbuf + row * xld + col] = __float2bfloat16_rn(v);
          }
        }
      } else {
        for (int e = blockDim.x - 1 - threadIdx.x; e < ncols * live;
             e += blockDim.x) {
          const int b = e % live, c = e / live;
          const bf16* hv = hs + (k ^ 1) * hbuf + (c * bt + b) * hld;
          const float* wv = ro + c * H4;
          float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
          int j = 0;
          for (; j + 8 <= H; j += 8) {
            const uint4 h8 = *reinterpret_cast<const uint4*>(hv + j);
            const float4 w0 = *reinterpret_cast<const float4*>(wv + j);
            const float4 w1 = *reinterpret_cast<const float4*>(wv + j + 4);
            // A bf16 is the high half of its float32: element 2 p in the
            // low half of word p, 2 p + 1 in the high half.
            const unsigned hw[4] = {h8.x, h8.y, h8.z, h8.w};
            float hf[8];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              hf[2 * p] = __uint_as_float(hw[p] << 16);
              hf[2 * p + 1] = __uint_as_float(hw[p] & 0xffff0000u);
            }
            s0 = fmaf(hf[0], w0.x, s0);
            s1 = fmaf(hf[1], w0.y, s1);
            s2 = fmaf(hf[2], w0.z, s2);
            s3 = fmaf(hf[3], w0.w, s3);
            s0 = fmaf(hf[4], w1.x, s0);
            s1 = fmaf(hf[5], w1.y, s1);
            s2 = fmaf(hf[6], w1.z, s2);
            s3 = fmaf(hf[7], w1.w, s3);
          }
          for (; j + 4 <= H; j += 4) {
            s0 = fmaf(to_f(hv[j]), wv[j], s0);
            s1 = fmaf(to_f(hv[j + 1]), wv[j + 1], s1);
            s2 = fmaf(to_f(hv[j + 2]), wv[j + 2], s2);
            s3 = fmaf(to_f(hv[j + 3]), wv[j + 3], s3);
          }
          for (; j < H; ++j) s0 = fmaf(to_f(hv[j]), wv[j], s0);
          float v = (s0 + s1) + (s2 + s3) + rob[c];
          if (a.noise != nullptr)
            v += a.noise_scale * carry<bf16>(nz[k * nbuf + c * bt + b]);
          v = carry<bf16>(v);
          const int col = col0 + c;
          a.out[((i64)(row0 + b) * T + t) * D + col] = v;
          const bf16 xv = __float2bfloat16_rn(v);
          bf16* dst = xs + (k ^ 1) * xbuf + b * xld + col;
          cg::cluster_group cl = cg::this_cluster();
          for (int r = 0; r < size; ++r) *cl.map_shared_rank(dst, r) = xv;
        }
      }
      if constexpr (CLUSTER) {
        cluster_arrive();
        // After the tile's last step, every peer's stores have landed and
        // its reads are done before this block starts the next tile's
        // buffers or exits.
        if (t + 1 == T) cluster_wait();
      } else {
        if (t + 1 == T) __syncthreads();
      }
    }
  }
}

__global__ void __launch_bounds__(kMmaThreads, 1)
crvae_free_run_mma_kernel(ResidentArgs<bf16> a) {
  mma_body<true>(a);
}

__global__ void __launch_bounds__(kMmaThreads, 1)
errvae_sample_mma_kernel(ResidentArgs<bf16> a) {
  mma_body<false>(a);
}

// ---- Resident launches -------------------------------------------------------

// Whether a resident launch of these sizes is one the float32 kernels take:
// bt a multiple of 4, a split of 2 or 4 whose gate tiles fit the block.
bool resident_ok(int B, int T, int H, int nh, int bt, int split) {
  return B >= 1 && T >= 1 && H >= 1 && bt >= 4 && bt % 4 == 0 &&
         (split == 2 || split == 4) &&
         gate_threads(nh, bt, H, split) <= kResidentThreads;
}

template <typename W>
using ResidentKernel = void (*)(ResidentArgs<W>);

// What a resident launch runs for weights of type W: its kernels, their
// threads and shared memory, and whether they take the launch's sizes.
// float32: resident_body at a k split of 2 or 4; bf16: mma_body, which
// splits no k (split 0) and takes tiles of a multiple of 16 rows.
template <typename W>
struct Resident;
template <>
struct Resident<float> {
  static constexpr int kThreads = kResidentThreads;
  static ResidentKernel<float> crvae(int split) {
    return split == 4 ? crvae_free_run_resident_kernel<4, float>
                      : crvae_free_run_resident_kernel<2, float>;
  }
  static ResidentKernel<float> errvae(int split) {
    return split == 4 ? errvae_sample_resident_kernel<4, float>
                      : errvae_sample_resident_kernel<2, float>;
  }
  static bool ok(int B, int T, int H, int nh, int bt, int split) {
    return resident_ok(B, T, H, nh, bt, split);
  }
  static size_t smem(int nh, int bt, int D, int H, int O, bool noise) {
    return resident_smem_floats(nh, bt, D, H, O, noise) *
           sizeof(float);
  }
};
template <>
struct Resident<bf16> {
  static constexpr int kThreads = kMmaThreads;
  static ResidentKernel<bf16> crvae(int) { return crvae_free_run_mma_kernel; }
  static ResidentKernel<bf16> errvae(int) { return errvae_sample_mma_kernel; }
  static bool ok(int B, int T, int H, int, int bt, int split) {
    return B >= 1 && T >= 1 && H >= 1 && bt >= kMmaRows &&
           bt % kMmaRows == 0 && split == 0;
  }
  static size_t smem(int nh, int bt, int D, int H, int O, bool noise) {
    return (size_t)mma_smem_bytes(nh, bt, D, H, O, noise);   // noise: K1
  }
};

// Set K1's shared-memory limit (and, above 8 blocks, its non-portable
// cluster permission) and fill a launch configuration with the cluster
// dimension in attr.  K1's blocks always hold the noise buffers.
template <typename W>
cudaError_t cluster_config(ResidentKernel<W> kern, const ResidentArgs<W>& a,
                           int cluster, int n_clusters, cudaStream_t s,
                           cudaLaunchConfig_t& cfg,
                           cudaLaunchAttribute& attr) {
  const size_t smem = Resident<W>::smem(a.nh, a.bt, a.P, a.H, 1, true);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(n_clusters * cluster));
  cfg.blockDim = dim3(Resident<W>::kThreads);
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
                   const void* w, const void* b_ih, const void* b_hh,
                   const void* ro_w, const void* ro_b, float* out,
                   float* h_scratch, float* x_scratch, int B, int T, int P,
                   int H, float noise_scale, int M, void* stream) {
  const StreamArgs<W> a{
      x0, h0, noise, static_cast<const float*>(w),
      static_cast<const W*>(b_ih), static_cast<const W*>(b_hh),
      static_cast<const W*>(ro_w),
      static_cast<const W*>(ro_b), out, h_scratch, x_scratch, B,
      M > 0 ? round_up(B, M) : 0, T, P, H, 1, M, noise_scale};
  return launch_streamed(true, a, stream);
}

template <typename W>
int errvae_streamed(const float* h0, const void* w, const void* b_ih,
                    const void* b_hh, const void* ro_w, const void* ro_b,
                    float* out, float* h_scratch, float* x_scratch, int B,
                    int T, int D, int H, int M, void* stream) {
  const StreamArgs<W> a{
      nullptr, h0, nullptr, static_cast<const float*>(w),
      static_cast<const W*>(b_ih), static_cast<const W*>(b_hh),
      static_cast<const W*>(ro_w), static_cast<const W*>(ro_b), out,
      h_scratch, x_scratch, B, M > 0 ? round_up(B, M) : 0, T, 1, H, D, M,
      0.0f};
  return launch_streamed(false, a, stream);
}

template <typename W>
int crvae_resident(const float* x0, const float* h0, const float* noise,
                   const void* w_ih, const void* w_hh, const void* b_ih,
                   const void* b_hh, const void* ro_w, const void* ro_b,
                   float* out, int B, int T, int P, int H, float noise_scale,
                   int cluster, int bt, int split, int n_clusters,
                   void* stream) {
  if (cluster < 1 || cluster > P || n_clusters < 1 ||
      !Resident<W>::ok(B, T, H, (P + cluster - 1) / cluster, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a =
      crvae_args<W>(x0, h0, noise, w_ih, w_hh, b_ih, b_hh, ro_w, ro_b, out, B,
                    T, P, H, noise_scale, cluster, bt);
  const ResidentKernel<W> kern = Resident<W>::crvae(split);
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
      !Resident<W>::ok(1, 1, H, (P + cluster - 1) / cluster, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a =
      crvae_args<W>(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                    nullptr, nullptr, nullptr, nullptr, 1, 1, P, H, 0.0f,
                    cluster, bt);
  const ResidentKernel<W> kern = Resident<W>::crvae(split);
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
  if (D < 1 || !Resident<W>::ok(B, T, H, 1, bt, split))
    return (int)cudaErrorInvalidValue;
  const ResidentArgs<W> a{
      nullptr, h0, nullptr, static_cast<const W*>(w_ih),
      static_cast<const W*>(w_hh), static_cast<const W*>(b_ih),
      static_cast<const W*>(b_hh), static_cast<const W*>(ro_w),
      static_cast<const W*>(ro_b), out, B, T, 1, H, D, bt, 1, 0.0f};
  const ResidentKernel<W> kern = Resident<W>::errvae(split);
  const size_t smem = Resident<W>::smem(1, bt, D, H, D, false);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<(B + bt - 1) / bt, Resident<W>::kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry point below has a twin with the suffix _bf16 that takes the
// weights (w_ih, w_hh, b_ih, b_hh, ro_w, ro_b) as bfloat16; x0, h0 and the
// noise are float32 either way (in bf16 the kernels round them to bf16 as
// they read them), and so is the output.  The resident twins run
// mma_body: split 0 (no k split), bt a multiple of 16.

// CRVAE free run, streamed route: tiles of M rows, one block a (tile,
// head); T launches.  x0 (B, D), h0 (B, H) shared by all heads, noise
// (B, T, D); w the packed float32 weights (P, Kp, 3, Hp) (see StreamArgs);
// b (P, 3H); readout w (P, 1, H), b (P, 1).  Scratch (float32): h
// (P, Hp, Bp), x (2, Dp, Bp) zero in its pad columns, Bp = B rounded up to
// M.  Writes out (B, T, D), D = P.  Returns a cudaError_t.
int vcx_crvae_free_run_streamed(const float* x0, const float* h0,
                                const float* noise, const void* w,
                                const void* b_ih, const void* b_hh,
                                const void* ro_w, const void* ro_b,
                                float* out, float* h_scratch,
                                float* x_scratch, int B, int T, int P, int H,
                                float noise_scale, int M, void* stream) {
  return crvae_streamed<float>(x0, h0, noise, w, b_ih, b_hh, ro_w, ro_b, out,
                               h_scratch, x_scratch, B, T, P, H, noise_scale,
                               M, stream);
}
int vcx_crvae_free_run_streamed_bf16(const float* x0, const float* h0,
                                     const float* noise, const void* w,
                                     const void* b_ih, const void* b_hh,
                                     const void* ro_w, const void* ro_b,
                                     float* out, float* h_scratch,
                                     float* x_scratch, int B, int T, int P,
                                     int H, float noise_scale, int M,
                                     void* stream) {
  return crvae_streamed<bf16>(x0, h0, noise, w, b_ih, b_hh, ro_w, ro_b, out,
                              h_scratch, x_scratch, B, T, P, H, noise_scale,
                              M, stream);
}

// ErrorVAE free run from x0 = 0, streamed route (P = 1, O = D).  h0 (B, H);
// w packed (1, Kp, 3, Hp); b (3H,); readout w (D, H), b (D,); scratch as
// above.  Writes out (B, T, D).
int vcx_errvae_sample_streamed(const float* h0, const void* w,
                               const void* b_ih, const void* b_hh,
                               const void* ro_w, const void* ro_b, float* out,
                               float* h_scratch, float* x_scratch, int B,
                               int T, int D, int H, int M, void* stream) {
  return errvae_streamed<float>(h0, w, b_ih, b_hh, ro_w, ro_b, out,
                                h_scratch, x_scratch, B, T, D, H, M, stream);
}
int vcx_errvae_sample_streamed_bf16(const float* h0, const void* w,
                                    const void* b_ih, const void* b_hh,
                                    const void* ro_w, const void* ro_b,
                                    float* out, float* h_scratch,
                                    float* x_scratch, int B, int T, int D,
                                    int H, int M, void* stream) {
  return errvae_streamed<bf16>(h0, w, b_ih, b_hh, ro_w, ro_b, out, h_scratch,
                               x_scratch, B, T, D, H, M, stream);
}

// Bytes of shared memory of a streamed block of M rows at input width D,
// hidden H, O readout columns a head (the wrapper holds its own sizing to
// this), and its threads (0 where no kernel takes M), into out[2].
void vcx_streamed_block(int M, int D, int H, int O, long long* out) {
  bool tile = false;
  for (int m : kStreamTiles) tile = tile || m == M;
  out[0] = stream_smem_bytes(M, D, H, O);
  out[1] = tile ? stream_threads(M, H) : 0;
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
  if (half) {
    out[0] = (long long)Resident<bf16>::smem(nh, bt, D, H, O, noise != 0);
    out[1] = Resident<bf16>::kThreads;
  } else {
    out[0] = (long long)Resident<float>::smem(nh, bt, D, H, O, noise != 0);
    out[1] = Resident<float>::kThreads;
  }
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
