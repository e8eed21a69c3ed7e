// One whole CRVAE phase-1 training step for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU megakernel vae_connexe_tpu/ops/pallas_step.py
// (fused_phase1_step, :353; body _step_kernel, :118): encoder GRU forward,
// reparameterisation with an injected epsilon, p teacher-forced decoder
// heads, per-head readout, loss, the hand-derived backward, SGD on every
// leaf with 2*lam_ridge*w on readout.w and heads.w_hh, the parents-mask
// projection and the column-group prox on heads.w_ih, and five metrics.
//
// Design.  The TPU kernel runs its batch tiles as a sequential grid and
// accumulates gradients in scratch, updating on the last tile.  On the card
// the tiles run at once, so the step is six launches of this file's kernels
// on one stream, each writing partial sums that a later one reduces in a
// fixed order (no float atomics: the step is deterministic):
//   1. step_encoder_fwd  per batch tile: encoder GRU over enc_len steps
//      (states saved), fc_mu / fc_std, z = mu + exp(lv / 2) * eps, KL sum.
//   2. step_decoder      per (batch tile, head): the head's forward over
//      T - enc_len steps from h0 = z with the masked W_ih, readout, squared
//      error, then its backward through time; writes the head's dW/db and
//      readout partials and its d loss / d z.
//   3. step_encoder_bwd  per batch tile: dz = sum over heads, the latent
//      and KL terms, fc grads, and the encoder's backward through time.
//   4. step_update       every leaf: sum of partials, SGD (+ ridge), mask.
//   5. step_prox         per head: column-group soft-threshold of W_ih and
//      which columns survive.
//   6. step_metrics      one block: loss, recon, beta*KL, mean_loss,
//      variable_usage.
// The split follows what fits in a block: one head's weights (63 KB at
// p=20, H=64) and its gradient accumulators (62 KB) fit in shared memory,
// all p heads' (1.3 MB) do not, so a decoder block owns one head, as in
// gru.cu, whose block bodies (gru_tile.cuh) kernels 1-3 reuse.
//
// Bound.  At p=20, H=64, B=256, ctx=20 a step is ~5e9 f32 flops (the
// forward's products and the backward's two) against ~3 MB of parameters,
// batch and updated parameters: bound by f32 FMA throughput (~0.08 ms on
// an H100 SXM).  This first version is held back by the sequential time
// loops, one decoder block per SM (shared memory), and the encoder's few
// tiles.

#include "gru_tile.cuh"

namespace vcx {

// Every buffer of one step.  Outside the unnamed namespace: the C entry
// point takes it, and a type of internal linkage would give that entry
// point internal linkage too.
struct StepArgs {
  // inputs
  const float* batch;   // (B, T, p)
  const float* eps;     // (B, H)
  const float* mask;    // (p, p) parents
  const float *enc_wih, *enc_whh, *enc_bih, *enc_bhh;  // (3H,p) (3H,H) (3H) (3H)
  const float *mu_w, *mu_b, *lv_w, *lv_b;              // (H,H) (H) (H,H) (H)
  const float *hd_wih, *hd_whh, *hd_bih, *hd_bhh;      // (p,3H,p) (p,3H,H) (p,3H) (p,3H)
  const float *ro_w, *ro_b;                            // (p,1,H) (p,1)
  // outputs: the updated leaves, same layouts, and the metrics (5)
  float *o_enc_wih, *o_enc_whh, *o_enc_bih, *o_enc_bhh;
  float *o_mu_w, *o_mu_b, *o_lv_w, *o_lv_b;
  float *o_hd_wih, *o_hd_whh, *o_hd_bih, *o_hd_bhh;
  float *o_ro_w, *o_ro_b;
  float* metrics;
  // scratch
  float* henc;     // (B, E, H) encoder states
  float* hdec;     // (p, B, T - E, H) decoder states
  float *mu, *lv, *z;  // (B, H)
  float* dz_part;  // (p, B, H) d loss / d z of each head
  float* kl_part;  // (nbe)
  float* sq_part;  // (p, nbd)
  float* usage;    // (p, p) 1 where a W_ih column survives
  // gradient partials: encoder leaves per encoder tile (nbe, ...), head
  // leaves per (head, decoder tile) (p, nbd, ...)
  float *g_enc_wih, *g_enc_whh, *g_enc_bih, *g_enc_bhh;
  float *g_mu_w, *g_mu_b, *g_lv_w, *g_lv_b;
  float *g_hd_wih, *g_hd_whh, *g_hd_bih, *g_hd_bhh;
  float *g_ro_w, *g_ro_b;
  int B, T, P, H, E;
  int bt_enc, bt_dec;
  float lr, lam, lam_ridge, beta;
};

}  // namespace vcx

namespace {

using vcx::i64;
using vcx::StepArgs;

// Extra shared memory of each kernel beyond its GRU tile, in floats.
__host__ __device__ inline i64 enc_fwd_smem(int bt, int P, int H) {
  return vcx::fwd_smem_floats(bt, P, H) + vcx::kMaxThreads;
}
__host__ __device__ inline i64 dec_smem(int bt, int P, int H, int td) {
  return vcx::bwd_smem_floats(bt, P, H) + (i64)bt * td + vcx::kMaxThreads;
}
__host__ __device__ inline i64 enc_bwd_smem(int bt, int P, int H) {
  return vcx::bwd_smem_floats(bt, P, H) + 3LL * bt * H;
}

__device__ inline vcx::GruHead encoder(const StepArgs& a) {
  return {a.enc_wih, a.enc_whh, a.enc_bih, a.enc_bhh, nullptr, a.P, a.H};
}

// 1. Encoder forward, fc_mu / fc_std, reparameterisation, KL partial.
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_encoder_fwd(StepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, G1 = 3 * H + 1, bt = a.bt_enc, tile = blockIdx.x;
  const int tid = threadIdx.x, j = tid % H, r0 = (tid / H) * RPT;
  const int row0 = tile * bt;
  const vcx::GruSmem s = vcx::carve(smem, bt, a.P, H, false);
  float* red = smem + vcx::fwd_smem_floats(bt, a.P, H);
  const vcx::GruInput in{a.batch, (i64)a.T * a.P, a.P, 0, 0};
  const vcx::GruTile tl{a.B, a.E, row0, bt, nullptr, 0, a.henc};
  vcx::gru_forward_tile<RPT>(encoder(a), in, tl, s, false);

  // fc_mu^T and fc_std^T into the (now free) W_hh^T region.
  float* fc = s.whh;
  for (int e = tid; e < H * H; e += blockDim.x) {
    const int o = e / H, k = e % H;
    fc[k * G1 + o] = a.mu_w[e];
    fc[k * G1 + H + o] = a.lv_w[e];
  }
  __syncthreads();
  float kl = 0.0f;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int b = r0 + r, row = row0 + b;
    float mu = a.mu_b[j], lv = a.lv_b[j];
    for (int k = 0; k < H; ++k) {
      const float h = s.h[b * H + k];
      mu = fmaf(h, fc[k * G1 + j], mu);
      lv = fmaf(h, fc[k * G1 + H + j], lv);
    }
    if (row < a.B) {
      const i64 o = (i64)row * H + j;
      a.mu[o] = mu;
      a.lv[o] = lv;
      a.z[o] = mu + expf(0.5f * lv) * a.eps[o];
      kl += -0.5f * (1.0f + lv - mu * mu - expf(lv));
    }
  }
  kl = vcx::block_sum(kl, red);
  if (tid == 0) a.kl_part[tile] = kl;
}

// 2. One decoder head over one batch tile: forward, readout and loss,
// backward through time.
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_decoder(StepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, P = a.P, G = 3 * H, bt = a.bt_dec, td = a.T - a.E;
  const int i = blockIdx.y, tile = blockIdx.x, nbd = gridDim.x;
  const int tid = threadIdx.x, row0 = tile * bt;
  const vcx::GruSmem s = vcx::carve(smem, bt, P, H, true);
  float* dpred = smem + vcx::bwd_smem_floats(bt, P, H);    // [td][bt]
  float* red = dpred + bt * td;
  const vcx::GruHead w{a.hd_wih + (i64)i * G * P, a.hd_whh + (i64)i * G * H,
                       a.hd_bih + (i64)i * G, a.hd_bhh + (i64)i * G,
                       a.mask + (i64)i * P, P, H};
  // Teacher forcing: step t reads a zero step at t = 0, else x[E + t - 1].
  const vcx::GruInput in{a.batch, (i64)a.T * P, P, a.E - 1, 1};
  float* hdec = a.hdec + (i64)i * a.B * td * H;
  const vcx::GruTile tl{a.B, td, row0, bt, a.z, H, hdec};
  vcx::gru_forward_tile<RPT>(w, in, tl, s, false);

  // Readout of every step, squared error, d loss / d pred.
  const float* ro_w = a.ro_w + (i64)i * H;
  const float ro_b = a.ro_b[i];
  const float c_pred = 2.0f / ((float)a.B * (float)td);
  float sq = 0.0f;
  for (int e = tid; e < td * bt; e += blockDim.x) {
    const int t = e / bt, b = e % bt, row = row0 + b;
    float d = 0.0f;
    if (row < a.B) {
      const float* h = hdec + ((i64)row * td + t) * H;
      float pred = ro_b;
      for (int k = 0; k < H; ++k) pred = fmaf(h[k], ro_w[k], pred);
      const float err = pred - a.batch[((i64)row * a.T + a.E + t) * P + i];
      sq = fmaf(err, err, sq);
      d = c_pred * err;
    }
    dpred[e] = d;
  }
  sq = vcx::block_sum(sq, red);            // its barriers publish dpred
  const i64 part = (i64)i * nbd + tile;
  if (tid == 0) a.sq_part[part] = sq;
  for (int k = tid; k < H; k += blockDim.x) {
    float acc = 0.0f;
    for (int t = 0; t < td; ++t)
      for (int b = 0; b < bt && row0 + b < a.B; ++b)
        acc = fmaf(dpred[t * bt + b], hdec[((i64)(row0 + b) * td + t) * H + k],
                   acc);
    a.g_ro_w[part * H + k] = acc;
  }
  if (tid == 0) {
    float acc = 0.0f;
    for (int e = 0; e < td * bt; ++e) acc += dpred[e];
    a.g_ro_b[part] = acc;
  }

  const vcx::GruBwdIO io{nullptr, dpred, ro_w, nullptr, nullptr,
                         a.dz_part + (i64)i * a.B * H};
  vcx::gru_backward_tile<RPT>(w, in, tl, s, io, true);
  __syncthreads();
  vcx::store_block(a.g_hd_wih + part * G * P, s.dwih, G * P);
  vcx::store_block(a.g_hd_whh + part * G * H, s.dwhh, G * H);
  vcx::store_block(a.g_hd_bih + part * G, s.dbih, G);
  vcx::store_block(a.g_hd_bhh + part * G, s.dbhh, G);
}

// 3. Latent and encoder backward over one batch tile.
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_encoder_bwd(StepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, P = a.P, G = 3 * H, E = a.E, bt = a.bt_enc;
  const int tile = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int row0 = tile * bt;
  const vcx::GruSmem s = vcx::carve(smem, bt, P, H, true);
  float* dmu = smem + vcx::bwd_smem_floats(bt, P, H);      // [bt][H]
  float* dlv = dmu + bt * H;
  float* dhe = dlv + bt * H;
  const float inv_b = 1.0f / (float)a.B;

  // h_E (the encoder's last state), dz = sum of the heads' d loss / d z,
  // and the reparameterisation and KL terms:
  //   dmu = dz + beta/B * mu,  dlv = dz/2 * (z - mu) + beta/(2B) (e^lv - 1).
  for (int e = tid; e < bt * H; e += nth) {
    const int b = e / H, k = e % H, row = row0 + b;
    float h = 0.0f, gm = 0.0f, gl = 0.0f;
    if (row < a.B) {
      h = a.henc[((i64)row * E + E - 1) * H + k];
      float dz = 0.0f;
      for (int i = 0; i < P; ++i) dz += a.dz_part[((i64)i * a.B + row) * H + k];
      const i64 o = (i64)row * H + k;
      const float mu = a.mu[o], lv = a.lv[o];
      gm = dz + a.beta * inv_b * mu;
      gl = 0.5f * dz * (a.z[o] - mu) + 0.5f * a.beta * inv_b * (expf(lv) - 1.0f);
    }
    s.h[e] = h;
    dmu[e] = gm;
    dlv[e] = gl;
  }
  __syncthreads();
  // fc grads of this tile: g_w[o][k] = sum_b d[b][o] h[b][k], g_b[o] = sum_b d[b][o].
  for (int e = tid; e < H * H; e += nth) {
    const int o = e / H, k = e % H;
    float am = 0.0f, al = 0.0f;
    for (int b = 0; b < bt; ++b) {
      am = fmaf(dmu[b * H + o], s.h[b * H + k], am);
      al = fmaf(dlv[b * H + o], s.h[b * H + k], al);
    }
    a.g_mu_w[(i64)tile * H * H + e] = am;
    a.g_lv_w[(i64)tile * H * H + e] = al;
  }
  for (int o = tid; o < H; o += nth) {
    float am = 0.0f, al = 0.0f;
    for (int b = 0; b < bt; ++b) {
      am += dmu[b * H + o];
      al += dlv[b * H + o];
    }
    a.g_mu_b[(i64)tile * H + o] = am;
    a.g_lv_b[(i64)tile * H + o] = al;
  }
  // d loss / d h_E = dmu @ W_mu + dlv @ W_lv.
  for (int e = tid; e < bt * H; e += nth) {
    const int b = e / H, k = e % H;
    float acc = 0.0f;
    for (int o = 0; o < H; ++o) {
      acc = fmaf(dmu[b * H + o], a.mu_w[o * H + k], acc);
      acc = fmaf(dlv[b * H + o], a.lv_w[o * H + k], acc);
    }
    dhe[e] = acc;
  }
  __syncthreads();

  const vcx::GruInput in{a.batch, (i64)a.T * P, P, 0, 0};
  const vcx::GruTile tl{a.B, E, row0, bt, nullptr, 0, a.henc};
  const vcx::GruBwdIO io{nullptr, nullptr, nullptr, dhe, nullptr, nullptr};
  vcx::gru_backward_tile<RPT>(encoder(a), in, tl, s, io, false);
  __syncthreads();
  vcx::store_block(a.g_enc_wih + (i64)tile * G * P, s.dwih, G * P);
  vcx::store_block(a.g_enc_whh + (i64)tile * G * H, s.dwhh, G * H);
  vcx::store_block(a.g_enc_bih + (i64)tile * G, s.dbih, G);
  vcx::store_block(a.g_enc_bhh + (i64)tile * G, s.dbhh, G);
}

// 4. SGD on every leaf: out = (w m - lr (sum of partials + ridge2 w)) m,
// m = the parents mask on heads.w_ih and 1 elsewhere.
struct Leaf {
  const float* w;
  const float* parts;   // (heads, nparts, n_per)
  float* out;
  const float* mask;    // (heads, mask_cols) or nullptr
  int heads, nparts, n_per, mask_cols;
  float ridge2;
};

constexpr int kLeaves = 14;

struct UpdateArgs {
  Leaf leaf[kLeaves];
  float lr;
};

__global__ void step_update(UpdateArgs u) {
  const Leaf L = u.leaf[blockIdx.y];
  const i64 total = (i64)L.heads * L.n_per;
  for (i64 e = (i64)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (i64)gridDim.x * blockDim.x) {
    const i64 i = e / L.n_per, ep = e % L.n_per;
    const float* p = L.parts + i * L.nparts * L.n_per + ep;
    float g = 0.0f;
    for (int q = 0; q < L.nparts; ++q) g += p[(i64)q * L.n_per];
    const float w = L.w[e];
    const float m = L.mask != nullptr ? L.mask[i * L.mask_cols + ep % L.mask_cols]
                                      : 1.0f;
    L.out[e] = (w * m - u.lr * (g + L.ridge2 * w)) * m;
  }
}

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 5. Column-group soft-threshold of head blockIdx.x's W_ih (3H, p), one
// warp per column; usage[i][d] = 1 where the column survives.
__global__ void step_prox(float* w_ih, float* usage, int G, int D, float thr) {
  const int i = blockIdx.x, lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* w = w_ih + (i64)i * G * D;
  for (int d = warp; d < D; d += blockDim.x / 32) {
    float ss = 0.0f;
    for (int g = lane; g < G; g += 32) ss += w[g * D + d] * w[g * D + d];
    const float norm = sqrtf(warp_sum(ss));
    const float denom = fmaxf(norm, fmaxf(thr, 1e-30f));
    const float scale = fmaxf(norm - thr, 0.0f) / denom;
    float ss2 = 0.0f;
    for (int g = lane; g < G; g += 32) {
      const float v = w[g * D + d] * scale;
      w[g * D + d] = v;
      ss2 += v * v;
    }
    ss2 = warp_sum(ss2);
    if (lane == 0) usage[i * D + d] = ss2 > 0.0f ? 1.0f : 0.0f;
  }
}

// 6. Metrics, one block: each sum strided over the threads in a fixed
// order, then a fixed tree.
__global__ void step_metrics(StepArgs a, int nbe, int nbd) {
  __shared__ float red[vcx::kMaxThreads];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int P = a.P, H = a.H, td = a.T - a.E;
  float ridge = 0.0f, sq = 0.0f, kl = 0.0f, used = 0.0f;
  for (i64 e = tid; e < (i64)P * H; e += nth) ridge += a.ro_w[e] * a.ro_w[e];
  for (i64 e = tid; e < (i64)P * 3 * H * H; e += nth)
    ridge += a.hd_whh[e] * a.hd_whh[e];
  for (int e = tid; e < P * nbd; e += nth) sq += a.sq_part[e];
  for (int e = tid; e < nbe; e += nth) kl += a.kl_part[e];
  for (int e = tid; e < P * P; e += nth) used += a.usage[e];
  ridge = vcx::block_sum(ridge, red);
  sq = vcx::block_sum(sq, red);
  kl = vcx::block_sum(kl, red);
  used = vcx::block_sum(used, red);
  if (tid == 0) {
    const float recon = sq / ((float)a.B * (float)td);
    const float kl_mean = kl / (float)a.B;
    const float rg = a.lam_ridge * ridge;
    a.metrics[0] = recon + rg + a.beta * kl_mean;
    a.metrics[1] = recon;
    a.metrics[2] = a.beta * kl_mean;
    a.metrics[3] = (recon + rg) / (float)P;
    a.metrics[4] = used / (float)(P * P);
  }
}

typedef void (*StepKernel)(StepArgs);

StepKernel by_rpt(int bt, StepKernel k1, StepKernel k2, StepKernel k4,
                  StepKernel k8) {
  switch (vcx::rows_per_thread(bt)) {
    case 1: return k1;
    case 2: return k2;
    case 4: return k4;
    case 8: return k8;
    default: return nullptr;
  }
}

cudaError_t launch_tile_kernel(StepKernel k, dim3 grid, int bt, i64 floats,
                               const StepArgs& a, cudaStream_t st) {
  if (k == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = a.H * (bt / vcx::rows_per_thread(bt));
  k<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

bool valid_tile(int bt) {
  return bt == 1 || bt == 2 || bt == 4 || bt == 8 || bt == 16 || bt == 32;
}

}  // namespace

extern "C" {

// One phase-1 step; see StepArgs for every buffer.  Returns a cudaError_t.
int vcx_phase1_step(const StepArgs* args, void* stream) {
  const StepArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int P = a.P, H = a.H, G = 3 * H, td = a.T - a.E;
  if (a.B < 1 || P < 1 || H < 1 || a.E < 1 || td < 1 ||
      !valid_tile(a.bt_enc) || !valid_tile(a.bt_dec) ||
      H * (a.bt_enc < 4 ? a.bt_enc : 4) > vcx::kMaxThreads ||
      H * (a.bt_dec < 4 ? a.bt_dec : 4) > vcx::kMaxThreads)
    return (int)cudaErrorInvalidValue;
  const int nbe = (a.B + a.bt_enc - 1) / a.bt_enc;
  const int nbd = (a.B + a.bt_dec - 1) / a.bt_dec;

  cudaError_t e = launch_tile_kernel(
      by_rpt(a.bt_enc, &step_encoder_fwd<1>, &step_encoder_fwd<2>,
             &step_encoder_fwd<4>, &step_encoder_fwd<8>),
      dim3(nbe), a.bt_enc, enc_fwd_smem(a.bt_enc, P, H), a, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_tile_kernel(
      by_rpt(a.bt_dec, &step_decoder<1>, &step_decoder<2>, &step_decoder<4>,
             &step_decoder<8>),
      dim3(nbd, P), a.bt_dec, dec_smem(a.bt_dec, P, H, td), a, st);
  if (e != cudaSuccess) return (int)e;
  e = launch_tile_kernel(
      by_rpt(a.bt_enc, &step_encoder_bwd<1>, &step_encoder_bwd<2>,
             &step_encoder_bwd<4>, &step_encoder_bwd<8>),
      dim3(nbe), a.bt_enc, enc_bwd_smem(a.bt_enc, P, H), a, st);
  if (e != cudaSuccess) return (int)e;

  UpdateArgs u;
  u.lr = a.lr;
  const float r2 = 2.0f * a.lam_ridge;
  const Leaf leaves[kLeaves] = {
      {a.enc_wih, a.g_enc_wih, a.o_enc_wih, nullptr, 1, nbe, G * P, 1, 0.f},
      {a.enc_whh, a.g_enc_whh, a.o_enc_whh, nullptr, 1, nbe, G * H, 1, 0.f},
      {a.enc_bih, a.g_enc_bih, a.o_enc_bih, nullptr, 1, nbe, G, 1, 0.f},
      {a.enc_bhh, a.g_enc_bhh, a.o_enc_bhh, nullptr, 1, nbe, G, 1, 0.f},
      {a.mu_w, a.g_mu_w, a.o_mu_w, nullptr, 1, nbe, H * H, 1, 0.f},
      {a.mu_b, a.g_mu_b, a.o_mu_b, nullptr, 1, nbe, H, 1, 0.f},
      {a.lv_w, a.g_lv_w, a.o_lv_w, nullptr, 1, nbe, H * H, 1, 0.f},
      {a.lv_b, a.g_lv_b, a.o_lv_b, nullptr, 1, nbe, H, 1, 0.f},
      {a.hd_wih, a.g_hd_wih, a.o_hd_wih, a.mask, P, nbd, G * P, P, 0.f},
      {a.hd_whh, a.g_hd_whh, a.o_hd_whh, nullptr, P, nbd, G * H, 1, r2},
      {a.hd_bih, a.g_hd_bih, a.o_hd_bih, nullptr, P, nbd, G, 1, 0.f},
      {a.hd_bhh, a.g_hd_bhh, a.o_hd_bhh, nullptr, P, nbd, G, 1, 0.f},
      {a.ro_w, a.g_ro_w, a.o_ro_w, nullptr, P, nbd, H, 1, r2},
      {a.ro_b, a.g_ro_b, a.o_ro_b, nullptr, P, nbd, 1, 1, 0.f},
  };
  for (int k = 0; k < kLeaves; ++k) u.leaf[k] = leaves[k];
  step_update<<<dim3(120, kLeaves), 256, 0, st>>>(u);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_prox<<<P, 256, 0, st>>>(a.o_hd_wih, a.usage, G, P, a.lam * a.lr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_metrics<<<1, vcx::kMaxThreads, 0, st>>>(a, nbe, nbd);
  return (int)cudaGetLastError();
}

const char* vcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
