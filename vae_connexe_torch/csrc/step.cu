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
// accumulates gradients in scratch (an outer product per step), updating on
// the last tile.  On the card the tiles run at once, and no weight-gradient
// sum runs inside a time loop: the backward of both GRUs is B2's two
// phases (gru_bwd.cuh), a serial dh chain that writes the gate gradients
// and a weight-gradient kernel parallel over B*T.  A step is eleven launches
// on one stream; each writes partial sums that a later one reduces in a
// fixed order (no float atomics: the step is deterministic):
//   1. step_encoder_fwd    per batch tile: encoder GRU over enc_len steps
//      (states saved), fc_mu / fc_std, z = mu + exp(lv / 2) * eps, KL sum.
//   2. step_decoder_fwd    per (batch tile, head): the head's forward over
//      td = T - enc_len steps from h0 = z with the masked W_ih and the
//      teacher-forced input (zero at t = 0, then x[enc_len + t - 1]).
//   3. step_readout        per (chunk of B*td rows, head): pred, squared
//      error, dpred = 2/(B*td) * err, the chain's input douts = dpred*ro_w,
//      and partials of the readout gradients and of the squared error.
//   4. step_decoder_chain  B2's chain on the decoder (mask, teacher-forced
//      input, h0 = z): gate gradients gh, and dh0 into dz_part.
//   5. step_decoder_wgrad  B2's weight gradients from gh, per (head, chunk).
//   6. step_latent         per batch tile: dz = sum over heads, the latent
//      and KL terms, fc partials, and dh_E written as the encoder chain's
//      douts (zero but at the last step).
//   7. step_encoder_chain, 8. step_encoder_wgrad: the same on the encoder.
//   9. step_update         every leaf: sum of partials, SGD (+ ridge), mask;
//      and partials of the ridge term from the incoming weights.
//  10. step_prox           per head: column-group soft-threshold of W_ih and
//      which columns survive.
//  11. step_metrics        one block: loss, recon, beta*KL, mean_loss,
//      variable_usage.
//
// Bound.  At p=20, H=64, B=256, ctx=20 a step is ~5e9 f32 flops (the
// forward's products and the backward's two) against ~3 MB of parameters,
// batch and updated parameters: bound by f32 FMA throughput (~0.07 ms on
// an H100 SXM).  The chains rematerialise the gates (the forward's products
// again) and the decoder's gate gradients pass through a 52 MB scratch.

#include "gru_bwd.cuh"

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
  float* henc;        // (B, E, H) encoder states
  float* hdec;        // (p, B, td, H) decoder states
  float *mu, *lv, *z;  // (B, H)
  float* douts;       // (p, B, td, H) d loss / d hdec
  float* gh;          // (p, B, td, 4H) decoder gate gradients
  float* dz_part;     // (p, B, H) d loss / d z of each head
  float* douts_enc;   // (B, E, H) d loss / d henc
  float* gh_enc;      // (B, E, 4H) encoder gate gradients
  float* dh0_enc;     // (B, H) d loss / d h0 of the encoder (unused)
  float* kl_part;     // (nbe)
  float* sq_part;     // (p, nrc)
  float* ridge_part;  // (kLeaves, kUpdateBlocks)
  float* usage;       // (p, p) 1 where a W_ih column survives
  // gradient partials
  float* g_enc;       // (splits_enc, wgrad_part_floats(p, H))
  float* g_hd;        // (p, splits_dec, wgrad_part_floats(p, H))
  float *g_mu_w, *g_mu_b, *g_lv_w, *g_lv_b;  // (nbe, ...) per encoder tile
  float *g_ro_w, *g_ro_b;                    // (p, nrc, H), (p, nrc)
  int B, T, P, H, E;
  int bt_enc, bt_dec, bt_chain_dec, bt_chain_enc;
  int splits_dec, chunk_dec, splits_enc, chunk_enc;
  float lr, lam, lam_ridge, beta;
};

}  // namespace vcx

namespace {

using vcx::GruArgs;
using vcx::i64;
using vcx::StepArgs;
using vcx::WgradArgs;

// Rows of B*td a readout block takes; threads of the row-parallel kernels.
constexpr int kReadoutRows = 128, kRowThreads = 256;
// The update's grid: blocks per leaf.
constexpr int kUpdateBlocks = 120;
constexpr int kLeaves = 14;

__device__ inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of the encoder forward beyond its GRU tile, in floats.
__host__ __device__ inline i64 enc_fwd_smem(int bt, int P, int H) {
  return vcx::fwd_smem_floats(bt, P, H) + vcx::kMaxThreads;
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
  const vcx::GruSmem s = vcx::carve(smem, bt, a.P, H);
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

// 2. One decoder head over one batch tile, forward only (B1's body).
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_decoder_fwd(StepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, P = a.P, G = 3 * H, td = a.T - a.E, i = blockIdx.y;
  const vcx::GruSmem s = vcx::carve(smem, a.bt_dec, P, H);
  const vcx::GruHead w{a.hd_wih + (i64)i * G * P, a.hd_whh + (i64)i * G * H,
                       a.hd_bih + (i64)i * G, a.hd_bhh + (i64)i * G,
                       a.mask + (i64)i * P, P, H};
  // Teacher forcing: step t reads a zero step at t = 0, else x[E + t - 1].
  const vcx::GruInput in{a.batch, (i64)a.T * P, P, a.E - 1, 1};
  const vcx::GruTile tl{a.B, td, (int)blockIdx.x * a.bt_dec, a.bt_dec, a.z, H,
                        a.hdec + (i64)i * a.B * td * H};
  vcx::gru_forward_tile<RPT>(w, in, tl, s, false);
}

// 3. Readout of kReadoutRows rows k = b*td + t of head blockIdx.y: a warp
// per row for pred (a fixed shuffle tree), then the block's partials of
// g_ro_w (one thread per unit), g_ro_b and the squared error (thread 0,
// in order of rows).
__global__ void __launch_bounds__(kRowThreads) step_readout(StepArgs a) {
  __shared__ float dps[kReadoutRows], sqs[kReadoutRows];
  const int H = a.H, P = a.P, td = a.T - a.E, i = blockIdx.y;
  const int c = blockIdx.x, nrc = gridDim.x, K = a.B * td;
  const int k0 = c * kReadoutRows, n = min(kReadoutRows, K - k0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const float* hd = a.hdec + (i64)i * K * H;
  float* douts = a.douts + (i64)i * K * H;
  const float* w = a.ro_w + (i64)i * H;
  const float rb = a.ro_b[i], c_pred = 2.0f / ((float)a.B * (float)td);
  for (int r = warp; r < n; r += kRowThreads / 32) {
    const int k = k0 + r, b = k / td, t = k - b * td;
    const float* h = hd + (i64)k * H;
    float s = 0.0f;
    for (int q = lane; q < H; q += 32) s = fmaf(h[q], w[q], s);
    s = warp_sum(s);
    const float err = rb + s - a.batch[((i64)b * a.T + a.E + t) * P + i];
    const float d = c_pred * err;
    for (int q = lane; q < H; q += 32) douts[(i64)k * H + q] = d * w[q];
    if (lane == 0) {
      dps[r] = d;
      sqs[r] = err * err;
    }
  }
  __syncthreads();
  const i64 part = (i64)i * nrc + c;
  for (int q = tid; q < H; q += blockDim.x) {
    float acc = 0.0f;
    for (int r = 0; r < n; ++r) acc = fmaf(dps[r], hd[(i64)(k0 + r) * H + q], acc);
    a.g_ro_w[part * H + q] = acc;
  }
  if (tid == 0) {
    float sb = 0.0f, sq = 0.0f;
    for (int r = 0; r < n; ++r) {
      sb += dps[r];
      sq += sqs[r];
    }
    a.g_ro_b[part] = sb;
    a.sq_part[part] = sq;
  }
}

// 4, 7. B2's chain and 5, 8. its weight gradients, as kernels of their own
// so that a profile tells the decoder's from the encoder's.
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_decoder_chain(GruArgs a) {
  vcx::gru_chain_body<RPT, true>(a);
}
template <int RPT>
__global__ void __launch_bounds__(vcx::kMaxThreads)
step_encoder_chain(GruArgs a) {
  vcx::gru_chain_body<RPT, true>(a);
}
__global__ void __launch_bounds__(vcx::kWThreads)
step_decoder_wgrad(WgradArgs a) {
  vcx::gru_wgrad_body<true>(a);
}
__global__ void __launch_bounds__(vcx::kWThreads)
step_encoder_wgrad(WgradArgs a) {
  vcx::gru_wgrad_body<true>(a);
}

// 6. Latent terms of one encoder tile.  Shared memory: h_E, dmu, dlv,
// [bt][H] each.
__global__ void __launch_bounds__(kRowThreads) step_latent(StepArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, P = a.P, E = a.E, bt = a.bt_enc;
  const int tile = blockIdx.x, tid = threadIdx.x, nth = blockDim.x;
  const int row0 = tile * bt;
  float* hs = smem;
  float* dmu = hs + bt * H;
  float* dlv = dmu + bt * H;
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
    hs[e] = h;
    dmu[e] = gm;
    dlv[e] = gl;
  }
  __syncthreads();
  // fc grads of this tile: g_w[o][k] = sum_b d[b][o] h[b][k], g_b[o] = sum_b d[b][o].
  for (int e = tid; e < H * H; e += nth) {
    const int o = e / H, k = e % H;
    float am = 0.0f, al = 0.0f;
    for (int b = 0; b < bt; ++b) {
      am = fmaf(dmu[b * H + o], hs[b * H + k], am);
      al = fmaf(dlv[b * H + o], hs[b * H + k], al);
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
  // The encoder chain's douts: d loss / d h_E = dmu @ W_mu + dlv @ W_lv at
  // the last step, zero before it.
  for (int e = tid; e < bt * E * H; e += nth) {
    const int b = e / (E * H), t = (e / H) % E, k = e % H, row = row0 + b;
    if (row >= a.B) continue;
    float acc = 0.0f;
    if (t == E - 1)
      for (int o = 0; o < H; ++o) {
        acc = fmaf(dmu[b * H + o], a.mu_w[o * H + k], acc);
        acc = fmaf(dlv[b * H + o], a.lv_w[o * H + k], acc);
      }
    a.douts_enc[((i64)row * E + t) * H + k] = acc;
  }
}

// 9. SGD on every leaf: out = (w m - lr (sum of partials + ridge2 w)) m,
// m = the parents mask on heads.w_ih and 1 elsewhere.  Partial q of
// element ep of head i is at parts[i * head_stride + q * part_stride + ep],
// so the weight-gradient kernel's (head, split) layout is read in place.
// Each block also writes the sum of w^2 over its elements of a ridge leaf
// (0 for the others): the ridge term of the loss at the incoming weights.
struct Leaf {
  const float* w;
  const float* parts;
  float* out;
  const float* mask;    // (heads, mask_cols) or nullptr
  i64 head_stride, part_stride;
  int heads, nparts, n_per, mask_cols;
  float ridge2;
  int ridge;            // the leaf enters the ridge term
};

struct UpdateArgs {
  Leaf leaf[kLeaves];
  float* ridge_part;    // (kLeaves, kUpdateBlocks)
  float lr;
};

__global__ void step_update(UpdateArgs u) {
  __shared__ float red[kRowThreads];
  const Leaf L = u.leaf[blockIdx.y];
  const i64 total = (i64)L.heads * L.n_per;
  float ss = 0.0f;
  for (i64 e = (i64)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (i64)gridDim.x * blockDim.x) {
    const i64 i = e / L.n_per, ep = e % L.n_per;
    const float* p = L.parts + i * L.head_stride + ep;
    float g = 0.0f;
    for (int q = 0; q < L.nparts; ++q) g += p[(i64)q * L.part_stride];
    const float w = L.w[e];
    if (L.ridge) ss = fmaf(w, w, ss);
    const float m = L.mask != nullptr ? L.mask[i * L.mask_cols + ep % L.mask_cols]
                                      : 1.0f;
    L.out[e] = (w * m - u.lr * (g + L.ridge2 * w)) * m;
  }
  ss = vcx::block_sum(ss, red);
  if (threadIdx.x == 0)
    u.ridge_part[blockIdx.y * gridDim.x + blockIdx.x] = ss;
}

// 10. Column-group soft-threshold of head blockIdx.x's W_ih (3H, p), one
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

// 11. Metrics, one block: each sum of partials strided over the threads in
// a fixed order, then a fixed tree.
__global__ void step_metrics(StepArgs a, int nbe, int nsq) {
  __shared__ float red[vcx::kMaxThreads];
  const int tid = threadIdx.x, nth = blockDim.x;
  const int P = a.P, td = a.T - a.E;
  float ridge = 0.0f, sq = 0.0f, kl = 0.0f, used = 0.0f;
  for (int e = tid; e < kLeaves * kUpdateBlocks; e += nth) ridge += a.ridge_part[e];
  for (int e = tid; e < nsq; e += nth) sq += a.sq_part[e];
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

cudaError_t launch_step_kernel(StepKernel k, dim3 grid, int threads,
                               i64 floats, const StepArgs& a,
                               cudaStream_t st) {
  if (k == nullptr) return cudaErrorInvalidValue;
  const size_t smem = (size_t)floats * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  k<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

int tile_threads(int H, int bt) { return H * (bt / vcx::rows_per_thread(bt)); }

bool valid_tile(int bt) {
  return bt == 1 || bt == 2 || bt == 4 || bt == 8 || bt == 16 || bt == 32;
}

const vcx::ChainKernel kDecoderChain[8] = {
    &step_decoder_chain<1>, &step_decoder_chain<2>, &step_decoder_chain<3>,
    &step_decoder_chain<4>, &step_decoder_chain<5>, &step_decoder_chain<6>,
    &step_decoder_chain<7>, &step_decoder_chain<8>};
const vcx::ChainKernel kEncoderChain[8] = {
    &step_encoder_chain<1>, &step_encoder_chain<2>, &step_encoder_chain<3>,
    &step_encoder_chain<4>, &step_encoder_chain<5>, &step_encoder_chain<6>,
    &step_encoder_chain<7>, &step_encoder_chain<8>};

// Launches 1-8: the forward and the backward of both GRUs.
cudaError_t forward_backward(const StepArgs& a, cudaStream_t st) {
  const int P = a.P, H = a.H, td = a.T - a.E;
  const int nbe = (a.B + a.bt_enc - 1) / a.bt_enc;
  const int nbd = (a.B + a.bt_dec - 1) / a.bt_dec;
  const int nrc = (a.B * td + kReadoutRows - 1) / kReadoutRows;
  cudaError_t e = launch_step_kernel(
      by_rpt(a.bt_enc, &step_encoder_fwd<1>, &step_encoder_fwd<2>,
             &step_encoder_fwd<4>, &step_encoder_fwd<8>),
      dim3(nbe), tile_threads(H, a.bt_enc), enc_fwd_smem(a.bt_enc, P, H), a,
      st);
  if (e != cudaSuccess) return e;
  e = launch_step_kernel(
      by_rpt(a.bt_dec, &step_decoder_fwd<1>, &step_decoder_fwd<2>,
             &step_decoder_fwd<4>, &step_decoder_fwd<8>),
      dim3(nbd, P), tile_threads(H, a.bt_dec),
      vcx::fwd_smem_floats(a.bt_dec, P, H), a, st);
  if (e != cudaSuccess) return e;
  step_readout<<<dim3(nrc, P), kRowThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;

  const i64 sxb = (i64)a.T * P;
  GruArgs dec{a.batch, 0, sxb, P, a.hd_wih, a.hd_whh, a.hd_bih, a.hd_bhh,
              a.z, 0, H, a.hdec, a.douts, a.gh, a.dz_part,
              P, a.B, td, P, H, a.bt_chain_dec, a.mask, a.E - 1, 1};
  e = vcx::launch_chain(kDecoderChain, dec, st);
  if (e != cudaSuccess) return e;
  WgradArgs dw{a.gh, a.batch, 0, sxb, P, a.z, 0, H, a.hdec, a.hd_wih,
               nullptr, a.g_hd, P, a.B, td, P, H, a.splits_dec, a.chunk_dec,
               a.E - 1, 1};
  e = vcx::launch_wgrad(&step_decoder_wgrad, dw, st);
  if (e != cudaSuccess) return e;

  e = launch_step_kernel(&step_latent, dim3(nbe), kRowThreads,
                         3LL * a.bt_enc * H, a, st);
  if (e != cudaSuccess) return e;
  GruArgs enc{a.batch, 0, sxb, P, a.enc_wih, a.enc_whh, a.enc_bih, a.enc_bhh,
              nullptr, 0, 0, a.henc, a.douts_enc, a.gh_enc, a.dh0_enc,
              1, a.B, a.E, P, H, a.bt_chain_enc, nullptr, 0, 0};
  e = vcx::launch_chain(kEncoderChain, enc, st);
  if (e != cudaSuccess) return e;
  WgradArgs ew{a.gh_enc, a.batch, 0, sxb, P, nullptr, 0, 0, a.henc,
               a.enc_wih, nullptr, a.g_enc, 1, a.B, a.E, P, H, a.splits_enc,
               a.chunk_enc, 0, 0};
  return vcx::launch_wgrad(&step_encoder_wgrad, ew, st);
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
      tile_threads(H, a.bt_enc) > vcx::kMaxThreads ||
      tile_threads(H, a.bt_dec) > vcx::kMaxThreads)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = forward_backward(a, st);
  if (e != cudaSuccess) return (int)e;

  const int nbe = (a.B + a.bt_enc - 1) / a.bt_enc;
  const int nrc = (a.B * td + kReadoutRows - 1) / kReadoutRows;
  const i64 wpf = vcx::wgrad_part_floats(P, H);
  const i64 se = (i64)a.splits_enc * wpf, sd = (i64)a.splits_dec * wpf;
  const i64 o_ih = (i64)G * H, o_bhh = (i64)G * (H + P), o_bih = o_bhh + G;
  UpdateArgs u;
  u.lr = a.lr;
  u.ridge_part = a.ridge_part;
  const float r2 = 2.0f * a.lam_ridge;
  // {w, parts, out, mask, head_stride, part_stride, heads, nparts, n_per,
  //  mask_cols, ridge2, ridge}
  const Leaf leaves[kLeaves] = {
      {a.enc_wih, a.g_enc + o_ih, a.o_enc_wih, nullptr, se, wpf, 1,
       a.splits_enc, G * P, 1, 0.f, 0},
      {a.enc_whh, a.g_enc, a.o_enc_whh, nullptr, se, wpf, 1, a.splits_enc,
       G * H, 1, 0.f, 0},
      {a.enc_bih, a.g_enc + o_bih, a.o_enc_bih, nullptr, se, wpf, 1,
       a.splits_enc, G, 1, 0.f, 0},
      {a.enc_bhh, a.g_enc + o_bhh, a.o_enc_bhh, nullptr, se, wpf, 1,
       a.splits_enc, G, 1, 0.f, 0},
      {a.mu_w, a.g_mu_w, a.o_mu_w, nullptr, 0, H * H, 1, nbe, H * H, 1, 0.f, 0},
      {a.mu_b, a.g_mu_b, a.o_mu_b, nullptr, 0, H, 1, nbe, H, 1, 0.f, 0},
      {a.lv_w, a.g_lv_w, a.o_lv_w, nullptr, 0, H * H, 1, nbe, H * H, 1, 0.f, 0},
      {a.lv_b, a.g_lv_b, a.o_lv_b, nullptr, 0, H, 1, nbe, H, 1, 0.f, 0},
      {a.hd_wih, a.g_hd + o_ih, a.o_hd_wih, a.mask, sd, wpf, P, a.splits_dec,
       G * P, P, 0.f, 0},
      {a.hd_whh, a.g_hd, a.o_hd_whh, nullptr, sd, wpf, P, a.splits_dec, G * H,
       1, r2, 1},
      {a.hd_bih, a.g_hd + o_bih, a.o_hd_bih, nullptr, sd, wpf, P,
       a.splits_dec, G, 1, 0.f, 0},
      {a.hd_bhh, a.g_hd + o_bhh, a.o_hd_bhh, nullptr, sd, wpf, P,
       a.splits_dec, G, 1, 0.f, 0},
      {a.ro_w, a.g_ro_w, a.o_ro_w, nullptr, (i64)nrc * H, H, P, nrc, H, 1, r2,
       1},
      {a.ro_b, a.g_ro_b, a.o_ro_b, nullptr, nrc, 1, P, nrc, 1, 1, 0.f, 0},
  };
  for (int k = 0; k < kLeaves; ++k) u.leaf[k] = leaves[k];
  step_update<<<dim3(kUpdateBlocks, kLeaves), kRowThreads, 0, st>>>(u);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_prox<<<P, 256, 0, st>>>(a.o_hd_wih, a.usage, G, P, a.lam * a.lr);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  step_metrics<<<1, vcx::kMaxThreads, 0, st>>>(a, nbe, P * nrc);
  return (int)cudaGetLastError();
}

// The rows of B*td a readout block takes and the blocks of a leaf in the
// update: the wrapper sizes sq_part, g_ro_* and ridge_part by them.
int vcx_step_constants(int* out) {
  out[0] = kReadoutRows;
  out[1] = kUpdateBlocks * kLeaves;
  return 0;
}

const char* vcx_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
