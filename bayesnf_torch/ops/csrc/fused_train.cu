// Fused training objective (NORMAL, NB or ZINB likelihood) for Hopper
// (sm_90a): encode from raw inputs, MLP forward, loss, full backward, with the
// loss and every gradient summed over all rows.
//
// Replaces the Pallas TPU kernel `fused_train` (body `_train_kernel_raw`,
// helpers `_encode_in_kernel`, `_encode_backward_in_kernel`,
// `_likelihood_tile`) in bayesnf_tpu/ops/fused_mlp.py. Per ensemble member e:
//
//   sx   = x * exp(-(lsa + log input_scales))                     (D rows)
//   h_0  = [sx, octave Fourier(sx_i), seasonal, sx_a * sx_b] * softplus(fs)
//   z_l  = s_l * (W_l^T (h_l / sqrt(fan_in_l)) + b_l),  h_{l+1} = act(z_l)
//   pred = s_out * (W_out^T (h_depth / sqrt(width)) + b_out)
//   loss = lik_scale * sum_rows -log p(y | pred), with
//     NORMAL: y ~ Normal(pred, sigma), sigma = 0.01 + e^obs0;
//     NB:     y ~ NegativeBinomial(total_count r = 1/s, logits
//             l = -log s - log softplus(pred)), s = softplus(obs1);
//     ZINB:   y = 0 with probability sigmoid(obs2), else NB as above;
//
// and d loss / d (lsa, fs, W_l, b_l, scales_raw, logit, obs), hand-derived as
// in the TPU kernel. fp32 throughout (FMA, no TF32, no fast-math intrinsics).
// The count likelihoods use the TPU kernel's math (`_likelihood_tile`):
// log Gamma and digamma by shift-by-6 Stirling series, log softplus(pred)
// clamped at -15. The likelihood is a template parameter of the tile kernel,
// so the NORMAL instantiation is the same code as before the count models.
//
// What bounds it: at the training path's shapes (64 members x 38,096 rows,
// width 512, depth 2, 49 encoded features) one call is ~4.2 TFLOP of fp32
// FMA (1.73 MFLOP per row and member: the forward, the backward's
// W dv products, and the weight-gradient contraction over rows), so it is
// bound by the SIMT fp32 pipe. Memory traffic is the scratch below, a few
// GB per call.
//
// Design. The TPU kernel keeps a member's weights, the tile's activations and
// the running weight gradients in VMEM across its sequential row tiles. A
// Hopper block has 227 KB of shared memory, one width-512 weight matrix and
// its gradient are 1 MiB each, and blocks run in no order. So one call runs,
// for each chunk of rows (sized so the scratch stays under a budget the
// wrapper sets):
//   1. `train_tile_kernel`, grid (row tiles, members). A block encodes its TR
//      rows into shared memory, runs the forward with two ping-pong buffers
//      (as the K2 forward does), the loss, and the backward chain
//      dh_l = W_l dv_l / sqrt(fan_in_l) with the same two buffers, then the
//      encode backward. It writes to global scratch each layer's matmul input
//      lhs_l = h_l / sqrt(fan_in_l), pre-activation z_l (read back by the same
//      block in the backward) and pre-scale cotangent dv_l, in row-contiguous
//      passes over shared memory, and per-tile partial sums of the scalar
//      gradients (block reductions in a fixed order). Depth does not change
//      its shared memory. The first layer's W dv has only F outputs (49 at
//      the main shape), so it runs as one dot product per thread
//      (`narrow_matmul`) rather than a 512-column pass that would leave most
//      columns idle.
//   2. `wgrad_kernel`: dW_l += sum over the chunk's rows of lhs_l dv_l^T,
//      a hand-written 128 x 128-tile SIMT GEMM, one thread summing each
//      output over rows in order.
//   3. `rowdot_kernel`: db_l += sum_rows dv_l, and the output layer's
//      dW_out += sum_rows lhs_depth dv_out, one warp per output.
// and once at the end `finalize_kernel` sums the per-tile partials in tile
// order and applies the scalar chain rules. Every reduction has a fixed
// order and there are no atomics, so results are bitwise reproducible.
// Padded rows of the ragged last tile read x = 0 and carry a zero loss
// cotangent, so they add exactly zero to every sum. (A count likelihood
// evaluated on a padded row could give inf or NaN, and 0 * NaN is NaN, so the
// count epilogue selects with the row's validity instead of multiplying.)
//
// Valid rows. `n_rows` is the rows' stride in x, seasonal and y; only rows
// below `n_valid` <= n_rows count (the TPU kernel's dynamic `n_valid`, stage
// 4: a row shard of a mesh fit holds its valid rows then padding). Rows at
// n_valid and past it are treated as the ragged tile's padding: their
// inputs and targets are selected out (never read into a result, so a NaN
// there cannot leak), they carry a zero cotangent, and the NORMAL loss
// counts n_valid rows. Chunks and tiles still cover all n_rows rows.
//
// Inputs. x, seasonal and y are each shared by every member (a group stride
// of 0), or stored once per group of `rep` consecutive members: member e
// reads group e / rep, as the TPU kernel's index maps do. rep = 1 is one row
// set per member (minibatch MAP); rep = S serves a member's one minibatch to
// all S of its Monte-Carlo draws (VI), with no S-fold copy of the batch.
// Only these reads depend on it; the scratch and every later kernel work per
// member already.
//
// Precision. Under 'bf16' every matrix product the TPU kernel casts (its
// `_mm_t`, where the second operand's free dimension exceeds 1) takes its
// operands rounded to bf16 (nearest even), multiplies them exactly and sums
// in fp32: the hidden and output forwards, the backward's W dv products (the
// output layer's included) and the hidden weight gradients. The output
// layer's weight gradient, the bias gradients and every scalar partial stay
// fp32, as do the parameters, the encode, the activations and the
// likelihood. Each operand is rounded once, where it enters shared memory or
// a staged tile, never in an FMA loop: the weights by `round_bf16_kernel`
// into rounded copies at the start of the call, the tile's matmul inputs and
// W dv cotangents where `train_tile_kernel<., ., true>` writes them to shared
// memory (their scratch copies stay fp32: `rowdot_kernel` sums the fp32
// lhs_depth, dv_l and dv_out), and the weight gradients' operands where
// `wgrad_kernel<true>` stages them. The FMAs stay on the fp32 pipe (a
// product of two bf16 values is exact in fp32), so the reduction orders, and
// bitwise reproducibility, are those of the fp32 kernels; precision is a
// template parameter, so the fp32 instantiations are the code they were.
// Making it fast (wgmma with bf16 operands, TMA, keeping z_l on chip) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "field_mlp.cuh"

namespace {

constexpr int kMaxInputs = 8;
constexpr int kMaxPairs = 32;
constexpr int kMaxGroups = kMaxInputs + 3;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kHalfLog2Pi = 0.9189385332046727f;

// The observation models, as the wrapper codes them.
enum Lik : int { kNormal = 0, kNB = 1, kZINB = 2 };

// Partial sums per (member, row tile), in this order:
//   kPartRR      NORMAL: sum (pred - y)^2 over valid rows;
//                NB, ZINB: sum of the rows' log-probs
//   kPartGV      sum g * v_out (g = d loss / d pred, v_out = pred / s_out)
//   kPartLogit   sum dh * d act / d w over every hidden layer
//   kPartDzz+l   sum dz_l * z_l, l < depth
//   then num_inputs sums of d loss / d lsa, then num_groups sums
//   <dh0_g, raw_g> (before the sigmoid(fs_raw) factor);
//   NB and ZINB add two last ones: sum d lp / d r (the shape gradient's
//   rows) and sum d lp / d obs2 (the zero-inflation gradient's rows).
constexpr int kPartRR = 0;
constexpr int kPartGV = 1;
constexpr int kPartLogit = 2;
constexpr int kPartDzz = 3;

struct TrainArgs {
  const float* x;                  // (D, N) or (E / x_rep, D, N)
  const float* seasonal;           // (S2, N) or (E / seasonal_rep, S2, N)
  const float* y;                  // (N,) or (E / y_rep, N)
  size_t x_group_stride;           // floats between groups; 0 when shared
  size_t seasonal_group_stride;
  size_t y_group_stride;
  int x_rep;                       // members per group
  int seasonal_rep;
  int y_rep;
  const float* w[kMaxLayers];      // (E, fan_in_l, fan_out_l)
  const float* b[kMaxLayers];      // (E, fan_out_l)
  const float* lsa_eff;            // (E, D): lsa + log(input_scales)
  const float* fs_raw;             // (E, G)
  const float* scales_raw;         // (E, depth + 1)
  const float* logit;              // (E,)
  const float* obs_raw;            // (E, 3)
  float* lhs[kMaxLayers];          // (E, fan_in_l, ld) chunk scratch
  float* z[kMaxLayers];            // (E, width, ld), l < depth
  float* dv[kMaxLayers];           // (E, fan_out_l, ld)
  float* partials;                 // (E, num_tiles, num_partials)
  float rsqrt[kMaxLayers];         // 1/sqrt(fan_in_l), rounded from double
  float lik_scale;
  int fourier_degree[kMaxInputs];
  int pair_a[kMaxPairs];
  int pair_b[kMaxPairs];
  int depth;
  int num_inputs;
  int num_seasonal;
  int num_pairs;
  int num_groups;
  int num_features;
  int width;
  int n_rows;                      // rows N: the stride of x, seasonal, y
  int n_valid;                     // rows that count: index < n_valid
  int row0;                        // first row of this chunk
  int ld;                          // scratch row stride (rows per chunk)
  int tile0;                       // global index of the chunk's first tile
  int num_tiles;                   // tiles over all N rows
  int num_partials;
};

// log Gamma(x), x > 0, as `gammaln_stirling` in bayesnf_tpu/ops/special.py:
// the shift-by-6 recurrence evaluated at min(x, 1e6) (its products never
// overflow), and above 1e6 the unshifted series.
__device__ __forceinline__ float gammaln_stirling(float x) {
  const float xs = fminf(x, 1e6f);
  const float p0 = xs * (xs + 1.f);
  const float p1 = (xs + 2.f) * (xs + 3.f);
  const float p2 = (xs + 4.f) * (xs + 5.f);
  const float z = xs + 6.f;
  const float zi = 1.f / z;
  const float zi2 = zi * zi;
  const float series =
      zi * (0.08333333333333333f +
            zi2 * (-0.002777777777777778f + zi2 * 0.0007936507936507937f));
  const float stirling =
      (z - 0.5f) * logf(z) - z + 0.9189385332046727f + series;
  if (x > 1e6f) {
    return (x - 0.5f) * logf(x) - x + 0.9189385332046727f + 1.f / (12.f * x);
  }
  return stirling - logf(p0) - logf(p1) - logf(p2);
}

// digamma(x), x > 0, as `digamma_stirling` in bayesnf_tpu/ops/special.py.
__device__ __forceinline__ float digamma_stirling(float x) {
  const float corr = 1.f / x + 1.f / (x + 1.f) + 1.f / (x + 2.f) +
                     1.f / (x + 3.f) + 1.f / (x + 4.f) + 1.f / (x + 5.f);
  const float z = x + 6.f;
  const float zi = 1.f / z;
  const float zi2 = zi * zi;
  const float series =
      zi2 * (0.08333333333333333f +
             zi2 * (-0.008333333333333333f + zi2 * 0.003968253968253968f));
  return logf(z) - 0.5f * zi - series - corr;
}

// One row of the NB or ZINB likelihood (`_likelihood_tile`): its log-prob
// `lp`, d lp / d pred before lik_scale (`g`), d lp / d r (`dr`, r the total
// count) and d lp / d obs2 (`dp2`, 0 under NB).
template <int kLik>
__device__ __forceinline__ void count_likelihood_row(float pred, float y,
                                                     float obs1, float obs2,
                                                     float* lp, float* g,
                                                     float* dr, float* dp2) {
  const float s = softplus(obs1);
  const float r = 1.f / s;
  // log softplus(pred), and its derivative sigmoid / softplus, which tends to
  // 1 as pred -> -inf.
  const float safe = fmaxf(pred, -15.f);
  const float sp = softplus(safe);
  const float lsp = pred < -15.f ? pred : logf(sp);
  const float ratio = pred < -15.f ? 1.f : sigmoid(safe) / sp;
  const float l = -logf(s) - lsp;
  const float sp_l = softplus(l);    // -log sigmoid(-l)
  const float sp_nl = softplus(-l);  // -log sigmoid(l)
  const float nb_lp = gammaln_stirling(r + y) - gammaln_stirling(1.f + y) -
                      gammaln_stirling(r) - r * sp_l - y * sp_nl;
  const float dlp_dl = -r * sigmoid(l) + y * sigmoid(-l);
  // d nb_lp / d r: the explicit r terms plus l's log(r) dependence.
  const float dlp_dr = digamma_stirling(r + y) - digamma_stirling(r) - sp_l +
                       dlp_dl / r;
  float dlp_dnb = 1.f;
  if constexpr (kLik == kZINB) {
    const float log_pi = -softplus(-obs2);
    const float log1m = -softplus(obs2);
    const float b = log1m + nb_lp;
    const float m = fmaxf(log_pi, b);
    const float zero_lp = m + logf(expf(log_pi - m) + expf(b - m));
    const float w_b = sigmoid(b - log_pi);  // d zero_lp / d b
    if (y == 0.f) {
      *lp = zero_lp;
      dlp_dnb = w_b;
      *dp2 = (1.f - w_b) * sigmoid(-obs2) - w_b * sigmoid(obs2);
    } else {
      *lp = b;
      *dp2 = -sigmoid(obs2);
    }
  } else {
    *lp = nb_lp;
    *dp2 = 0.f;
  }
  // d lp / d pred flows only through l, and d l / d pred = -ratio.
  *g = dlp_dnb * dlp_dl * ratio;
  *dr = dlp_dnb * dlp_dr;
}

// Member e's rows of an input stored per group of `rep` members.
__device__ __forceinline__ const float* group_rows(const float* base,
                                                   size_t group_stride,
                                                   int rep, int e) {
  return base + (size_t)(e / rep) * group_stride;
}

// The scaled inputs sx of one row (zero past the last row).
__device__ __forceinline__ void scaled_inputs(const TrainArgs& args, int e,
                                              int row, bool valid,
                                              float (&sx)[kMaxInputs]) {
  const float* lsa = args.lsa_eff + (size_t)e * args.num_inputs;
  const float* x = group_rows(args.x, args.x_group_stride, args.x_rep, e);
  for (int d = 0; d < args.num_inputs; ++d) {
    const float xd = valid ? x[(size_t)d * args.n_rows + row] : 0.f;
    sx[d] = xd * expf(-lsa[d]);
  }
}

// Encodes one row: its encoded features times `rs` go to h0[k * ldh].
__device__ __forceinline__ void encode_row(const TrainArgs& args, int e,
                                           int row, bool valid, float* h0,
                                           int ldh, float rs) {
  const int d_in = args.num_inputs;
  const int n = args.n_rows;
  const float* fsr = args.fs_raw + (size_t)e * args.num_groups;
  float sx[kMaxInputs];
  scaled_inputs(args, e, row, valid, sx);
  int k = 0, g = 0;
  float fs = softplus(fsr[g++]);
  for (int d = 0; d < d_in; ++d) h0[(k + d) * ldh] = (sx[d] * fs) * rs;
  k += d_in;
  for (int i = 0; i < d_in; ++i) {
    const int deg = args.fourier_degree[i];
    if (deg <= 0) continue;
    fs = softplus(fsr[g++]);
    const float theta = kTwoPi * sx[i];
    float c = cosf(theta), s = sinf(theta);
    for (int kk = 0; kk < deg; ++kk) {
      const float dk = 1.f / (float)(kk + 1);
      h0[(k + kk) * ldh] = ((c * dk) * fs) * rs;
      h0[(k + deg + kk) * ldh] = ((s * dk) * fs) * rs;
      const float c2 = 2.f * c * c - 1.f;
      s = 2.f * s * c;
      c = c2;
    }
    k += 2 * deg;
  }
  if (args.num_seasonal > 0) {
    const float* seasonal = group_rows(
        args.seasonal, args.seasonal_group_stride, args.seasonal_rep, e);
    fs = softplus(fsr[g++]);
    for (int q = 0; q < args.num_seasonal; ++q) {
      const float v = valid ? seasonal[(size_t)q * n + row] : 0.f;
      h0[(k + q) * ldh] = (v * fs) * rs;
    }
    k += args.num_seasonal;
  }
  if (args.num_pairs > 0) {
    fs = softplus(fsr[g++]);
    for (int p = 0; p < args.num_pairs; ++p) {
      h0[(k + p) * ldh] = ((sx[args.pair_a[p]] * sx[args.pair_b[p]]) * fs) * rs;
    }
  }
}

// kBf16: the 'bf16' precision. args.w then points at the bf16-rounded weight
// copies, and the matmul inputs and W dv cotangents in shared memory are
// rounded where they are written (see the header).
template <int TR, int kLik, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    train_tile_kernel(const TrainArgs args) {
  constexpr int RT = TR / kRowGroups;  // rows per thread, a multiple of 4
  constexpr int LDH = TR + 4;          // padded row stride of the buffers
  static_assert(RT % 4 == 0, "rows per thread must allow float4 loads");
  static_assert(TR <= 32, "per-row phases run in warp 0");

  extern __shared__ __align__(16) float smem[];
  const int depth = args.depth;
  const int width = args.width;
  const int f = args.num_features;
  const int kmax = max(f, width);
  float* bufs[2] = {smem, smem + kmax * LDH};
  float* w_tile = smem + 2 * kmax * LDH;  // [kKTile][kLdw]
  float* dv_out = w_tile + kKTile * kLdw;  // [TR]
  float* red = dv_out + TR;                // [kWarps]

  const int tid = threadIdx.x;
  const int e = blockIdx.y;
  const int col0 = blockIdx.x * TR;        // column in the chunk's scratch
  const int grow0 = args.row0 + col0;      // first row of the tile
  const int n_valid = args.n_valid;
  const size_t ld = args.ld;
  const int num_w = depth + 1;
  const float* scales_raw = args.scales_raw + (size_t)e * num_w;
  const float wgt = sigmoid(args.logit[e]);
  float* partials =
      args.partials +
      ((size_t)e * args.num_tiles + args.tile0 + blockIdx.x) * args.num_partials;

  // --- Encode: h_0 / sqrt(F) into bufs[0], one row per thread of warp 0.
  if (tid < TR) {
    const int row = grow0 + tid;
    encode_row(args, e, row, row < n_valid, bufs[0] + tid, LDH,
               args.rsqrt[0]);
  }
  __syncthreads();
  {
    float* lhs = args.lhs[0] + (size_t)e * f * ld + col0;
    for (int i = tid; i < f * TR; i += kThreads) {
      float* h0 = bufs[0] + (i / TR) * LDH + i % TR;
      lhs[(i / TR) * ld + i % TR] = *h0;
      if constexpr (kBf16) *h0 = round_bf16(*h0);
    }
    // The rounded h_0 is read by other threads next (block_matmul starts
    // with a barrier, the depth-0 output layer does not).
    if constexpr (kBf16) __syncthreads();
  }

  // --- Forward; z_l and the next layer's input go to scratch.
  int fan_in = f;
  for (int l = 0; l < depth; ++l) {
    const float* w = args.w[l] + (size_t)e * fan_in * width;
    const float* b = args.b[l] + (size_t)e * width;
    const float s = softplus(scales_raw[l]);
    const float rs_next = args.rsqrt[l + 1];
    float* hout = bufs[(l + 1) & 1];
    float* zg = args.z[l] + (size_t)e * width * ld + col0;
    float* lhs = args.lhs[l + 1] + (size_t)e * width * ld + col0;
    block_matmul<TR, false>(
        w, fan_in, width, width, bufs[l & 1], w_tile,
        [&](int j, int r0, const float (&vals)[RT]) {
          const float bj = __ldg(b + j);
#pragma unroll
          for (int i = 0; i < RT; ++i) hout[j * LDH + r0 + i] = s * (vals[i] + bj);
        });
    __syncthreads();
    // z_l to scratch and h_{l+1} / sqrt(width) in its place, row-contiguous
    // so that a warp's stores are whole 128-byte lines.
    for (int i = tid; i < width * TR; i += kThreads) {
      const int j = i / TR, r = i % TR;
      const float zz = hout[j * LDH + r];
      const float h = blended_act(zz, wgt) * rs_next;
      zg[j * ld + r] = zz;
      lhs[j * ld + r] = h;
      hout[j * LDH + r] = kBf16 ? round_bf16(h) : h;
    }
    __syncthreads();
    fan_in = width;
  }

  // --- Output layer (fixed-order reduction per row), loss and pred-cotangent.
  const float* w_out = args.w[depth] + (size_t)e * fan_in;
  {
    constexpr int G = kThreads / TR;
    const float* hin = bufs[depth & 1];
    const int r = tid % TR, g = tid / TR;
    float part = 0.f;
    for (int k = g; k < fan_in; k += G) part = fmaf(hin[k * LDH + r], __ldg(w_out + k), part);
    w_tile[g * TR + r] = part;  // free: every warp passed the barrier above
    __syncthreads();
    if (tid < 32) {
      float rr = 0.f, gv = 0.f;
      [[maybe_unused]] float dr = 0.f, dp2 = 0.f;
      if (tid < TR) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < G; ++q) acc += w_tile[q * TR + tid];
        const int row = grow0 + tid;
        const float v_out = acc + args.b[depth][e];
        const float s_out = softplus(scales_raw[depth]);
        const float pred = s_out * v_out;
        float gg;
        if constexpr (kLik == kNormal) {
          const float sigma = 0.01f + expf(args.obs_raw[(size_t)e * 3]);
          const float inv_sigma2 = 1.f / (sigma * sigma);
          const float* y =
              group_rows(args.y, args.y_group_stride, args.y_rep, e);
          const float res = row < n_valid ? pred - y[row] : 0.f;
          gg = args.lik_scale * inv_sigma2 * res;
          rr = res * res;
        } else {
          const bool valid = row < n_valid;
          const float* y =
              group_rows(args.y, args.y_group_stride, args.y_rep, e);
          const float* obs = args.obs_raw + (size_t)e * 3;
          float lp, g, dlp_dr, dlp_dp2;
          count_likelihood_row<kLik>(pred, valid ? y[row] : 0.f, obs[1],
                                     obs[2], &lp, &g, &dlp_dr, &dlp_dp2);
          // Selected, not multiplied by the row mask: see the header.
          gg = valid ? args.lik_scale * g : 0.f;
          rr = valid ? lp : 0.f;
          dr = valid ? dlp_dr : 0.f;
          dp2 = valid ? dlp_dp2 : 0.f;
        }
        const float dvo = gg * s_out;
        // Only the W_out dv_out product below reads the shared copy.
        dv_out[tid] = kBf16 ? round_bf16(dvo) : dvo;
        args.dv[depth][(size_t)e * ld + col0 + tid] = dvo;
        gv = gg * v_out;
      }
      rr = warp_sum(rr);
      gv = warp_sum(gv);
      if constexpr (kLik != kNormal) {
        dr = warp_sum(dr);
        dp2 = warp_sum(dp2);
      }
      if (tid == 0) {
        partials[kPartRR] = rr;
        partials[kPartGV] = gv;
        if constexpr (kLik != kNormal) {
          partials[args.num_partials - 2] = dr;
          partials[args.num_partials - 1] = dp2;
        }
      }
    }
  }
  __syncthreads();

  // --- Backward. dh_depth = W_out dv_out / sqrt(fan_in), into the buffer that
  // held the output layer's input (already in scratch for the dW sums).
  float* cur = bufs[depth & 1];
  {
    const float rs = args.rsqrt[depth];
    for (int i = tid; i < fan_in * TR; i += kThreads) {
      const int k = i / TR, r = i % TR;
      cur[k * LDH + r] = (__ldg(w_out + k) * dv_out[r]) * rs;
    }
  }
  __syncthreads();

  float dlogit = 0.f;
  for (int l = depth - 1; l >= 0; --l) {
    const float s = softplus(scales_raw[l]);
    const float* zg = args.z[l] + (size_t)e * width * ld + col0;
    float* dvg = args.dv[l] + (size_t)e * width * ld + col0;
    float dzz = 0.f;
    for (int i = tid; i < width * TR; i += kThreads) {
      const int j = i / TR, r = i % TR;
      const float z = zg[j * ld + r];
      float dact_dz, dact_dw;
      blended_act_grad(z, wgt, &dact_dz, &dact_dw);
      const float dh = cur[j * LDH + r];
      dlogit += dh * dact_dw;
      const float dz = dh * dact_dz;
      dzz += dz * z;
      const float dv = dz * s;
      // Only the W dv product reads the shared copy; db_l sums the fp32 one.
      cur[j * LDH + r] = kBf16 ? round_bf16(dv) : dv;
      dvg[j * ld + r] = dv;
    }
    dzz = block_sum(dzz, red);
    if (tid == 0) partials[kPartDzz + l] = dzz;
    __syncthreads();

    // dh_l = W_l dv_l / sqrt(fan_in_l), W_l of shape (fan_in_l, width).
    const int fi = l == 0 ? f : width;
    const float* w = args.w[l] + (size_t)e * fi * width;
    const float rs = args.rsqrt[l];
    float* nxt = cur == bufs[0] ? bufs[1] : bufs[0];
    if (fi <= kNarrowRows) {
      narrow_matmul<TR>(w, width, fi, cur, nxt, rs);
    } else {
      block_matmul<TR, true>(
          w, width, fi, width, cur, w_tile,
          [&](int c, int r0, const float (&vals)[RT]) {
#pragma unroll
            for (int i = 0; i < RT; ++i) nxt[c * LDH + r0 + i] = vals[i] * rs;
          });
    }
    __syncthreads();
    cur = nxt;
  }
  dlogit = block_sum(dlogit, red);
  if (tid == 0) partials[kPartLogit] = dlogit;

  // --- Encode backward: cur holds d loss / d h_0 (F x TR).
  if (tid < 32) {
    const int d_in = args.num_inputs;
    const int num_groups = args.num_groups;
    float dsx[kMaxInputs];
    float dfs[kMaxGroups];
    for (int d = 0; d < kMaxInputs; ++d) dsx[d] = 0.f;
    for (int g = 0; g < kMaxGroups; ++g) dfs[g] = 0.f;
    float sx[kMaxInputs];
    if (tid < TR) {
      const int row = grow0 + tid;
      const bool valid = row < n_valid;
      const float* dh0 = cur + tid;
      const float* fsr = args.fs_raw + (size_t)e * num_groups;
      // The forward's buffers are overwritten by now: recompute sx, and the
      // octave chains below, from the raw inputs.
      scaled_inputs(args, e, row, valid, sx);
      int k = 0, g = 0;
      float fs = softplus(fsr[g]);
      float acc = 0.f;
      for (int d = 0; d < d_in; ++d) {
        const float dg = dh0[(k + d) * LDH];
        acc += dg * sx[d];
        dsx[d] = dg * fs;
      }
      dfs[g++] = acc;
      k += d_in;
      for (int i = 0; i < d_in; ++i) {
        const int deg = args.fourier_degree[i];
        if (deg <= 0) continue;
        fs = softplus(fsr[g]);
        const float theta = kTwoPi * sx[i];
        float c = cosf(theta), s = sinf(theta);
        float dtheta = 0.f;
        acc = 0.f;
        for (int kk = 0; kk < deg; ++kk) {
          const float dk = 1.f / (float)(kk + 1);
          const float dgc = dh0[(k + kk) * LDH];
          const float dgs = dh0[(k + deg + kk) * LDH];
          acc += dgc * (c * dk);
          acc += dgs * (s * dk);
          const float coef = (float)(1 << kk) / (float)(kk + 1);
          dtheta += coef * ((dgs * fs) * c - (dgc * fs) * s);
          const float c2 = 2.f * c * c - 1.f;
          s = 2.f * s * c;
          c = c2;
        }
        dsx[i] += kTwoPi * dtheta;
        dfs[g++] = acc;
        k += 2 * deg;
      }
      if (args.num_seasonal > 0) {
        const float* seasonal = group_rows(
            args.seasonal, args.seasonal_group_stride, args.seasonal_rep, e);
        acc = 0.f;
        for (int q = 0; q < args.num_seasonal; ++q) {
          const float v =
              valid ? seasonal[(size_t)q * args.n_rows + row] : 0.f;
          acc += dh0[(k + q) * LDH] * v;
        }
        dfs[g++] = acc;
        k += args.num_seasonal;
      }
      if (args.num_pairs > 0) {
        fs = softplus(fsr[g]);
        acc = 0.f;
        for (int p = 0; p < args.num_pairs; ++p) {
          const int pa = args.pair_a[p], pb = args.pair_b[p];
          const float dg = dh0[(k + p) * LDH];
          acc += dg * (sx[pa] * sx[pb]);
          const float dgs = dg * fs;
          dsx[pa] += dgs * sx[pb];
          dsx[pb] += dgs * sx[pa];
        }
        dfs[g++] = acc;
      }
      for (int d = 0; d < d_in; ++d) dsx[d] = dsx[d] * (-sx[d]);
    }
    float* out = partials + kPartDzz + depth;
    for (int d = 0; d < d_in; ++d) {
      const float v = warp_sum(dsx[d]);
      if (tid == 0) out[d] = v;
    }
    for (int g = 0; g < num_groups; ++g) {
      const float v = warp_sum(dfs[g]);
      if (tid == 0) out[d_in + g] = v;
    }
  }
}

struct FinalArgs {
  const float* partials;   // (E, num_tiles, num_partials)
  const float* fs_raw;     // (E, G)
  const float* scales_raw; // (E, depth + 1)
  const float* logit;      // (E,)
  const float* obs_raw;    // (E, 3)
  float* losses;           // (E,)
  float* dlsa;             // (E, D)
  float* dfs;              // (E, G)
  float* dscales;          // (E, depth + 1)
  float* dlogit;           // (E,)
  float* dobs;             // (E, 3)
  float lik_scale;
  int likelihood;          // Lik
  int n_valid;             // rows that count
  int depth;
  int num_inputs;
  int num_groups;
  int num_tiles;
  int num_partials;
};

// One block of 32 threads per member: thread p sums partial p over the
// tiles in order; thread 0 then applies the scalar chain rules.
__global__ void finalize_kernel(const FinalArgs args) {
  __shared__ float sums[32];
  const int e = blockIdx.x, p = threadIdx.x;
  const int np = args.num_partials;
  if (p < np) {
    const float* src = args.partials + (size_t)e * args.num_tiles * np + p;
    float acc = 0.f;
    for (int t = 0; t < args.num_tiles; ++t) acc += src[(size_t)t * np];
    sums[p] = acc;
  }
  __syncthreads();
  if (p != 0) return;
  const int depth = args.depth, d_in = args.num_inputs;
  const int num_w = depth + 1;
  const float* obs = args.obs_raw + (size_t)e * 3;
  float* dobs = args.dobs + (size_t)e * 3;
  if (args.likelihood == kNormal) {
    const float sigma = 0.01f + expf(obs[0]);
    const float inv_sigma2 = 1.f / (sigma * sigma);
    const float rr = sums[kPartRR];
    const float nf = (float)args.n_valid;
    args.losses[e] = args.lik_scale * (0.5f * inv_sigma2 * rr +
                                       nf * (logf(sigma) + kHalfLog2Pi));
    dobs[0] = args.lik_scale * (sigma - 0.01f) *
              (nf / sigma - rr * inv_sigma2 / sigma);
    dobs[1] = 0.f;
    dobs[2] = 0.f;
  } else {
    // r = 1 / softplus(obs1): d r / d obs1 = -sigmoid(obs1) / softplus^2.
    const float s = softplus(obs[1]);
    args.losses[e] = -args.lik_scale * sums[kPartRR];
    dobs[0] = 0.f;
    dobs[1] = -args.lik_scale * sums[np - 2] * (-sigmoid(obs[1]) / (s * s));
    dobs[2] = args.likelihood == kZINB ? -args.lik_scale * sums[np - 1] : 0.f;
  }
  const float* raw = args.scales_raw + (size_t)e * num_w;
  float* dscales = args.dscales + (size_t)e * num_w;
  for (int l = 0; l < depth; ++l) {
    dscales[l] = sums[kPartDzz + l] / softplus(raw[l]) * sigmoid(raw[l]);
  }
  dscales[depth] = sums[kPartGV] * sigmoid(raw[depth]);
  const float w = sigmoid(args.logit[e]);
  args.dlogit[e] = sums[kPartLogit] * w * (1.f - w);
  const float* enc = sums + kPartDzz + depth;
  for (int d = 0; d < d_in; ++d) args.dlsa[(size_t)e * d_in + d] = enc[d];
  const float* fsr = args.fs_raw + (size_t)e * args.num_groups;
  for (int g = 0; g < args.num_groups; ++g) {
    args.dfs[(size_t)e * args.num_groups + g] = enc[d_in + g] * sigmoid(fsr[g]);
  }
}

int num_partials(int depth, int num_inputs, int num_groups, int likelihood) {
  return kPartDzz + depth + num_inputs + num_groups +
         (likelihood == kNormal ? 0 : 2);
}

// Scratch floats per chunk row and member: lhs_l (F + depth * width), z_l
// (depth * width), dv_l (depth * width + 1).
size_t floats_per_row(int num_features, int width, int depth) {
  return (size_t)num_features + 3 * (size_t)depth * width + 1;
}

template <int TR, int kLik, bool kBf16>
cudaError_t launch_tile(const TrainArgs& args, int tiles, int members,
                        size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      train_tile_kernel<TR, kLik, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  train_tile_kernel<TR, kLik, kBf16>
      <<<dim3(tiles, members), kThreads, smem_bytes, stream>>>(args);
  return cudaGetLastError();
}

template <int kLik, bool kBf16>
cudaError_t launch_tile_rows(const TrainArgs& args, int tile_rows, int tiles,
                             int members, size_t smem_bytes,
                             cudaStream_t stream) {
  switch (tile_rows) {
    case 32:
      return launch_tile<32, kLik, kBf16>(args, tiles, members, smem_bytes,
                                          stream);
    case 16:
      return launch_tile<16, kLik, kBf16>(args, tiles, members, smem_bytes,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The tile kernel of `likelihood` and precision kBf16: TR {32, 16} x
// likelihood x precision, twelve instantiations.
template <bool kBf16>
cudaError_t launch_tile_likelihood(const TrainArgs& args, int likelihood,
                                   int tile_rows, int tiles, int members,
                                   size_t smem_bytes, cudaStream_t stream) {
  switch (likelihood) {
    case kNormal:
      return launch_tile_rows<kNormal, kBf16>(args, tile_rows, tiles, members,
                                              smem_bytes, stream);
    case kNB:
      return launch_tile_rows<kNB, kBf16>(args, tile_rows, tiles, members,
                                          smem_bytes, stream);
    default:
      return launch_tile_rows<kZINB, kBf16>(args, tile_rows, tiles, members,
                                            smem_bytes, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory of one `train_tile_kernel` block (bytes); the wrapper picks
// tile_rows with it.
size_t bnf_fused_train_smem_bytes(int tile_rows, int num_features, int width) {
  const int kmax = num_features > width ? num_features : width;
  return (2 * (size_t)kmax * (tile_rows + 4) + (size_t)kKTile * kLdw +
          tile_rows + kWarps) *
         sizeof(float);
}

// Global scratch (bytes) for chunks of `chunk_rows` rows over `n_rows` rows.
size_t bnf_fused_train_scratch_bytes(int members, int num_features, int width,
                                     int depth, int num_inputs, int num_groups,
                                     int chunk_rows, int n_rows, int tile_rows,
                                     int likelihood) {
  const size_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  return ((size_t)members * chunk_rows *
              floats_per_row(num_features, width, depth) +
          (size_t)members * tiles *
              num_partials(depth, num_inputs, num_groups, likelihood)) *
         sizeof(float);
}

// Loss and gradients of the training objective under `likelihood` (Lik:
// 0 NORMAL, 1 NB, 2 ZINB) at `precision` (0 fp32, 1 bf16) on `stream`.
// Pointers are device pointers to contiguous float32 tensors, except the
// host arrays `weights`, `biases`, `dweights`, `dbiases`, `weights16` (depth
// + 1 device pointers; `weights16`, buffers shaped like the weights that
// receive their bf16-rounded copies, is read only under bf16), `rsqrts`
// (depth + 1 floats), `fourier_degrees` (num_inputs ints) and `pairs` (2 *
// num_pairs ints). `x`, `seasonal` and `y` hold one row set per group of
// `*_rep` members, `*_group_stride` floats apart (stride 0 and rep 1 for a
// set shared by every member). `scratch` holds
// bnf_fused_train_scratch_bytes(...) bytes. `n_rows` is the rows' stride;
// rows at index `n_valid` (0 <= n_valid <= n_rows) and past it count for
// nothing. Returns the first launch's cudaError_t that is not cudaSuccess,
// or 0.
int bnf_fused_train(const void* x, const void* seasonal, const void* y,
                    const void* const* weights, const void* const* biases,
                    const void* lsa_eff, const void* fs_raw,
                    const void* scales_raw, const void* logit,
                    const void* obs_raw, void* losses, void* dlsa, void* dfs,
                    void* const* dweights, void* const* dbiases, void* dscales,
                    void* dlogit, void* dobs, void* scratch,
                    const float* rsqrts, const int* fourier_degrees,
                    const int* pairs, size_t x_group_stride, int x_rep,
                    size_t seasonal_group_stride, int seasonal_rep,
                    size_t y_group_stride, int y_rep, float lik_scale,
                    int likelihood, int precision,
                    void* const* weights16, int depth, int members,
                    int num_inputs, int num_seasonal, int num_pairs, int width,
                    int n_rows, int n_valid, int tile_rows, int chunk_rows,
                    void* stream) {
  if (depth < 0 || depth + 1 > kMaxLayers || members < 1 || members > 65535 ||
      n_rows < 1 || n_valid < 0 || n_valid > n_rows || num_inputs < 1 ||
      num_inputs > kMaxInputs ||
      num_pairs < 0 || num_pairs > kMaxPairs || num_seasonal < 0 ||
      chunk_rows < tile_rows || chunk_rows % tile_rows != 0 || x_rep < 1 ||
      members % x_rep != 0 || seasonal_rep < 1 || members % seasonal_rep != 0 ||
      y_rep < 1 || members % y_rep != 0 || likelihood < kNormal ||
      likelihood > kZINB || precision < 0 || precision > 1 ||
      (precision == 1 && weights16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = precision == 1;
  TrainArgs args = {};
  int num_features = num_inputs + num_seasonal + num_pairs;
  int num_groups = 1 + (num_seasonal > 0) + (num_pairs > 0);
  for (int i = 0; i < num_inputs; ++i) {
    args.fourier_degree[i] = fourier_degrees[i];
    if (fourier_degrees[i] > 0) {
      num_features += 2 * fourier_degrees[i];
      ++num_groups;
    }
  }
  for (int p = 0; p < num_pairs; ++p) {
    args.pair_a[p] = pairs[2 * p];
    args.pair_b[p] = pairs[2 * p + 1];
    if (args.pair_a[p] < 0 || args.pair_a[p] >= num_inputs ||
        args.pair_b[p] < 0 || args.pair_b[p] >= num_inputs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (depth == 0) width = num_features;
  const int np = num_partials(depth, num_inputs, num_groups, likelihood);
  if (np > 32) return static_cast<int>(cudaErrorInvalidValue);

  args.x = static_cast<const float*>(x);
  args.seasonal = static_cast<const float*>(seasonal);
  args.y = static_cast<const float*>(y);
  args.x_group_stride = x_group_stride;
  args.seasonal_group_stride = seasonal_group_stride;
  args.y_group_stride = y_group_stride;
  args.x_rep = x_rep;
  args.seasonal_rep = seasonal_rep;
  args.y_rep = y_rep;
  for (int l = 0; l <= depth; ++l) {
    args.w[l] = static_cast<const float*>(weights[l]);
    args.b[l] = static_cast<const float*>(biases[l]);
    args.rsqrt[l] = rsqrts[l];
  }
  args.lsa_eff = static_cast<const float*>(lsa_eff);
  args.fs_raw = static_cast<const float*>(fs_raw);
  args.scales_raw = static_cast<const float*>(scales_raw);
  args.logit = static_cast<const float*>(logit);
  args.obs_raw = static_cast<const float*>(obs_raw);
  args.lik_scale = lik_scale;
  args.depth = depth;
  args.num_inputs = num_inputs;
  args.num_seasonal = num_seasonal;
  args.num_pairs = num_pairs;
  args.num_groups = num_groups;
  args.num_features = num_features;
  args.width = width;
  args.n_rows = n_rows;
  args.n_valid = n_valid;
  args.ld = chunk_rows;
  args.num_tiles = (n_rows + tile_rows - 1) / tile_rows;
  args.num_partials = np;

  // Carve the scratch: lhs_0..lhs_depth, z_0..z_{depth-1}, dv_0..dv_depth,
  // then the partials.
  float* p = static_cast<float*>(scratch);
  const size_t rows = (size_t)members * chunk_rows;
  for (int l = 0; l <= depth; ++l) {
    args.lhs[l] = p;
    p += rows * (l == 0 ? num_features : width);
  }
  for (int l = 0; l < depth; ++l) {
    args.z[l] = p;
    p += rows * width;
  }
  for (int l = 0; l <= depth; ++l) {
    args.dv[l] = p;
    p += rows * (l == depth ? 1 : width);
  }
  args.partials = p;

  const size_t smem = bnf_fused_train_smem_bytes(tile_rows, num_features, width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (bf16) {
    // The tile kernel reads the rounded copies in place of the weights.
    for (int l = 0; l <= depth; ++l) {
      const size_t n = (size_t)members * (l == 0 ? num_features : width) *
                       (l == depth ? 1 : width);
      float* out = static_cast<float*>(weights16[l]);
      const size_t blocks = (n + kThreads - 1) / kThreads;
      round_bf16_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads,
                          0, s>>>(args.w[l], out, n);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      args.w[l] = out;
    }
  }
  // The hidden weight gradients round their operands under bf16 where the
  // TPU kernel does: when dv_l has more than one column (width > 1).
  const bool round_wgrad = bf16 && width > 1;
  for (int row0 = 0; row0 < n_rows; row0 += chunk_rows) {
    const int chunk = n_rows - row0 < chunk_rows ? n_rows - row0 : chunk_rows;
    const int tiles = (chunk + tile_rows - 1) / tile_rows;
    const int len = tiles * tile_rows;
    const int acc = row0 > 0;
    args.row0 = row0;
    args.tile0 = row0 / tile_rows;
    err = bf16 ? launch_tile_likelihood<true>(args, likelihood, tile_rows,
                                              tiles, members, smem, s)
               : launch_tile_likelihood<false>(args, likelihood, tile_rows,
                                               tiles, members, smem, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int fan_in = num_features;
    for (int l = 0; l < depth; ++l) {
      const dim3 grid((width + kGTile - 1) / kGTile,
                      (fan_in + kGTile - 1) / kGTile, members);
      float* dw = static_cast<float*>(dweights[l]);
      if (round_wgrad) {
        wgrad_kernel<true><<<grid, kThreads, 0, s>>>(
            args.lhs[l], args.dv[l], dw, fan_in, width, len, chunk_rows, acc);
      } else {
        wgrad_kernel<false><<<grid, kThreads, 0, s>>>(
            args.lhs[l], args.dv[l], dw, fan_in, width, len, chunk_rows, acc);
      }
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
      fan_in = width;
    }
    for (int l = 0; l <= depth; ++l) {
      const int fan_out = l == depth ? 1 : width;
      const int warps = members * fan_out;
      rowdot_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          args.dv[l], nullptr, static_cast<float*>(dbiases[l]), members,
          fan_out, len, chunk_rows, acc);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
    {
      const int warps = members * fan_in;
      rowdot_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          args.lhs[depth], args.dv[depth], static_cast<float*>(dweights[depth]),
          members, fan_in, len, chunk_rows, acc);
      if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    }
  }

  FinalArgs fin = {};
  fin.partials = args.partials;
  fin.fs_raw = args.fs_raw;
  fin.scales_raw = args.scales_raw;
  fin.logit = args.logit;
  fin.obs_raw = args.obs_raw;
  fin.losses = static_cast<float*>(losses);
  fin.dlsa = static_cast<float*>(dlsa);
  fin.dfs = static_cast<float*>(dfs);
  fin.dscales = static_cast<float*>(dscales);
  fin.dlogit = static_cast<float*>(dlogit);
  fin.dobs = static_cast<float*>(dobs);
  fin.lik_scale = lik_scale;
  fin.likelihood = likelihood;
  fin.n_valid = n_valid;
  fin.depth = depth;
  fin.num_inputs = num_inputs;
  fin.num_groups = num_groups;
  fin.num_tiles = args.num_tiles;
  fin.num_partials = np;
  finalize_kernel<<<members, 32, 0, s>>>(fin);
  return static_cast<int>(cudaGetLastError());
}

const char* bnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
