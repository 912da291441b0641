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
// clamped at -15. The likelihood is a template parameter of the head kernel.
//
// What bounds it: at the training path's shapes (64 members x 38,096 rows,
// width 512, depth 2, 49 encoded features) one call is ~4.2 TFLOP of fp32
// FMA (1.73 MFLOP per row and member: the forward, the backward's
// W dv products, and the weight-gradient contraction over rows), so it is
// bound by the SIMT fp32 pipe. Memory traffic is the scratch below, a few
// GB per call.
//
// Design: layer by layer. The TPU kernel keeps a member's weights, the
// tile's activations and the running weight gradients in VMEM across its
// sequential row tiles. A Hopper block has 227 KB of shared memory and one
// width-512 weight matrix is 1 MiB, so a block that carries a few rows
// through every layer re-streams each weight for those few rows. Instead
// each matrix product of a chunk of rows (sized so the scratch stays under
// the wrapper's budget) is one GEMM over all of the chunk's rows, on the
// register-tiled engine of `simt_gemm.cuh` (128 x 128 tiles, 8 x 8 per
// thread, cp.async stages), with the elementwise work fused into its
// epilogue. Activations live features-major in a global scratch
// (E, features, ld). Per chunk:
//   1. `encode_kernel`, one thread per (member, row): lhs_0 = h_0 / sqrt(F).
//   2. `forward_kernel` for each hidden layer l: the product W_l^T lhs_l, its
//      epilogue writing z_l and lhs_{l+1} = act(z_l) / sqrt(width).
//   3. `head_kernel<likelihood>`, one thread per (member, row): pred, the
//      likelihood's row terms, dv_out, and the last hidden layer's
//      dv = (w_out dv_out / sqrt(width)) act'(z) s (at depth 0 instead
//      dh_0 = w_out dv_out / sqrt(F)).
//   4. `backward_kernel` for l = depth - 1 down to 1: dh = W_l dv_l /
//      sqrt(fan_in_l), its epilogue writing dv_{l-1} = dh act'(z_{l-1})
//      s_{l-1}; for l = 0 the same product, with F outputs, writes dh_0.
//   5. `encode_backward_kernel`, one thread per (member, row): the lsa and
//      fs gradients' rows from dh_0.
//   6. `wgrad_kernel` (dW_l += lhs_l dv_l^T over the chunk's rows) and
//      `rowdot_kernel` (db_l, and dW_out += lhs_depth dv_out), as before.
// and once at the end `finalize_kernel` sums the per-tile partials in a fixed
// order and applies the scalar chain rules. The layer kernels of steps 2, 4
// and 6 (and their tensor-core versions below) live in `field_layers.cuh`,
// shared with K2 and K3 (`fused_mlp_t.cu`). The scalar sums are per 128-row
// tile (and per 128-column block of a layer's dz z and dh dact/dw sums), in
// a fixed order within each; there are no atomics, so a call is bitwise
// reproducible. Each product's outputs are one FMA chain in k order, so z,
// lhs, dv and the weight and bias gradients do not depend on the tiling.
// Rows of the last tile past the chunk read x = 0 and carry a zero loss
// cotangent, so they add exactly zero to every sum. (A count likelihood
// evaluated on such a row could give inf or NaN, and 0 * NaN is NaN, so the
// count epilogue selects with the row's validity instead of multiplying.)
//
// Valid rows. `n_rows` is the rows' stride in x, seasonal and y; only rows
// below `n_valid` <= n_rows count (the TPU kernel's dynamic `n_valid`, stage
// 4: a row shard of a mesh fit holds its valid rows then padding). Rows at
// n_valid and past it are treated as the last tile's padding: their
// inputs and targets are selected out (never read into a result, so a NaN
// there cannot leak), they carry a zero cotangent, and the NORMAL loss
// counts n_valid rows. Chunks and tiles still cover all n_rows rows.
//
// Inputs. x, seasonal and y are each shared by every member (a group stride
// of 0), or stored once per group of `rep` consecutive members: member e
// reads group e / rep, as the TPU kernel's index maps do. rep = 1 is one row
// set per member (minibatch MAP); rep = S serves a member's one minibatch to
// all S of its Monte-Carlo draws (VI), with no S-fold copy of the batch.
// Only the encode, head and encode-backward kernels read them; the scratch
// and every other kernel work per member already.
//
// Precision. Under 'bf16' every matrix product the TPU kernel casts (its
// `_mm_t`, where the second operand's free dimension exceeds 1) takes its
// operands rounded to bf16 (nearest even), multiplies them exactly and sums
// in fp32: the hidden and output forwards, the backward's W dv products (the
// output layer's included) and the hidden weight gradients. The output
// layer's weight gradient, the bias gradients and every scalar partial stay
// fp32, as do the parameters, the encode, the activations and the
// likelihood (and a hidden weight gradient of one column, width 1, summed by
// `rowdot_kernel` as the output layer's is).
//
// The three hidden-GEMM families then run on the tensor cores, in
// `wgmma_gemm.cuh`'s core (TMA into 3 mbarrier stages, 128-byte swizzle,
// wgmma m64n128k16 with fp32 accumulators): `tc_forward_kernel`,
// `tc_backward_kernel` and `tc_wgrad_kernel`, on the same 128 x 128 tiles,
// grids and partials as the fp32 kernels. Their operands are bf16 in device
// memory: the call copies each hidden W_l rounded, its rows padded to a
// multiple of 8 columns for TMA's 16-byte strides (`weights_bf16_kernel`);
// the encode and the forward epilogues write a bf16 twin of each lhs_l
// (l < depth) beside the fp32 one, and the head and the backward epilogues
// one of each dv_l. The fp32 copies stay for their fp32 readers: the head,
// the backward epilogue's z, `rowdot_kernel`. One 3-D tensor map per operand
// (rows or columns, features, members) serves every member and chunk. The
// head kernel rounds the output layer's operands in registers.
//
// What bounds 'bf16' now: at the main shape the three families are 905
// GFLOP, ~0.9 ms at the tensor cores' peak, while the scratch their
// epilogues read and write in fp32 (z, lhs, dv and the twins) is ~11 GB,
// ~3 ms at 3.35 TB/s, so the call is bound by those bytes and by the
// epilogues' elementwise work between the products. The design keeps every
// product on the tensor cores with its operands fetched by TMA and fuses the
// elementwise work into the epilogues; two blocks an SM overlap one tile's
// epilogue with another tile's products (kTcBlocksPerSm). Overlapping them
// within a block (warp specialisation, persistence) is later work.
// Each output is still summed over K in a fixed order of k16 steps within
// one block, so two identical calls are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "field_layers.cuh"

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
//   then num_inputs sums of d loss / d lsa, then num_groups sums
//   <dh0_g, raw_g> (before the sigmoid(fs_raw) factor);
//   NB and ZINB add two last ones: sum d lp / d r (the shape gradient's
//   rows) and sum d lp / d obs2 (the zero-inflation gradient's rows).
// And per (member, row tile, hidden layer l, 128-column block of z_l):
//   sum dz_l * z_l and sum dh_{l+1} * d act / d w.
constexpr int kPartRR = 0;
constexpr int kPartGV = 1;
constexpr int kPartEnc = 2;

// The field MLP's part (`FieldArgs`, shared with the layer kernels of
// `field_layers.cuh`), and the encode's inputs and the likelihood's.
struct TrainArgs : FieldArgs {
  const float* x;                  // (D, N) or (E / x_rep, D, N)
  const float* seasonal;           // (S2, N) or (E / seasonal_rep, S2, N)
  const float* y;                  // (N,) or (E / y_rep, N)
  size_t x_group_stride;           // floats between groups; 0 when shared
  size_t seasonal_group_stride;
  size_t y_group_stride;
  int x_rep;                       // members per group
  int seasonal_rep;
  int y_rep;
  const float* lsa_eff;            // (E, D): lsa + log(input_scales)
  const float* fs_raw;             // (E, G)
  const float* obs_raw;            // (E, 3)
  float* partials;                 // (E, num_tiles, num_partials)
  float lik_scale;
  int fourier_degree[kMaxInputs];
  int pair_a[kMaxPairs];
  int pair_b[kMaxPairs];
  int num_inputs;
  int num_seasonal;
  int num_pairs;
  int num_groups;
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

// Encodes one row: `emit(k, v)` receives encoded feature k times `rs`.
template <typename Emit>
__device__ __forceinline__ void encode_row(const TrainArgs& args, int e,
                                           int row, bool valid, float rs,
                                           Emit emit) {
  const int d_in = args.num_inputs;
  const int n = args.n_rows;
  const float* fsr = args.fs_raw + (size_t)e * args.num_groups;
  float sx[kMaxInputs];
  scaled_inputs(args, e, row, valid, sx);
  int k = 0, g = 0;
  float fs = softplus(fsr[g++]);
  for (int d = 0; d < d_in; ++d) emit(k + d, (sx[d] * fs) * rs);
  k += d_in;
  for (int i = 0; i < d_in; ++i) {
    const int deg = args.fourier_degree[i];
    if (deg <= 0) continue;
    fs = softplus(fsr[g++]);
    const float theta = kTwoPi * sx[i];
    float c = cosf(theta), s = sinf(theta);
    for (int kk = 0; kk < deg; ++kk) {
      const float dk = 1.f / (float)(kk + 1);
      emit(k + kk, ((c * dk) * fs) * rs);
      emit(k + deg + kk, ((s * dk) * fs) * rs);
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
      emit(k + q, (v * fs) * rs);
    }
    k += args.num_seasonal;
  }
  if (args.num_pairs > 0) {
    fs = softplus(fsr[g++]);
    for (int p = 0; p < args.num_pairs; ++p) {
      emit(k + p, ((sx[args.pair_a[p]] * sx[args.pair_b[p]]) * fs) * rs);
    }
  }
}

// The per-row kernels' block sums: at most one per input and per group.
constexpr int kMaxSums = kMaxInputs + kMaxGroups;

// --- 1. Encode: lhs_0 = h_0 / sqrt(F), one thread per (row, member), and
// under kBf16 its twin (when a hidden layer reads it); grid (row tiles of
// the chunk, members).
template <bool kBf16>
__global__ void __launch_bounds__(kRowTile) encode_kernel(const TrainArgs args) {
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + threadIdx.x;
  const int row = args.row0 + col;
  const size_t off = (size_t)e * args.num_features * args.ld + col;
  float* h0 = args.lhs[0] + off;
  __nv_bfloat16* h0_bf =
      kBf16 && args.depth > 0 ? args.lhs_bf[0] + off : nullptr;
  encode_row(args, e, row, row < args.n_valid, args.rsqrt[0],
             [&](int k, float v) {
               h0[k * args.ld] = v;
               if (h0_bf != nullptr) h0_bf[k * args.ld] = __float2bfloat16_rn(v);
             });
}

// --- 3. The output layer, the likelihood and the last hidden layer's
// cotangent, one thread per (row, member); grid (row tiles, members).
template <int kLik, bool kBf16>
__global__ void __launch_bounds__(kRowTile) head_kernel(const TrainArgs args) {
  __shared__ float red[kMaxSums * kRowWarps];
  __shared__ float sums[4];
  const int tid = threadIdx.x;
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + tid;
  const int row = args.row0 + col;
  const int tile = args.tile0 + blockIdx.x;
  const bool valid = row < args.n_valid;
  const int depth = args.depth;
  const int fan_in = depth ? args.width : args.num_features;
  const size_t ld = args.ld;
  const int num_w = depth + 1;
  const float* scales_raw = args.scales_raw + (size_t)e * num_w;
  const float wgt = sigmoid(args.logit[e]);
  const float* w_out = args.w[depth] + (size_t)e * fan_in;
  auto wo = [&](int k) { return maybe_round<kBf16>(__ldg(w_out + k), true); };

  // pred: kHeadLanes strided FMA chains over the inputs, then the chains in
  // order.
  const float* hin = args.lhs[depth] + (size_t)e * fan_in * ld + col;
  float part[kHeadLanes];
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) part[q] = 0.f;
  int k = 0;
  for (; k + kHeadLanes <= fan_in; k += kHeadLanes) {
#pragma unroll
    for (int q = 0; q < kHeadLanes; ++q) {
      part[q] = fmaf(maybe_round<kBf16>(hin[(k + q) * ld], true), wo(k + q),
                     part[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) {
    if (k + q < fan_in) {
      part[q] = fmaf(maybe_round<kBf16>(hin[(k + q) * ld], true), wo(k + q),
                     part[q]);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) acc += part[q];

  const float v_out = acc + args.b[depth][e];
  const float s_out = softplus(scales_raw[depth]);
  const float pred = s_out * v_out;
  const float* y = group_rows(args.y, args.y_group_stride, args.y_rep, e);
  float row_sums[4] = {0.f, 0.f, 0.f, 0.f};  // rr, gv, dr, dp2
  float gg;
  if constexpr (kLik == kNormal) {
    const float sigma = 0.01f + expf(args.obs_raw[(size_t)e * 3]);
    const float inv_sigma2 = 1.f / (sigma * sigma);
    const float res = valid ? pred - y[row] : 0.f;
    gg = args.lik_scale * inv_sigma2 * res;
    row_sums[0] = res * res;
  } else {
    const float* obs = args.obs_raw + (size_t)e * 3;
    float lp, g, dlp_dr, dlp_dp2;
    count_likelihood_row<kLik>(pred, valid ? y[row] : 0.f, obs[1], obs[2],
                               &lp, &g, &dlp_dr, &dlp_dp2);
    // Selected, not multiplied by the row mask: see the header.
    gg = valid ? args.lik_scale * g : 0.f;
    row_sums[0] = valid ? lp : 0.f;
    row_sums[2] = valid ? dlp_dr : 0.f;
    row_sums[3] = valid ? dlp_dp2 : 0.f;
  }
  const float dvo = gg * s_out;
  args.dv[depth][(size_t)e * ld + col] = dvo;
  row_sums[1] = gg * v_out;
  tile_sums(row_sums, kLik == kNormal ? 2 : 4, red, sums);
  if (tid == 0) {
    float* partials =
        args.partials + ((size_t)e * args.num_tiles + tile) * args.num_partials;
    partials[kPartRR] = sums[0];
    partials[kPartGV] = sums[1];
    if constexpr (kLik != kNormal) {
      partials[args.num_partials - 2] = sums[2];
      partials[args.num_partials - 1] = sums[3];
    }
  }

  // dh_depth = W_out dv_out / sqrt(fan_in).
  const float dvo_r = maybe_round<kBf16>(dvo, true);
  const float rs = args.rsqrt[depth];
  if (depth == 0) {
    float* dh0 = args.dh0 + (size_t)e * fan_in * ld + col;
    for (int c = 0; c < fan_in; ++c) dh0[c * ld] = (wo(c) * dvo_r) * rs;
    return;
  }
  // The last hidden layer: dv = dh act'(z) s, with the column blocks' sums
  // of dz z and dh dact/dw.
  const int l = depth - 1;
  const float s = softplus(scales_raw[l]);
  const float* zg = args.z[l] + (size_t)e * fan_in * ld + col;
  float* dvg = args.dv[l] + (size_t)e * fan_in * ld + col;
  // The twin the tensor-core W dv product and weight gradient read.
  __nv_bfloat16* dvg_bf =
      kBf16 ? args.dv_bf[l] + (size_t)e * fan_in * ld + col : nullptr;
  float* lp = layer_partials(args, e, tile, l);
  for (int cb = 0; cb < args.col_blocks; ++cb) {
    float dsum[2] = {0.f, 0.f};  // dz z, dh dact/dw
    const int c_end = min(fan_in, (cb + 1) * kSgTile);
    for (int c = cb * kSgTile; c < c_end; ++c) {
      const float z = zg[c * ld];
      float dact_dz, dact_dw;
      blended_act_grad(z, wgt, &dact_dz, &dact_dw);
      const float dh = (wo(c) * dvo_r) * rs;
      dsum[1] += dh * dact_dw;
      const float dz = dh * dact_dz;
      dsum[0] += dz * z;
      dvg[c * ld] = dz * s;
      if constexpr (kBf16) dvg_bf[c * ld] = __float2bfloat16_rn(dz * s);
    }
    tile_sums(dsum, 2, red, sums);
    if (tid == 0) {
      lp[cb * 2] = sums[0];
      lp[cb * 2 + 1] = sums[1];
    }
  }
}

// --- 5. Encode backward: the lsa and fs gradients' rows from dh_0, one
// thread per (row, member); grid (row tiles, members).
__global__ void __launch_bounds__(kRowTile)
    encode_backward_kernel(const TrainArgs args) {
  __shared__ float red[kMaxSums * kRowWarps];
  __shared__ float sums[kMaxSums];
  const int tid = threadIdx.x;
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + tid;
  const int row = args.row0 + col;
  const bool valid = row < args.n_valid;
  const int d_in = args.num_inputs;
  const int num_groups = args.num_groups;
  const size_t ld = args.ld;
  const float* dh0 = args.dh0 + (size_t)e * args.num_features * ld + col;
  const float* fsr = args.fs_raw + (size_t)e * num_groups;
  float grads[kMaxSums];  // dsx (then d lsa) per input, then dfs per group
  float* dsx = grads;
  float* dfs = grads + d_in;
  for (int i = 0; i < kMaxSums; ++i) grads[i] = 0.f;
  float sx[kMaxInputs];
  // Recompute sx, and the octave chains below, from the raw inputs.
  scaled_inputs(args, e, row, valid, sx);
  int k = 0, g = 0;
  float fs = softplus(fsr[g]);
  float acc = 0.f;
  for (int d = 0; d < d_in; ++d) {
    const float dg = dh0[(k + d) * ld];
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
      const float dgc = dh0[(k + kk) * ld];
      const float dgs = dh0[(k + deg + kk) * ld];
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
      const float v = valid ? seasonal[(size_t)q * args.n_rows + row] : 0.f;
      acc += dh0[(k + q) * ld] * v;
    }
    dfs[g++] = acc;
    k += args.num_seasonal;
  }
  if (args.num_pairs > 0) {
    fs = softplus(fsr[g]);
    acc = 0.f;
    for (int p = 0; p < args.num_pairs; ++p) {
      const int pa = args.pair_a[p], pb = args.pair_b[p];
      const float dg = dh0[(k + p) * ld];
      acc += dg * (sx[pa] * sx[pb]);
      const float dgs = dg * fs;
      dsx[pa] += dgs * sx[pb];
      dsx[pb] += dgs * sx[pa];
    }
    dfs[g++] = acc;
  }
  for (int d = 0; d < d_in; ++d) dsx[d] = dsx[d] * (-sx[d]);
  tile_sums(grads, d_in + num_groups, red, sums);
  if (tid == 0) {
    float* out = args.partials +
                 ((size_t)e * args.num_tiles + args.tile0 + blockIdx.x) *
                     args.num_partials +
                 kPartEnc;
    for (int i = 0; i < d_in + num_groups; ++i) out[i] = sums[i];
  }
}

struct FinalArgs {
  const float* partials;        // (E, num_tiles, num_partials)
  const float* layer_partials;  // (E, num_tiles, depth, col_blocks, 2)
  const float* fs_raw;          // (E, G)
  const float* scales_raw;      // (E, depth + 1)
  const float* logit;           // (E,)
  const float* obs_raw;         // (E, 3)
  float* losses;                // (E,)
  float* dlsa;                  // (E, D)
  float* dfs;                   // (E, G)
  float* dscales;               // (E, depth + 1)
  float* dlogit;                // (E,)
  float* dobs;                  // (E, 3)
  float lik_scale;
  int likelihood;               // Lik
  int n_valid;                  // rows that count
  int depth;
  int num_inputs;
  int num_groups;
  int num_tiles;
  int num_partials;
  int col_blocks;
};

// One block of 32 threads per member: thread p sums partial p over the
// tiles in order, and thread l < depth layer l's two sums over the tiles and
// their column blocks in order; thread 0 then applies the scalar chain rules.
__global__ void finalize_kernel(const FinalArgs args) {
  __shared__ float sums[32];
  __shared__ float dzz[kMaxLayers];
  __shared__ float dlg[kMaxLayers];
  const int e = blockIdx.x, p = threadIdx.x;
  const int np = args.num_partials;
  const int depth = args.depth, d_in = args.num_inputs;
  if (p < np) {
    const float* src = args.partials + (size_t)e * args.num_tiles * np + p;
    float acc = 0.f;
    for (int t = 0; t < args.num_tiles; ++t) acc += src[(size_t)t * np];
    sums[p] = acc;
  }
  if (p < depth) {
    const int cbs = args.col_blocks;
    float a = 0.f, b = 0.f;
    for (int t = 0; t < args.num_tiles; ++t) {
      const float* lp = args.layer_partials +
                        (((size_t)e * args.num_tiles + t) * depth + p) * cbs * 2;
      for (int cb = 0; cb < cbs; ++cb) {
        a += lp[cb * 2];
        b += lp[cb * 2 + 1];
      }
    }
    dzz[p] = a;
    dlg[p] = b;
  }
  __syncthreads();
  if (p != 0) return;
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
  float logit_sum = 0.f;
  for (int l = 0; l < depth; ++l) {
    dscales[l] = dzz[l] / softplus(raw[l]) * sigmoid(raw[l]);
    logit_sum += dlg[l];
  }
  dscales[depth] = sums[kPartGV] * sigmoid(raw[depth]);
  const float w = sigmoid(args.logit[e]);
  args.dlogit[e] = logit_sum * w * (1.f - w);
  const float* enc = sums + kPartEnc;
  for (int d = 0; d < d_in; ++d) args.dlsa[(size_t)e * d_in + d] = enc[d];
  const float* fsr = args.fs_raw + (size_t)e * args.num_groups;
  for (int g = 0; g < args.num_groups; ++g) {
    args.dfs[(size_t)e * args.num_groups + g] = enc[d_in + g] * sigmoid(fsr[g]);
  }
}

int num_partials(int num_inputs, int num_groups, int likelihood) {
  return kPartEnc + num_inputs + num_groups + (likelihood == kNormal ? 0 : 2);
}

// Scratch floats per chunk row and member: lhs_l (F + depth * width), z_l
// (depth * width), dv_l (depth * width + 1), dh_0 (F).
size_t floats_per_row(int num_features, int width, int depth) {
  return 2 * (size_t)num_features + 3 * (size_t)depth * width + 1;
}

// 'bf16': the twins' elements per chunk row and member (lhs_l and dv_l for
// l < depth).
size_t twins_per_row(int num_features, int width, int depth) {
  return depth ? num_features + (2 * (size_t)depth - 1) * width : 0;
}

template <int kLik>
void launch_head(const TrainArgs& args, bool bf16, dim3 grid,
                 cudaStream_t stream) {
  if (bf16) {
    head_kernel<kLik, true><<<grid, kRowTile, 0, stream>>>(args);
  } else {
    head_kernel<kLik, false><<<grid, kRowTile, 0, stream>>>(args);
  }
}

// One chunk's kernels 1-5 (see the header) over `tiles` row tiles; `maps`
// (the 'bf16' products' operands) when bf16.
cudaError_t launch_chunk(const TrainArgs& args, int likelihood, bool bf16,
                         const TcMaps& maps, int tiles, int members,
                         cudaStream_t s) {
  const dim3 rows(tiles, members);
  cudaError_t err;
  if (bf16) {
    encode_kernel<true><<<rows, kRowTile, 0, s>>>(args);
  } else {
    encode_kernel<false><<<rows, kRowTile, 0, s>>>(args);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_forward_layers<true>(args, bf16, maps, tiles, members, s);
  if (err != cudaSuccess) return err;
  switch (likelihood) {
    case kNormal:
      launch_head<kNormal>(args, bf16, rows, s);
      break;
    case kNB:
      launch_head<kNB>(args, bf16, rows, s);
      break;
    default:
      launch_head<kZINB>(args, bf16, rows, s);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = launch_wdv_chain<kDh0Scratch>(args, bf16, maps, tiles, members, s);
  if (err != cudaSuccess) return err;
  encode_backward_kernel<<<rows, kRowTile, 0, s>>>(args);
  return cudaGetLastError();
}

// The GEMM core alone (`bnf_tc_gemm`): out[e][m][n] = D(m, n), rows m < M
// and columns n < N of the block's tile.
template <int kAMajor, int kBMajor>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
    tc_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b,
                   float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t tc_smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  float acc[64];
  tc_mainloop<kAMajor, kBMajor>(map_a, map_b, m0, n0, e, M, N, K, tc_smem,
                                acc);
  float* o = out + (size_t)e * M * N;
  tc_epilogue(acc, m0, n0, M, [&](int m, int n, float v0, float v1) {
    if (n < N) o[(size_t)m * N + n] = v0;
    if (n + 1 < N) o[(size_t)m * N + n + 1] = v1;
  });
}

// Opts every tensor-core kernel of K1 into kTcSmemBytes of dynamic shared
// memory.
cudaError_t set_k1_tc_smem() {
  cudaError_t err;
  if ((err = set_tc_smem(tc_forward_kernel<true>)) ||
      (err = set_tc_smem(tc_backward_kernel<false>)) ||
      (err = set_tc_smem(tc_backward_kernel<true>)) ||
      (err = set_tc_smem(tc_wgrad_kernel)) ||
      (err = set_tc_smem(tc_gemm_kernel<kMNMajor, kMNMajor>)) ||
      (err = set_tc_smem(tc_gemm_kernel<kKMajor, kMNMajor>)) ||
      (err = set_tc_smem(tc_gemm_kernel<kKMajor, kKMajor>))) {
    return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Global scratch (bytes) for chunks of `chunk_rows` rows over `n_rows` rows
// at `precision` (0 fp32; 1 bf16 adds the twins and the weights' copies).
size_t bnf_fused_train_scratch_bytes(int members, int num_features, int width,
                                     int depth, int num_inputs, int num_groups,
                                     int chunk_rows, int n_rows,
                                     int likelihood, int precision) {
  const size_t tiles = (n_rows + kRowTile - 1) / kRowTile;
  const size_t bf16_elems =
      precision == 1
          ? (size_t)members *
                ((size_t)chunk_rows *
                     twins_per_row(num_features, width, depth) +
                 weight_copies(num_features, width, depth))
          : 0;
  return ((size_t)members * chunk_rows *
              floats_per_row(num_features, width, depth) +
          (size_t)members * tiles *
              (num_partials(num_inputs, num_groups, likelihood) +
               2 * (size_t)depth * col_blocks(width))) *
             sizeof(float) +
         bf16_elems * sizeof(__nv_bfloat16);
}

// Loss and gradients of the training objective under `likelihood` (Lik:
// 0 NORMAL, 1 NB, 2 ZINB) at `precision` (0 fp32, 1 bf16) on `stream`.
// Pointers are device pointers to contiguous float32 tensors, except the
// host arrays `weights`, `biases`, `dweights`, `dbiases` (depth + 1 device
// pointers), `rsqrts` (depth + 1 floats), `fourier_degrees` (num_inputs
// ints) and `pairs` (2 * num_pairs ints). `x`, `seasonal` and `y` hold one
// row set per group of `*_rep` members, `*_group_stride` floats apart
// (stride 0 and rep 1 for a set shared by every member). `scratch` holds
// bnf_fused_train_scratch_bytes(...) bytes and is 16-byte aligned;
// `chunk_rows` is a positive multiple of kRowTile (128), at most 65,535
// tiles (the GEMMs' gridDim.y).
// `n_rows` is the rows' stride; rows at index `n_valid` (0 <= n_valid <=
// n_rows) and past it count for nothing. Returns the first launch's
// cudaError_t that is not cudaSuccess, or 0.
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
                    int likelihood, int precision, int depth, int members,
                    int num_inputs, int num_seasonal, int num_pairs, int width,
                    int n_rows, int n_valid, int chunk_rows, void* stream) {
  if (depth < 0 || depth + 1 > kMaxLayers || members < 1 || members > 65535 ||
      n_rows < 1 || n_valid < 0 || n_valid > n_rows || num_inputs < 1 ||
      num_inputs > kMaxInputs || num_pairs < 0 || num_pairs > kMaxPairs ||
      num_seasonal < 0 || width < 1 || chunk_rows < kRowTile ||
      chunk_rows % kRowTile != 0 || chunk_rows / kRowTile > 65535 ||
      x_rep < 1 || members % x_rep != 0 ||
      seasonal_rep < 1 || members % seasonal_rep != 0 || y_rep < 1 ||
      members % y_rep != 0 || likelihood < kNormal || likelihood > kZINB ||
      precision < 0 || precision > 1 ||
      reinterpret_cast<uintptr_t>(scratch) % 16 != 0) {
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
  const int np = num_partials(num_inputs, num_groups, likelihood);
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
    args.w_vec[l] =
        width % 4 == 0 && reinterpret_cast<uintptr_t>(weights[l]) % 16 == 0;
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
  args.num_tiles = (n_rows + kRowTile - 1) / kRowTile;
  args.num_partials = np;
  args.col_blocks = col_blocks(width);

  // Carve the scratch: lhs_0..lhs_depth, z_0..z_{depth-1}, dv_0..dv_depth,
  // dh_0, then the partials. Every slice is a multiple of kRowTile floats,
  // so each stays 16-byte aligned.
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
  args.dh0 = p;
  p += rows * num_features;
  // 'bf16': the twins of lhs_l and dv_l (l < depth), then the weights' bf16
  // copies; each slice a multiple of 8 elements (16 bytes), as TMA needs.
  __nv_bfloat16* w_bf[kMaxLayers] = {};
  const int ldw = padded_width(width);
  if (bf16 && depth > 0) {
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(p);
    for (int l = 0; l < depth; ++l) {
      args.lhs_bf[l] = q;
      q += rows * (l == 0 ? num_features : width);
    }
    for (int l = 0; l < depth; ++l) {
      args.dv_bf[l] = q;
      q += rows * width;
    }
    for (int l = 0; l < depth; ++l) {
      w_bf[l] = q;
      q += (size_t)members * (l == 0 ? num_features : width) * ldw;
    }
    p = reinterpret_cast<float*>(q);
  }
  args.partials = p;
  p += (size_t)members * args.num_tiles * np;
  args.layer_partials = p;

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  // 'bf16': each hidden W_l's bf16 copy, and the tensor maps of the three
  // products' operands (the scratch does not move between chunks).
  TcMaps maps = {};
  if (bf16 && depth > 0) {
    if ((err = set_k1_tc_smem()) != cudaSuccess) return static_cast<int>(err);
    const int status = prepare_tc(args, w_bf, members, &maps, s);
    if (status != 0) return status;
  }
  for (int row0 = 0; row0 < n_rows; row0 += chunk_rows) {
    const int chunk = n_rows - row0 < chunk_rows ? n_rows - row0 : chunk_rows;
    const int tiles = (chunk + kRowTile - 1) / kRowTile;
    const int acc = row0 > 0;
    args.row0 = row0;
    args.tile0 = row0 / kRowTile;
    err = launch_chunk(args, likelihood, bf16, maps, tiles, members, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_weight_grads(args, bf16, maps, dweights, dbiases, members,
                              tiles * kRowTile, acc, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  FinalArgs fin = {};
  fin.partials = args.partials;
  fin.layer_partials = args.layer_partials;
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
  fin.col_blocks = args.col_blocks;
  finalize_kernel<<<members, 32, 0, s>>>(fin);
  return static_cast<int>(cudaGetLastError());
}

// The tensor-core GEMM core alone, for its check on the card: out (E, M, N)
// fp32 = A B over K for bf16 operands in the layout of one of K1's
// products (0 the forward, 1 W dv, 2 the weight gradient):
//   0: a (E, K, lda) holds A(m, k) at [k][m]; b (E, K, ldb) B(k, n) at [k][n]
//   1: a (E, M, lda) holds A(m, k) at [m][k]; b as for 0
//   2: a as for 1; b (E, N, ldb) holds B(k, n) at [n][k]
// lda and ldb are multiples of 8, a and b 16-byte aligned. Returns a
// cudaError_t, or kTensorMapError when a map cannot be made.
int bnf_tc_gemm(const void* a, const void* b, void* out, int layout,
                int members, int M, int N, int K, int lda, int ldb,
                void* stream) {
  if (layout < 0 || layout > 2 || members < 1 || members > 65535 || M < 1 ||
      N < 1 || K < 1 || (M + kTcTile - 1) / kTcTile > 65535 ||
      (N + kTcTile - 1) / kTcTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map_a, map_b;
  const bool a_ok =
      layout == 0
          ? encode_tc_map(&map_a, a, M, K, members, lda, (size_t)K * lda)
          : encode_tc_map(&map_a, a, K, M, members, lda, (size_t)M * lda);
  const bool b_ok =
      layout == 2
          ? encode_tc_map(&map_b, b, K, N, members, ldb, (size_t)N * ldb)
          : encode_tc_map(&map_b, b, N, K, members, ldb, (size_t)K * ldb);
  if (!a_ok || !b_ok) return kTensorMapError;
  cudaError_t err = set_k1_tc_smem();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kTcTile - 1) / kTcTile, (N + kTcTile - 1) / kTcTile,
                  members);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (layout == 0) {
    tc_gemm_kernel<kMNMajor, kMNMajor><<<grid, kTcThreads, kTcSmemBytes, s>>>(
        map_a, map_b, o, M, N, K);
  } else if (layout == 1) {
    tc_gemm_kernel<kKMajor, kMNMajor><<<grid, kTcThreads, kTcSmemBytes, s>>>(
        map_a, map_b, o, M, N, K);
  } else {
    tc_gemm_kernel<kKMajor, kKMajor><<<grid, kTcThreads, kTcSmemBytes, s>>>(
        map_a, map_b, o, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* bnf_cuda_error_string(int err) {
  if (err == kTensorMapError) {
    return "cuTensorMapEncodeTiled refused a tensor map, or libcuda has "
           "no such entry point";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
