// The field MLP for Hopper (sm_90a), in either layout of h0: its forward
// (K2 features-major, K4a row-major) and its backward (K3, K4b), layer by
// layer on the GEMMs of K1.
//
// Replaces the Pallas TPU kernels of bayesnf_tpu/ops/fused_mlp.py
// `_forward_kernel_t` (K2, reached through `fused_field_mlp_t` /
// `_forward_t`), `_backward_kernel_t` (K3, its custom VJP, called by
// `_forward_t_bwd`), `_forward_kernel` (K4a, reached through
// `fused_field_mlp` / `_forward`) and `_backward_kernel` (K4b, called by
// `_forward_bwd`). Per ensemble member e and row n, from h0 (E, F, N)
// features-major or (E, N, F) row-major:
//
//   lhs_0 = h_0 / sqrt(F)
//   z_l = s_l * (W_l^T lhs_l + b_l),  lhs_{l+1} = act(z_l) / sqrt(width)
//   pred = s_out * v_out,  v_out = W_out^T lhs_depth + b_out
//
// with s = softplus(scales_raw), act(z) = w*elu(z) + (1-w)*tanh(z) and
// w = sigmoid(logit); and for the cotangent g = d L / d pred (E, N),
//
//   dh0 (laid out as h0),  dW_l = sum lhs_l dv_l^T,  db_l = sum dv_l,
//   dv_out = g s_out,  dh_l = W_l dv_l / sqrt(fan_in_l),
//   dz_l = dh_{l+1} act'(z_l),  dv_l = dz_l s_l,
//   dscales_raw[l] = sum(dz_l z_l) / s_l * sigmoid(raw_l),
//   dscales_raw[depth] = sum(g v_out) * sigmoid(raw_depth),
//   dlogit = sum over layers of dh act_w(z) * w (1 - w),
//
// in fp32 (FMA, no TF32, no fast-math intrinsics).
//
// What bounds it: at 64 members x 4,096 rows, width 512, depth 2, F = 49 the
// forward is 150.9 GFLOP and the backward 452.6 (the recomputed forward, the
// W dv products and the weight gradients' contraction over rows), bound by
// the SIMT fp32 pipe under 'f32' (2.25 and 6.76 ms at 67 TFLOP/s); under
// 'bf16' the tensor cores make the products a few hundred microseconds and
// the fp32 scratch the epilogues read and write bounds the call.
//
// Design: K1's (`fused_train.cu`). A Hopper block has 227 KB of shared
// memory and one width-512 fp32 weight is 1 MiB, so a block that carries a
// few rows through every layer re-streams each weight for those rows. So
// each product of a chunk of rows (whole 128-row tiles, sized by the wrapper
// under a scratch budget) is one GEMM over all of the chunk's rows, with the
// elementwise work in its epilogue: the layer kernels of
// `field_layers.cuh`, on the SIMT engine (`simt_gemm.cuh`) under 'f32' and
// on the tensor cores (`wgmma_gemm.cuh`: TMA, mbarrier stages, wgmma) under
// 'bf16'. The activations live features-major in the scratch (E, F, ld)
// whatever h0's layout, so both layouts run the same GEMMs on the same
// chunk plan; the layout shows only where h0 is read and dh0 written.
// Per chunk, the forward:
//   1. `prescale_kernel`, a thread per (row, member): lhs_0 = h0 / sqrt(F)
//      into the scratch, zero past N (the GEMMs read whole, 16-byte aligned
//      tiles; the caller's N is ragged), and its bf16 twin. Row-major it
//      reads each row's F contiguous floats and transposes them as it
//      writes;
//   2. `forward_kernel<false>` per hidden layer (no z), its lhs_{l+1} in two
//      ping-pong buffers;
//   3. `output_kernel`, a thread per (row, member): pred for rows below N,
//      in K1's fixed order (`head_v_out`).
// The backward, per chunk: the prescale; the forward with z
// (`forward_kernel<true>`); `grad_head_kernel` (dv_out = g s_out, the
// tile's sum of g v_out, the last hidden layer's dv, or at depth 0 dh_0);
// the W dv chain down to the F-output product, whose epilogue writes dh0
// into the caller's (E, F, N) or (E, N, F) for rows below N
// (`backward_kernel<true, kDh0Features or kDh0Rows>`); then the weight
// gradients and row sums (`wgrad_kernel` or `tc_wgrad_kernel`,
// `rowdot_kernel`), added chunk after chunk. Once at the end
// `grad_finalize_kernel` sums the per-tile and per-column-block partials in
// a fixed order. No atomics: two identical calls are bit-equal. Rows past N
// read h0 = 0 and g = 0, so they add exactly zero to every sum.
//
// Precision. Under 'bf16' a product takes bf16 operands, exact products and
// fp32 sums where the TPU kernels cast (`rounds_forward`, `rounds_dh`):
// features-major every product but the output layer's weight gradient;
// row-major also not a product whose result has one column (the output
// layer's forward; at width 1 every hidden forward and the W dv products
// of layers >= 1; with F = 1 the first layer's W dv product). A hidden
// weight gradient of one column stays fp32 in `rowdot_kernel`, as the
// output layer's does. The hidden products that round read bf16 copies of
// the weights and bf16 twins of lhs_l and dv_l; the output layer rounds
// its operands in registers. A refused tensor map is an error the wrapper
// raises on: no SIMT fallback.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "field_layers.cuh"

namespace {

// The output layer's v_out = W_out^T lhs_depth + b_out for the chunk's row
// `col`, in the order of K1's head (`head_kernel` in `fused_train.cu`):
// kHeadLanes strided FMA chains over the inputs, then the chains in order;
// under kRound both operands rounded in registers.
template <bool kRound>
__device__ __forceinline__ float head_v_out(const FieldArgs& args, int e,
                                            int col) {
  const int depth = args.depth;
  const int fan_in = depth ? args.width : args.num_features;
  const size_t ld = args.ld;
  const float* w_out = args.w[depth] + (size_t)e * fan_in;
  auto wo = [&](int k) { return maybe_round<kRound>(__ldg(w_out + k), true); };
  const float* hin = args.lhs[depth] + (size_t)e * fan_in * ld + col;
  float part[kHeadLanes];
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) part[q] = 0.f;
  int k = 0;
  for (; k + kHeadLanes <= fan_in; k += kHeadLanes) {
#pragma unroll
    for (int q = 0; q < kHeadLanes; ++q) {
      part[q] = fmaf(maybe_round<kRound>(hin[(k + q) * ld], true), wo(k + q),
                     part[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) {
    if (k + q < fan_in) {
      part[q] = fmaf(maybe_round<kRound>(hin[(k + q) * ld], true), wo(k + q),
                     part[q]);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < kHeadLanes; ++q) acc += part[q];
  return acc + args.b[depth][e];
}

// The last hidden layer's cotangent for the chunk's row `col` from the
// output layer's dv_out (`dvo_r`, rounded where W_out dv_out reads it;
// `round`: W_out rounded too), as
// K1's head computes it after its likelihood:
// dh = W_out dv_out / sqrt(width), dv = dh act'(z) s (and its twin under
// kBf16), with each column block's sums of dz z and dh dact/dw into the
// layer partials of row tile `tile`. Every thread of the row tile calls it;
// `red` holds 2 * kRowWarps floats and `sums` 2.
template <bool kBf16>
__device__ __forceinline__ void last_hidden_dv(const FieldArgs& args, int e,
                                               int col, int tile, float dvo_r,
                                               bool round, float* red,
                                               float* sums) {
  const int depth = args.depth;
  const int fan_in = args.width;
  const size_t ld = args.ld;
  const float* w_out = args.w[depth] + (size_t)e * fan_in;
  auto wo = [&](int k) { return maybe_round<kBf16>(__ldg(w_out + k), round); };
  const float rs = args.rsqrt[depth];
  const float wgt = sigmoid(args.logit[e]);
  const int l = depth - 1;
  const float s = softplus(args.scales_raw[(size_t)e * (depth + 1) + l]);
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
    if (threadIdx.x == 0) {
      lp[cb * 2] = sums[0];
      lp[cb * 2 + 1] = sums[1];
    }
  }
}

// --- 1. lhs_0 = h0 / sqrt(F) for the chunk's rows, zero past N, and under
// kBf16 its twin (when a hidden layer reads it); h0 (E, F, N), or with
// kRowMajor (E, N, F). Grid (row tiles of the chunk, members).
template <bool kBf16, bool kRowMajor>
__global__ void __launch_bounds__(kRowTile)
    prescale_kernel(const FieldArgs args, const float* __restrict__ h0) {
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + threadIdx.x;
  const int row = args.row0 + col;
  const bool valid = row < args.n_valid;
  const int f = args.num_features;
  const size_t n = args.n_rows;
  const float* src = kRowMajor ? h0 + ((size_t)e * n + row) * f
                               : h0 + (size_t)e * f * n + row;
  const size_t stride = kRowMajor ? 1 : n;
  const size_t off = (size_t)e * f * args.ld + col;
  float* dst = args.lhs[0] + off;
  __nv_bfloat16* dst_bf =
      kBf16 && args.depth > 0 ? args.lhs_bf[0] + off : nullptr;
  const float rs = args.rsqrt[0];
  for (int k = 0; k < f; ++k) {
    // Scaled, then rounded (where the tile kernel rounded its input).
    const float v = valid ? __ldg(src + k * stride) * rs : 0.f;
    dst[(size_t)k * args.ld] = v;
    if (dst_bf != nullptr) dst_bf[(size_t)k * args.ld] = __float2bfloat16_rn(v);
  }
}

// --- 3. The forward's output layer: pred = s_out v_out for the chunk's rows
// below N, kRound where its product rounds; grid (row tiles of the chunk,
// members).
template <bool kRound>
__global__ void __launch_bounds__(kRowTile)
    output_kernel(const FieldArgs args, float* __restrict__ out) {
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + threadIdx.x;
  const int row = args.row0 + col;
  if (row >= args.n_valid) return;
  const float v_out = head_v_out<kRound>(args, e, col);
  const float s_out =
      softplus(args.scales_raw[(size_t)e * (args.depth + 1) + args.depth]);
  out[(size_t)e * args.n_rows + row] = s_out * v_out;
}

// --- The backward's head: dv_out = g s_out, the row tile's sum of g v_out
// into `partials` (E, num_tiles), and the last hidden layer's dv (at depth
// 0, dh0 = W_out dv_out / sqrt(F) into the caller's output, laid out as h0,
// rows below N); grid (row tiles of the chunk, members).
template <bool kBf16, bool kRowMajor>
__global__ void __launch_bounds__(kRowTile)
    grad_head_kernel(const FieldArgs args, const float* __restrict__ g,
                     float* __restrict__ partials) {
  __shared__ float red[2 * kRowWarps];
  __shared__ float sums[2];
  const int e = blockIdx.y;
  const int col = blockIdx.x * kRowTile + threadIdx.x;
  const int row = args.row0 + col;
  const int tile = args.tile0 + blockIdx.x;
  const bool valid = row < args.n_valid;
  const int depth = args.depth;
  const float v_out =
      head_v_out<kBf16 && rounds_forward(kRowMajor, 1)>(args, e, col);
  const float s_out =
      softplus(args.scales_raw[(size_t)e * (depth + 1) + depth]);
  const float gg = valid ? __ldg(g + (size_t)e * args.n_rows + row) : 0.f;
  const float dvo = gg * s_out;
  args.dv[depth][(size_t)e * args.ld + col] = dvo;
  const float gv = valid ? gg * v_out : 0.f;
  tile_sums(&gv, 1, red, sums);
  if (threadIdx.x == 0) partials[(size_t)e * args.num_tiles + tile] = sums[0];
  // dh_depth = W_out dv_out / sqrt(fan_in), dv_out rounded for the product
  // where it rounds.
  const bool round =
      rounds_dh(kRowMajor, depth ? args.width : args.num_features);
  const float dvo_r = maybe_round<kBf16>(dvo, round);
  if (depth == 0) {
    if (!valid) return;
    const int f = args.num_features;
    const size_t n = args.n_rows;
    const float rs = args.rsqrt[0];
    const float* w_out = args.w[0] + (size_t)e * f;
    float* dh0 = kRowMajor ? args.dh0 + ((size_t)e * n + row) * f
                           : args.dh0 + (size_t)e * f * n + row;
    const size_t stride = kRowMajor ? 1 : n;
    for (int c = 0; c < f; ++c) {
      dh0[c * stride] =
          (maybe_round<kBf16>(__ldg(w_out + c), round) * dvo_r) * rs;
    }
    return;
  }
  last_hidden_dv<kBf16>(args, e, col, tile, dvo_r, round, red, sums);
}

struct FinalArgs {
  const float* partials;        // (E, num_tiles): sum g v_out
  const float* layer_partials;  // (E, num_tiles, depth, col_blocks, 2)
  const float* scales_raw;      // (E, depth + 1)
  const float* logit;           // (E,)
  float* dscales;               // (E, depth + 1)
  float* dlogit;                // (E,)
  int depth;
  int num_tiles;
  int col_blocks;
};

// --- The backward, once: one block of 32 threads per member. Thread 0
// sums g v_out over the tiles in order, thread 1 + l layer l's two sums
// over the tiles and their column blocks in order; thread 0 then applies
// the scalar chain rules.
__global__ void grad_finalize_kernel(const FinalArgs args) {
  __shared__ float gv;
  __shared__ float dzz[kMaxLayers];
  __shared__ float dlg[kMaxLayers];
  const int e = blockIdx.x, p = threadIdx.x;
  const int depth = args.depth;
  if (p == 0) {
    const float* src = args.partials + (size_t)e * args.num_tiles;
    float acc = 0.f;
    for (int t = 0; t < args.num_tiles; ++t) acc += src[t];
    gv = acc;
  }
  if (p >= 1 && p <= depth) {
    const int l = p - 1, cbs = args.col_blocks;
    float a = 0.f, b = 0.f;
    for (int t = 0; t < args.num_tiles; ++t) {
      const float* lp = args.layer_partials +
                        (((size_t)e * args.num_tiles + t) * depth + l) * cbs * 2;
      for (int cb = 0; cb < cbs; ++cb) {
        a += lp[cb * 2];
        b += lp[cb * 2 + 1];
      }
    }
    dzz[l] = a;
    dlg[l] = b;
  }
  __syncthreads();
  if (p != 0) return;
  const float* raw = args.scales_raw + (size_t)e * (depth + 1);
  float* dscales = args.dscales + (size_t)e * (depth + 1);
  float logit_sum = 0.f;
  for (int l = 0; l < depth; ++l) {
    dscales[l] = dzz[l] / softplus(raw[l]) * sigmoid(raw[l]);
    logit_sum += dlg[l];
  }
  dscales[depth] = gv * sigmoid(raw[depth]);
  const float w = sigmoid(args.logit[e]);
  args.dlogit[e] = logit_sum * w * (1.f - w);
}

// Scratch per chunk row and member, in floats and in bf16 twins. The
// forward: lhs_0 (F) and two ping-pong lhs buffers (width each, one at
// depth 1); its twins lhs_0's and up to two of the hidden layers'. The
// backward: lhs_l (F + depth * width), z_l (depth * width), dv_l
// (depth * width + 1); twins of lhs_l and dv_l for l < depth.
size_t floats_per_row(int num_features, int width, int depth, bool backward) {
  if (backward) return num_features + 3 * (size_t)depth * width + 1;
  return num_features + (size_t)(depth < 2 ? depth : 2) * width;
}
size_t twins_per_row(int num_features, int width, int depth, bool backward) {
  if (depth == 0) return 0;
  if (backward) return num_features + (2 * (size_t)depth - 1) * width;
  return num_features + (size_t)(depth - 1 < 2 ? depth - 1 : 2) * width;
}

// Carves `scratch` for chunks of `chunk_rows` rows: the fp32 buffers, then
// under bf16 the twins and the weights' copies (w_bf), then (backward) the
// partials. Every slice is a multiple of 8 elements (16 bytes), as TMA and
// the 16-byte copies need. Returns the (E, num_tiles) partials.
float* carve(FieldArgs* a, void* scratch, int members, bool bf16,
             bool backward, __nv_bfloat16** w_bf) {
  const int depth = a->depth, width = a->width, f = a->num_features;
  const size_t rows = (size_t)members * a->ld;
  float* p = static_cast<float*>(scratch);
  a->lhs[0] = p;
  p += rows * f;
  if (backward) {
    for (int l = 1; l <= depth; ++l, p += rows * width) a->lhs[l] = p;
    for (int l = 0; l < depth; ++l, p += rows * width) a->z[l] = p;
    for (int l = 0; l <= depth; ++l) {
      a->dv[l] = p;
      p += rows * (l == depth ? 1 : width);
    }
  } else {
    float* ping = p;
    float* pong = depth > 1 ? p + rows * width : p;
    for (int l = 1; l <= depth; ++l) a->lhs[l] = l % 2 ? ping : pong;
    p += rows * width * (depth < 2 ? depth : 2);
  }
  if (bf16 && depth > 0) {
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(p);
    a->lhs_bf[0] = q;
    q += rows * f;
    if (backward) {
      for (int l = 1; l < depth; ++l, q += rows * width) a->lhs_bf[l] = q;
      for (int l = 0; l < depth; ++l, q += rows * width) a->dv_bf[l] = q;
    } else {
      __nv_bfloat16* ping = q;
      __nv_bfloat16* pong = depth > 2 ? q + rows * width : q;
      for (int l = 1; l < depth; ++l) a->lhs_bf[l] = l % 2 ? ping : pong;
      q += rows * width * (depth - 1 < 2 ? depth - 1 : 2);
    }
    const int ldw = padded_width(width);
    for (int l = 0; l < depth; ++l) {
      w_bf[l] = q;
      q += (size_t)members * (l == 0 ? f : width) * ldw;
    }
    p = reinterpret_cast<float*>(q);
  }
  float* partials = p;
  a->layer_partials = p + (size_t)members * a->num_tiles;
  return partials;
}

// The call's common arguments (see the C entries).
FieldArgs field_args(const void* const* weights, const void* const* biases,
                     const void* scales_raw, const void* logit,
                     const float* rsqrts, int depth, int num_features,
                     int width, int n_rows, int chunk_rows) {
  FieldArgs a = {};
  for (int l = 0; l <= depth; ++l) {
    a.w[l] = static_cast<const float*>(weights[l]);
    a.b[l] = static_cast<const float*>(biases[l]);
    a.w_vec[l] =
        width % 4 == 0 && reinterpret_cast<uintptr_t>(weights[l]) % 16 == 0;
    a.rsqrt[l] = rsqrts[l];
  }
  a.scales_raw = static_cast<const float*>(scales_raw);
  a.logit = static_cast<const float*>(logit);
  a.depth = depth;
  a.num_features = num_features;
  a.width = width;
  a.n_rows = n_rows;
  a.n_valid = n_rows;
  a.ld = chunk_rows;
  a.num_tiles = (n_rows + kRowTile - 1) / kRowTile;
  a.col_blocks = col_blocks(width);
  return a;
}

bool bad_call(int layout, int depth, int members, int num_features,
              int width, int n_rows, int precision, int chunk_rows,
              const void* scratch) {
  return layout < 0 || layout > 1 || depth < 0 || depth + 1 > kMaxLayers ||
         members < 1 || members > 65535 || n_rows < 1 || num_features < 1 ||
         width < 1 || precision < 0 || precision > 1 ||
         chunk_rows < kRowTile || chunk_rows % kRowTile != 0 ||
         chunk_rows / kRowTile > 65535 ||
         reinterpret_cast<uintptr_t>(scratch) % 16 != 0;
}

cudaError_t set_fwd_tc_smem() { return set_tc_smem(tc_forward_kernel<false>); }

cudaError_t set_bwd_tc_smem() {
  cudaError_t err;
  if ((err = set_tc_smem(tc_forward_kernel<true>)) ||
      (err = set_tc_smem(tc_backward_kernel<false>)) ||
      (err = set_tc_smem(tc_backward_kernel<true, kDh0Features>)) ||
      (err = set_tc_smem(tc_backward_kernel<true, kDh0Rows>)) ||
      (err = set_tc_smem(tc_wgrad_kernel))) {
    return err;
  }
  return cudaSuccess;
}

// The forward's chunks (K2 features-major, K4a with kRowMajor), after the
// call's set-up: the prescale, the hidden forwards and the output layer.
template <bool kRowMajor>
cudaError_t forward_chunks(FieldArgs args, bool bf16, const TcMaps& maps,
                           const float* h0, float* pred, int members,
                           cudaStream_t s) {
  cudaError_t err;
  for (int row0 = 0; row0 < args.n_rows; row0 += args.ld) {
    const int chunk =
        args.n_rows - row0 < args.ld ? args.n_rows - row0 : args.ld;
    const int tiles = (chunk + kRowTile - 1) / kRowTile;
    const dim3 rows(tiles, members);
    args.row0 = row0;
    args.tile0 = row0 / kRowTile;
    if (bf16) {
      prescale_kernel<true, kRowMajor><<<rows, kRowTile, 0, s>>>(args, h0);
    } else {
      prescale_kernel<false, kRowMajor><<<rows, kRowTile, 0, s>>>(args, h0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_forward_layers<false, kRowMajor>(args, bf16, maps, tiles,
                                                  members, s);
    if (err != cudaSuccess) return err;
    if (bf16 && rounds_forward(kRowMajor, 1)) {
      output_kernel<true><<<rows, kRowTile, 0, s>>>(args, pred);
    } else {
      output_kernel<false><<<rows, kRowTile, 0, s>>>(args, pred);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The backward's chunks (K3 features-major, K4b with kRowMajor), after the
// call's set-up: the prescale, the forward with z, the head, the W dv chain
// down to dh0 and the cross-row sums.
template <bool kRowMajor>
cudaError_t backward_chunks(FieldArgs args, bool bf16, const TcMaps& maps,
                            const float* h0, const float* g, float* partials,
                            void* const* dweights, void* const* dbiases,
                            int members, cudaStream_t s) {
  constexpr int kDh0 = kRowMajor ? kDh0Rows : kDh0Features;
  cudaError_t err;
  for (int row0 = 0; row0 < args.n_rows; row0 += args.ld) {
    const int chunk =
        args.n_rows - row0 < args.ld ? args.n_rows - row0 : args.ld;
    const int tiles = (chunk + kRowTile - 1) / kRowTile;
    const dim3 rows(tiles, members);
    args.row0 = row0;
    args.tile0 = row0 / kRowTile;
    if (bf16) {
      prescale_kernel<true, kRowMajor><<<rows, kRowTile, 0, s>>>(args, h0);
    } else {
      prescale_kernel<false, kRowMajor><<<rows, kRowTile, 0, s>>>(args, h0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_forward_layers<true, kRowMajor>(args, bf16, maps, tiles,
                                                 members, s);
    if (err != cudaSuccess) return err;
    if (bf16) {
      grad_head_kernel<true, kRowMajor>
          <<<rows, kRowTile, 0, s>>>(args, g, partials);
    } else {
      grad_head_kernel<false, kRowMajor>
          <<<rows, kRowTile, 0, s>>>(args, g, partials);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = launch_wdv_chain<kDh0, kRowMajor>(args, bf16, maps, tiles, members,
                                            s);
    if (err != cudaSuccess) return err;
    err = launch_weight_grads(args, bf16, maps, dweights, dbiases, members,
                              tiles * kRowTile, row0 > 0, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Global scratch (bytes) of one call: chunks of `chunk_rows` rows over
// `n_rows` rows at `precision` (0 fp32; 1 bf16 adds the twins and the
// weights' copies), for the forward (`backward` 0, K2 and K4a) or the
// backward (1, K3 and K4b, with its partials). The same in both layouts;
// the wrapper sizes its chunks with it.
size_t bnf_fused_mlp_t_scratch_bytes(int members, int num_features, int width,
                                     int depth, int chunk_rows, int n_rows,
                                     int precision, int backward) {
  if (depth == 0) width = num_features;
  const size_t tiles = (n_rows + kRowTile - 1) / kRowTile;
  const size_t partials =
      backward ? tiles * (1 + 2 * (size_t)depth * col_blocks(width)) : 0;
  const size_t bf16_elems =
      precision == 1
          ? (size_t)chunk_rows *
                    twins_per_row(num_features, width, depth, backward) +
                weight_copies(num_features, width, depth)
          : 0;
  return (size_t)members *
         (((size_t)chunk_rows *
               floats_per_row(num_features, width, depth, backward) +
           partials) *
              sizeof(float) +
          bf16_elems * sizeof(__nv_bfloat16));
}

// K2 (`layout` 0: h0 (E, F, N)) or K4a (`layout` 1: h0 (E, N, F)): out
// (E, N) = the field MLP of h0 at `precision` (0 fp32, 1 bf16) on `stream`.
// Pointers are device pointers to contiguous float32 tensors, except the
// host arrays `weights` and `biases` (depth + 1 device pointers) and
// `rsqrts` (depth + 1 floats). `scratch` holds
// bnf_fused_mlp_t_scratch_bytes(..., 0) bytes and is 16-byte aligned;
// `chunk_rows` is a positive multiple of 128, at most 65,535 tiles. Returns
// the first launch's cudaError_t that is not cudaSuccess, 2000 for a tensor
// map libcuda refused, or 0.
int bnf_fused_mlp_t_fwd(const void* h0, const void* const* weights,
                        const void* const* biases, const void* scales_raw,
                        const void* logit, void* out, void* scratch,
                        const float* rsqrts, int layout, int precision,
                        int depth, int members, int num_features, int width,
                        int n_rows, int chunk_rows, void* stream) {
  if (bad_call(layout, depth, members, num_features, width, n_rows, precision,
               chunk_rows, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = precision == 1;
  if (depth == 0) width = num_features;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FieldArgs args = field_args(weights, biases, scales_raw, logit, rsqrts,
                              depth, num_features, width, n_rows, chunk_rows);
  __nv_bfloat16* w_bf[kMaxLayers] = {};
  carve(&args, scratch, members, bf16, false, w_bf);
  cudaError_t err;
  TcMaps maps = {};
  if (bf16 && depth > 0) {
    if ((err = set_fwd_tc_smem()) != cudaSuccess) return static_cast<int>(err);
    const int status = prepare_tc(args, w_bf, members, &maps, s);
    if (status != 0) return status;
  }
  const float* x = static_cast<const float*>(h0);
  float* pred = static_cast<float*>(out);
  err = layout ? forward_chunks<true>(args, bf16, maps, x, pred, members, s)
               : forward_chunks<false>(args, bf16, maps, x, pred, members, s);
  return static_cast<int>(err);
}

// K3 (`layout` 0) or K4b (1): the backward of K2 or K4a for the cotangent g
// (E, N): dh0 laid out as h0 and the gradients of every weight, bias,
// scales_raw and logit, at `precision` on `stream`. Pointers as for the
// forward; `dweights` and `dbiases` are host arrays of depth + 1 device
// pointers. `scratch` holds bnf_fused_mlp_t_scratch_bytes(..., 1) bytes.
// Returns as the forward.
int bnf_fused_mlp_t_bwd(const void* h0, const void* g,
                        const void* const* weights, const void* const* biases,
                        const void* scales_raw, const void* logit, void* dh0,
                        void* const* dweights, void* const* dbiases,
                        void* dscales, void* dlogit, void* scratch,
                        const float* rsqrts, int layout, int precision,
                        int depth, int members, int num_features, int width,
                        int n_rows, int chunk_rows, void* stream) {
  if (bad_call(layout, depth, members, num_features, width, n_rows, precision,
               chunk_rows, scratch)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = precision == 1;
  if (depth == 0) width = num_features;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  FieldArgs args = field_args(weights, biases, scales_raw, logit, rsqrts,
                              depth, num_features, width, n_rows, chunk_rows);
  args.dh0 = static_cast<float*>(dh0);
  __nv_bfloat16* w_bf[kMaxLayers] = {};
  float* partials = carve(&args, scratch, members, bf16, true, w_bf);
  cudaError_t err;
  TcMaps maps = {};
  if (bf16 && depth > 0) {
    if ((err = set_bwd_tc_smem()) != cudaSuccess) return static_cast<int>(err);
    const int status = prepare_tc(args, w_bf, members, &maps, s);
    if (status != 0) return status;
  }
  const float* x = static_cast<const float*>(h0);
  const float* gg = static_cast<const float*>(g);
  err = layout ? backward_chunks<true>(args, bf16, maps, x, gg, partials,
                                       dweights, dbiases, members, s)
               : backward_chunks<false>(args, bf16, maps, x, gg, partials,
                                        dweights, dbiases, members, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  FinalArgs fin = {};
  fin.partials = partials;
  fin.layer_partials = args.layer_partials;
  fin.scales_raw = args.scales_raw;
  fin.logit = args.logit;
  fin.dscales = static_cast<float*>(dscales);
  fin.dlogit = static_cast<float*>(dlogit);
  fin.depth = depth;
  fin.num_tiles = args.num_tiles;
  fin.col_blocks = args.col_blocks;
  grad_finalize_kernel<<<members, 32, 0, s>>>(fin);
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
