// Backward of the fused ensemble field MLP for Hopper (sm_90a), row-major.
//
// Replaces the Pallas TPU kernel `_backward_kernel` (K4b, the custom VJP of
// `fused_field_mlp`, called by `_forward_bwd`) in
// bayesnf_tpu/ops/fused_mlp.py. (The features-major K3 runs layer-wise in
// `fused_mlp_t.cu`; the tile kernel keeps its layout parameter, instantiated
// row-major only.) For the forward of `fused_mlp_fwd.cu`,
//
//   z_l = s_l * (W_l^T lhs_l + b_l),  lhs_l = h_l / sqrt(fan_in_l),
//   h_{l+1} = act(z_l),  pred = s_out * v_out,  v_out = W_out^T lhs_depth + b_out
//
// and the cotangent g = d L / d pred (E, N), it returns, summed over rows,
//
//   dh0 (per row, (E, N, F)),
//   dW_l = sum lhs_l dv_l^T,  db_l = sum dv_l,  with dv_out = g s_out,
//   dh_l = W_l dv_l / sqrt(fan_in_l),  dz_l = dh_{l+1} act'(z_l),
//   dv_l = dz_l s_l,
//   dscales_raw[l] = sum(dz_l z_l) / s_l * sigmoid(raw_l),
//   dscales_raw[depth] = sum(g v_out) * sigmoid(raw_depth),
//   dlogit = sum over layers of dh act_w(z) * w (1 - w),
//
// in fp32 (FMA, no TF32, no fast-math intrinsics), as the TPU kernels do after
// recomputing the forward.
//
// Precision. Under 'bf16' a product takes bf16-rounded operands (nearest
// even), exact products and fp32 sums where the TPU kernel casts: unless the
// product's result has a last dimension of 1 (`_mm`). So the output layer's
// weight gradient stays fp32 (`rowdot_kernel`), as does its forward
// h @ W_out, and with one encoded feature the first layer's dv @ W_0^T. The
// C entry decides each site from the shapes, and passes the per-layer masks `round_in_mask`
// (layer l's forward input) and `round_dv_mask` (its W dv product) and the
// weight each product reads (a bf16 copy, made once per call, or the
// original). Each operand is rounded once, where it enters shared memory or
// a staged tile; scratch copies stay fp32.
//
// What bounds it: at 64 members x 4,096 rows, width 512, depth 2, F = 49 a
// call is 3 x 287,744 multiply-adds per row and member (the recomputed
// forward, the W dv products and the weight gradients' contraction over
// rows), 452.6 GFLOP, bound by the SIMT fp32 pipe (6.76 ms at 67 TFLOP/s).
//
// Design (that of K1, `fused_train.cu`). The TPU kernel keeps a member's
// weights and running weight gradients in VMEM across its sequential row
// tiles. A Hopper block has 227 KB of shared memory, one width-512 fp32 dW is
// 1 MiB, and blocks run in no order. So for each chunk of rows (sized so the
// scratch stays under a budget the wrapper sets):
//   1. `bwd_tile_kernel<TR, kRowMajor, kBf16>`, grid (row tiles, members).
//      A block loads its h0 tile, recomputes the forward with two ping-pong
//      buffers in shared memory, writing each layer's lhs_l and z_l to a
//      chunked global scratch, runs the chain from g with the same buffers
//      (dv_l to scratch, dh back into shared memory; the first layer's
//      F-output product as `narrow_matmul`), writes dh0 straight to its
//      output, and per-tile partials of the scalar sums (block reductions in
//      a fixed order).
//   2. `wgrad_kernel`: dW_l (+)= sum over the chunk's rows of lhs_l dv_l^T.
//   3. `rowdot_kernel`: db_l and dW_out (+)= row sums.
// Then `bwd_finalize_kernel` sums the partials in tile order and applies
// softplus' = sigmoid to dscales and w (1 - w) to dlogit. No float atomics,
// so results are bitwise reproducible. Rows past N are selected out: the
// tile reads h0 = 0 and g = 0 there and never stores them, and the
// cross-row kernels sum the chunk's valid rows only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "field_mlp.cuh"

namespace {

// Partial sums per (member, row tile): sum g * v_out, sum dh * d act / d w
// over every hidden layer, then sum dz_l * z_l for l < depth.
constexpr int kPartGV = 0;
constexpr int kPartLogit = 1;
constexpr int kPartDzz = 2;

struct BwdArgs {
  const float* h0;                 // (E, F, N) or (E, N, F)
  const float* g;                  // (E, N)
  const float* w_fwd[kMaxLayers];  // weight of layer l's forward product
  const float* w_bwd[kMaxLayers];  // and of its W dv product
  const float* b[kMaxLayers];      // (E, fan_out_l)
  const float* scales_raw;         // (E, depth + 1)
  const float* logit;              // (E,)
  float* dh0;                      // laid out as h0
  float* lhs[kMaxLayers];          // (E, fan_in_l, ld) chunk scratch
  float* z[kMaxLayers];            // (E, width, ld), l < depth
  float* dv[kMaxLayers];           // (E, fan_out_l, ld)
  float* partials;                 // (E, num_tiles, num_partials)
  float rsqrt[kMaxLayers];         // 1/sqrt(fan_in_l), rounded from double
  unsigned round_in_mask;          // bit l: layer l's input is rounded
  unsigned round_dv_mask;          // bit l: dv_l is rounded for W_l dv_l
  int depth;
  int num_features;
  int width;
  int n_rows;
  int row0;                        // first row of this chunk
  int ld;                          // scratch row stride (rows per chunk)
  int tile0;                       // global index of the chunk's first tile
  int num_tiles;                   // tiles over all N rows
  int num_partials;
};

template <int TR, bool kRowMajor, bool kBf16>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_tile_kernel(const BwdArgs args) {
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
  const int n = args.n_rows;
  const size_t ld = args.ld;
  const int num_w = depth + 1;
  const float* scales_raw = args.scales_raw + (size_t)e * num_w;
  const float wgt = sigmoid(args.logit[e]);
  float* partials =
      args.partials +
      ((size_t)e * args.num_tiles + args.tile0 + blockIdx.x) * args.num_partials;

  // --- h_0 / sqrt(F) into bufs[0], read in the layout's own order
  // (consecutive threads on consecutive addresses); rows past N are 0.
  {
    const float* h0 = args.h0 + (size_t)e * f * n;
    const float rs = args.rsqrt[0];
    for (int i = tid; i < f * TR; i += kThreads) {
      const int k = kRowMajor ? i % f : i / TR;
      const int r = kRowMajor ? i / f : i % TR;
      const int row = grow0 + r;
      const size_t at = kRowMajor ? (size_t)row * f + k : (size_t)k * n + row;
      bufs[0][k * LDH + r] = row < n ? h0[at] * rs : 0.f;
    }
  }
  __syncthreads();
  {
    float* lhs = args.lhs[0] + (size_t)e * f * ld + col0;
    const bool round = args.round_in_mask & 1u;
    for (int i = tid; i < f * TR; i += kThreads) {
      float* h = bufs[0] + (i / TR) * LDH + i % TR;
      lhs[(i / TR) * ld + i % TR] = *h;
      *h = maybe_round<kBf16>(*h, round);
    }
  }
  __syncthreads();

  // --- Forward; z_l and the next layer's input go to scratch.
  int fan_in = f;
  for (int l = 0; l < depth; ++l) {
    const float* w = args.w_fwd[l] + (size_t)e * fan_in * width;
    const float* b = args.b[l] + (size_t)e * width;
    const float s = softplus(scales_raw[l]);
    const float rs_next = args.rsqrt[l + 1];
    const bool round_next = (args.round_in_mask >> (l + 1)) & 1u;
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
      hout[j * LDH + r] = maybe_round<kBf16>(h, round_next);
    }
    __syncthreads();
    fan_in = width;
  }

  // --- Output layer (fixed-order reduction per row) and dv_out = g s_out.
  {
    constexpr int G = kThreads / TR;
    const float* w_out = args.w_fwd[depth] + (size_t)e * fan_in;
    const float* hin = bufs[depth & 1];
    const int r = tid % TR, q0 = tid / TR;
    float part = 0.f;
    for (int k = q0; k < fan_in; k += G) part = fmaf(hin[k * LDH + r], __ldg(w_out + k), part);
    w_tile[q0 * TR + r] = part;  // free: every warp passed the barrier above
    __syncthreads();
    if (tid < 32) {
      float gv = 0.f;
      if (tid < TR) {
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < G; ++q) acc += w_tile[q * TR + tid];
        const int row = grow0 + tid;
        const bool valid = row < n;
        const float v_out = acc + args.b[depth][e];
        const float s_out = softplus(scales_raw[depth]);
        const float gg = valid ? args.g[(size_t)e * n + row] : 0.f;
        const float dvo = gg * s_out;
        // Only the W_out dv_out product below reads the shared copy.
        dv_out[tid] = maybe_round<kBf16>(dvo, (args.round_dv_mask >> depth) & 1u);
        args.dv[depth][(size_t)e * ld + col0 + tid] = dvo;
        gv = valid ? gg * v_out : 0.f;
      }
      gv = warp_sum(gv);
      if (tid == 0) partials[kPartGV] = gv;
    }
  }
  __syncthreads();

  // --- Backward. dh_depth = W_out dv_out / sqrt(fan_in), into the buffer that
  // held the output layer's input (already in scratch for the dW sums).
  float* cur = bufs[depth & 1];
  {
    const float* w_out = args.w_bwd[depth] + (size_t)e * fan_in;
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
    const bool round = (args.round_dv_mask >> l) & 1u;
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
      cur[j * LDH + r] = maybe_round<kBf16>(dv, round);
      dvg[j * ld + r] = dv;
    }
    dzz = block_sum(dzz, red);
    if (tid == 0) partials[kPartDzz + l] = dzz;
    __syncthreads();

    // dh_l = W_l dv_l / sqrt(fan_in_l), W_l of shape (fan_in_l, width).
    const int fi = l == 0 ? f : width;
    const float* w = args.w_bwd[l] + (size_t)e * fi * width;
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

  // --- dh0 (cur, F x TR) straight to its output, rows < N only, in the
  // layout's own order.
  {
    float* dh0 = args.dh0 + (size_t)e * f * n;
    for (int i = tid; i < f * TR; i += kThreads) {
      const int k = kRowMajor ? i % f : i / TR;
      const int r = kRowMajor ? i / f : i % TR;
      const int row = grow0 + r;
      if (row < n) {
        dh0[kRowMajor ? (size_t)row * f + k : (size_t)k * n + row] =
            cur[k * LDH + r];
      }
    }
  }
}

struct FinalArgs {
  const float* partials;    // (E, num_tiles, num_partials)
  const float* scales_raw;  // (E, depth + 1)
  const float* logit;       // (E,)
  float* dscales;           // (E, depth + 1)
  float* dlogit;            // (E,)
  int depth;
  int num_tiles;
  int num_partials;
};

// One block of 32 threads per member: thread p sums partial p over the tiles
// in order; thread 0 then applies the scalar chain rules.
__global__ void bwd_finalize_kernel(const FinalArgs args) {
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
  const int depth = args.depth;
  const float* raw = args.scales_raw + (size_t)e * (depth + 1);
  float* dscales = args.dscales + (size_t)e * (depth + 1);
  for (int l = 0; l < depth; ++l) {
    dscales[l] = sums[kPartDzz + l] / softplus(raw[l]) * sigmoid(raw[l]);
  }
  dscales[depth] = sums[kPartGV] * sigmoid(raw[depth]);
  const float w = sigmoid(args.logit[e]);
  args.dlogit[e] = sums[kPartLogit] * w * (1.f - w);
}

// Scratch floats per chunk row and member: lhs_l (F + depth * width), z_l
// (depth * width), dv_l (depth * width + 1).
size_t floats_per_row(int num_features, int width, int depth) {
  return (size_t)num_features + 3 * (size_t)depth * width + 1;
}

template <int TR, bool kRowMajor, bool kBf16>
cudaError_t launch_tile(const BwdArgs& args, int tiles, int members,
                        size_t smem_bytes, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bwd_tile_kernel<TR, kRowMajor, kBf16>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  bwd_tile_kernel<TR, kRowMajor, kBf16>
      <<<dim3(tiles, members), kThreads, smem_bytes, stream>>>(args);
  return cudaGetLastError();
}

// The row-major tile kernel of this precision: TR {32, 16} x precision,
// four instantiations.
template <bool kBf16>
cudaError_t launch_tile_rows(const BwdArgs& args, int tile_rows, int tiles,
                             int members, size_t smem_bytes,
                             cudaStream_t stream) {
  switch (tile_rows) {
    case 32:
      return launch_tile<32, true, kBf16>(args, tiles, members, smem_bytes,
                                          stream);
    case 16:
      return launch_tile<16, true, kBf16>(args, tiles, members, smem_bytes,
                                          stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory of one `bwd_tile_kernel` block (bytes); the wrapper picks
// tile_rows with it.
size_t bnf_fused_mlp_bwd_smem_bytes(int tile_rows, int num_features,
                                    int width) {
  const int kmax = num_features > width ? num_features : width;
  return (2 * (size_t)kmax * (tile_rows + 4) + (size_t)kKTile * kLdw +
          tile_rows + kWarps) *
         sizeof(float);
}

// Global scratch (bytes) for chunks of `chunk_rows` rows over `n_rows` rows.
size_t bnf_fused_mlp_bwd_scratch_bytes(int members, int num_features,
                                       int width, int depth, int chunk_rows,
                                       int n_rows, int tile_rows) {
  const size_t tiles = (n_rows + tile_rows - 1) / tile_rows;
  return ((size_t)members * chunk_rows *
              floats_per_row(num_features, width, depth) +
          (size_t)members * tiles * (kPartDzz + depth)) *
         sizeof(float);
}

// The backward of the row-major fused MLP on `stream`, h0 and dh0
// (E, N, F); `precision` 0 fp32, 1 bf16. Pointers are device pointers to contiguous float32 tensors,
// except the host arrays `weights`, `biases`, `dweights`, `dbiases` and
// `weights16` (depth + 1 device pointers; `weights16`, buffers shaped like
// the weights that receive their bf16-rounded copies, is read only under
// bf16) and `rsqrts` (depth + 1 floats). `scratch` holds
// bnf_fused_mlp_bwd_scratch_bytes(...) bytes. Returns the first launch's
// cudaError_t that is not cudaSuccess, or 0.
int bnf_fused_mlp_bwd(const void* h0, const void* g,
                      const void* const* weights, const void* const* biases,
                      const void* scales_raw, const void* logit, void* dh0,
                      void* const* dweights, void* const* dbiases,
                      void* dscales, void* dlogit, void* scratch,
                      void* const* weights16, const float* rsqrts,
                      int precision, int depth, int members, int num_features,
                      int width, int n_rows, int tile_rows, int chunk_rows,
                      void* stream) {
  if (depth < 0 || depth + 1 > kMaxLayers || members < 1 || members > 65535 ||
      n_rows < 1 || num_features < 1 || chunk_rows < tile_rows ||
      chunk_rows % tile_rows != 0 || precision < 0 || precision > 1 ||
      (precision == 1 && weights16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool bf16 = precision == 1;
  if (depth == 0) width = num_features;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  BwdArgs args = {};
  args.h0 = static_cast<const float*>(h0);
  args.g = static_cast<const float*>(g);
  for (int l = 0; l <= depth; ++l) {
    const int fan_in = l == 0 ? num_features : width;
    const int fan_out = l == depth ? 1 : width;
    args.w_fwd[l] = args.w_bwd[l] = static_cast<const float*>(weights[l]);
    args.b[l] = static_cast<const float*>(biases[l]);
    args.rsqrt[l] = rsqrts[l];
    const bool round_fwd = bf16 && rounds_forward(true, fan_out);
    const bool round_dv = bf16 && rounds_dh(true, fan_in);
    if (round_fwd || round_dv) {
      float* copy = static_cast<float*>(weights16[l]);
      const cudaError_t err = launch_round_bf16(
          args.w_fwd[l], copy, (size_t)members * fan_in * fan_out, s);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (round_fwd) args.w_fwd[l] = copy;
      if (round_dv) args.w_bwd[l] = copy;
    }
    args.round_in_mask |= (unsigned)round_fwd << l;
    args.round_dv_mask |= (unsigned)round_dv << l;
  }
  args.scales_raw = static_cast<const float*>(scales_raw);
  args.logit = static_cast<const float*>(logit);
  args.dh0 = static_cast<float*>(dh0);
  args.depth = depth;
  args.num_features = num_features;
  args.width = width;
  args.n_rows = n_rows;
  args.ld = chunk_rows;
  args.num_tiles = (n_rows + tile_rows - 1) / tile_rows;
  args.num_partials = kPartDzz + depth;

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

  const size_t smem =
      bnf_fused_mlp_bwd_smem_bytes(tile_rows, num_features, width);
  // The hidden weight gradients round their operands under bf16 (their
  // result's last dimension is the width).
  const bool round_wgrad = bf16 && width > 1;
  cudaError_t err;
  for (int row0 = 0; row0 < n_rows; row0 += chunk_rows) {
    // The chunk's valid rows: the cross-row sums read no row past N.
    const int len = n_rows - row0 < chunk_rows ? n_rows - row0 : chunk_rows;
    const int tiles = (len + tile_rows - 1) / tile_rows;
    const int acc = row0 > 0;
    args.row0 = row0;
    args.tile0 = row0 / tile_rows;
    err = bf16 ? launch_tile_rows<true>(args, tile_rows, tiles, members,
                                        smem, s)
               : launch_tile_rows<false>(args, tile_rows, tiles, members,
                                         smem, s);
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
  fin.scales_raw = args.scales_raw;
  fin.logit = args.logit;
  fin.dscales = static_cast<float*>(dscales);
  fin.dlogit = static_cast<float*>(dlogit);
  fin.depth = depth;
  fin.num_tiles = args.num_tiles;
  fin.num_partials = args.num_partials;
  bwd_finalize_kernel<<<members, 32, 0, s>>>(fin);
  return static_cast<int>(cudaGetLastError());
}

const char* bnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
