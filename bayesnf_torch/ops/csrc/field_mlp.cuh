// Shared building blocks of the port's field-MLP kernels for Hopper (sm_90a):
// the block layout (256 threads, TR-row tiles, features-major activations in
// shared memory), the field's scalar functions, the block matmul of
// activations in shared memory against a weight in global memory, the
// narrow W dv product, and the cross-row kernels of the backward (weight
// gradients, row sums, bf16 weight copies). `fused_mlp_fwd.cu` (K4a),
// `fused_mlp_bwd.cu` (K4b) and, through `field_layers.cuh`,
// `fused_train.cu` (K1) and `fused_mlp_t.cu` (K2, K3) build on them;
// every reduction has a fixed order and none uses atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroups = 4;                        // threads along rows
constexpr int kColGroups = kThreads / kRowGroups;    // 64 along columns
constexpr int kColsPerPass = 8 * kColGroups;         // 512 output columns
constexpr int kKTile = 8;                            // reduction rows per stage
constexpr int kLdw = kColsPerPass + 4;               // staged-tile row stride
constexpr int kPrefetch = kKTile * kColsPerPass / kThreads;  // 16 per thread
constexpr int kMaxLayers = 9;                        // depth <= 8, + output
constexpr int kWarps = kThreads / 32;
// W dv products with at most this many outputs per row use narrow_matmul.
constexpr int kNarrowRows = 128;

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: logaddexp(x, 0).
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// x rounded to bf16 (nearest even) and widened back to fp32, exactly.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x, rounded to bf16 when kBf16 and `round` hold.
template <bool kBf16>
__device__ __forceinline__ float maybe_round(float x, bool round) {
  if constexpr (kBf16) return round ? round_bf16(x) : x;
  return x;
}

__device__ __forceinline__ float blended_act(float z, float w) {
  const float q = expf(fminf(z, 0.f));
  const float elu = z > 0.f ? z : q - 1.f;
  return w * elu + (1.f - w) * tanhf(z);
}

// d act / d z and d act / d w, with the TPU kernel's `_act_grad` formulas.
__device__ __forceinline__ void blended_act_grad(float z, float w, float* dz,
                                                 float* dw) {
  const float q = expf(fminf(z, 0.f));
  const float t = tanhf(z);
  const float elu = z > 0.f ? z : q - 1.f;
  const float delu = z > 0.f ? 1.f : q;
  *dz = w * delu + (1.f - w) * (1.f - t * t);
  *dw = elu - t;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum of `v` over the block in a fixed order; the total is valid on thread 0.
// Every thread must call it.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();  // `red` is free
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kWarps; ++i) total += red[i];
  }
  return total;
}

// Block matmul on activations held features-major in shared memory:
//   out(c, r) = sum_k A(k, c) * in[k * LDH + r],  c < n_out, k < n_red,
// with A(k, c) = a[k * lda + c] when kTrans is false (a weight W read as
// W[k][c], the forward) and a[c * lda + k] when it is true (W[c][k], the
// backward's W dv). A is staged through `w_tile` in kKTile x kColsPerPass
// tiles, prefetched into registers one tile ahead; the load order keeps
// neighbouring threads on neighbouring addresses in both cases. Each thread
// holds an (RT rows x 8 columns) accumulator and hands each column to
// `epi(c, r0, vals)`, vals[i] being row r0 + i. Starts with a barrier, so the
// caller may reuse w_tile's memory right before the call.
template <int TR, bool kTrans, typename Epilogue>
__device__ __forceinline__ void block_matmul(const float* __restrict__ a,
                                             int n_red, int n_out, int lda,
                                             const float* in, float* w_tile,
                                             Epilogue epi) {
  constexpr int RT = TR / kRowGroups;
  constexpr int LDH = TR + 4;
  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int r0 = (tid / kColGroups) * RT;

  auto load = [&](float (&pre)[kPrefetch], int k0, int j0) {
#pragma unroll
    for (int q = 0; q < kPrefetch; ++q) {
      const int i = tid + q * kThreads;
      const int kk = kTrans ? i % kKTile : i / kColsPerPass;
      const int c = kTrans ? i / kKTile : i % kColsPerPass;
      const int k = k0 + kk, j = j0 + c;
      float v = 0.f;
      if (k < n_red && j < n_out) {
        v = __ldg(a + (kTrans ? (size_t)j * lda + k : (size_t)k * lda + j));
      }
      pre[q] = v;
    }
  };

  for (int j0 = 0; j0 < n_out; j0 += kColsPerPass) {
    float acc[RT][8];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

    float pre[kPrefetch];
    load(pre, 0, j0);
    for (int k0 = 0; k0 < n_red; k0 += kKTile) {
      __syncthreads();  // every warp is done with the previous tile
#pragma unroll
      for (int q = 0; q < kPrefetch; ++q) {
        const int i = tid + q * kThreads;
        const int kk = kTrans ? i % kKTile : i / kColsPerPass;
        const int c = kTrans ? i / kKTile : i % kColsPerPass;
        w_tile[kk * kLdw + c] = pre[q];
      }
      __syncthreads();
      if (k0 + kKTile < n_red) load(pre, k0 + kKTile, j0);
#pragma unroll
      for (int kk = 0; kk < kKTile; ++kk) {
        if (k0 + kk < n_red) {
          const float* hk = in + (k0 + kk) * LDH + r0;
          float hv[RT];
#pragma unroll
          for (int i = 0; i < RT; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(hk + i);
            hv[i] = v.x;
            hv[i + 1] = v.y;
            hv[i + 2] = v.z;
            hv[i + 3] = v.w;
          }
          const float* wk = w_tile + kk * kLdw + cg * 4;
          const float4 wa = *reinterpret_cast<const float4*>(wk);
          const float4 wb =
              *reinterpret_cast<const float4*>(wk + kColsPerPass / 2);
          const float wv[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int c = 0; c < 8; ++c) acc[i][c] = fmaf(hv[i], wv[c], acc[i][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int j = j0 + cg * 4 + (c & 3) + (c >> 2) * (kColsPerPass / 2);
      if (j < n_out) {
        float vals[RT];
#pragma unroll
        for (int i = 0; i < RT; ++i) vals[i] = acc[i][c];
        epi(j, r0, vals);
      }
    }
  }
}

// out[c * LDH + r] = rs * sum_j a[c * n_red + j] * in[j * LDH + r] for
// c < n_out, j < n_red: the backward's W dv for a weight with few rows (the
// first layer's, one row per encoded feature), where a 512-column
// block_matmul pass would leave most columns idle. One output per thread at
// a time: a warp shares c (a broadcast read of W's row) and covers TR
// neighbouring r; the sum runs in j order.
template <int TR>
__device__ __forceinline__ void narrow_matmul(const float* __restrict__ a,
                                              int n_red, int n_out,
                                              const float* in, float* out,
                                              float rs) {
  constexpr int LDH = TR + 4;
  for (int o = threadIdx.x; o < n_out * TR; o += kThreads) {
    const int c = o / TR, r = o % TR;
    const float* ac = a + (size_t)c * n_red;
    const float* ir = in + r;
    float acc = 0.f;
    int j = 0;
    if ((n_red & 3) == 0) {
      const float4* a4 = reinterpret_cast<const float4*>(ac);
      for (; j < n_red; j += 4) {
        const float4 v = __ldg(a4 + j / 4);
        acc = fmaf(v.x, ir[j * LDH], acc);
        acc = fmaf(v.y, ir[(j + 1) * LDH], acc);
        acc = fmaf(v.z, ir[(j + 2) * LDH], acc);
        acc = fmaf(v.w, ir[(j + 3) * LDH], acc);
      }
    }
    for (; j < n_red; ++j) acc = fmaf(__ldg(ac + j), ir[j * LDH], acc);
    out[c * LDH + r] = acc * rs;
  }
}

// dw[e] (+)= a[e] b[e]^T over `len` rows: a (E, m, ld), b (E, nn, ld),
// dw (E, m, nn). 128 x 128 output tile per block, 8 x 8 per thread, rows
// staged 8 at a time. Each output is summed over rows in order by one
// thread; `accumulate` adds the chunk's sum to what dw holds. kRound rounds
// both operands to bf16 where they are staged into shared memory.
constexpr int kGTile = 128;
constexpr int kGK = 8;
constexpr int kGLd = kGTile + 4;
constexpr int kGLoads = kGTile * kGK / kThreads;  // 4 per operand per thread

template <bool kRound>
__global__ void __launch_bounds__(kThreads)
    wgrad_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ dw, int m, int nn, int len, int ld,
                 int accumulate) {
  __shared__ __align__(16) float as[kGK][kGLd];
  __shared__ __align__(16) float bs[kGK][kGLd];
  const int e = blockIdx.z;
  const int k0 = blockIdx.y * kGTile, j0 = blockIdx.x * kGTile;
  const float* ap = a + (size_t)e * m * ld;
  const float* bp = b + (size_t)e * nn * ld;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  float pa[kGLoads], pb[kGLoads];
  auto load = [&](int r0) {
#pragma unroll
    for (int q = 0; q < kGLoads; ++q) {
      const int i = tid + q * kThreads;
      const int row = i / kGK, r = r0 + i % kGK;
      pa[q] = (k0 + row < m && r < len) ? __ldg(ap + (size_t)(k0 + row) * ld + r) : 0.f;
      pb[q] = (j0 + row < nn && r < len) ? __ldg(bp + (size_t)(j0 + row) * ld + r) : 0.f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(0);
  for (int r0 = 0; r0 < len; r0 += kGK) {
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kGLoads; ++q) {
      const int i = tid + q * kThreads;
      as[i % kGK][i / kGK] = kRound ? round_bf16(pa[q]) : pa[q];
      bs[i % kGK][i / kGK] = kRound ? round_bf16(pb[q]) : pb[q];
    }
    __syncthreads();
    if (r0 + kGK < len) load(r0 + kGK);
#pragma unroll
    for (int rr = 0; rr < kGK; ++rr) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[rr][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[rr][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[rr][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[rr][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = k0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (k >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + (j >> 2) * 64 + tx * 4 + (j & 3);
      if (jj >= nn) continue;
      float* p = dw + ((size_t)e * m + k) * nn + jj;
      *p = accumulate ? *p + acc[i][j] : acc[i][j];
    }
  }
}

// out[e][k] (+)= sum_{r < len} a[e][k][r] * (b ? b[e][r] : 1), a (E, rows,
// ld), b (E, ld), out (E, rows): one warp per (e, k), lanes striding the rows,
// then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
    rowdot_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ out, int members, int rows, int len,
                  int ld, int accumulate) {
  const int gw = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (gw >= members * rows) return;
  const int e = gw / rows;
  const float* ap = a + (size_t)gw * ld;
  float v = 0.f;
  if (b == nullptr) {
    for (int r = lane; r < len; r += 32) v += __ldg(ap + r);
  } else {
    const float* bp = b + (size_t)e * ld;
    for (int r = lane; r < len; r += 32) v = fmaf(__ldg(ap + r), __ldg(bp + r), v);
  }
  v = warp_sum(v);
  if (lane == 0) out[gw] = accumulate ? out[gw] + v : v;
}

// out[i] = in[i] rounded to bf16 (the weights' copies under 'bf16').
__global__ void __launch_bounds__(kThreads)
    round_bf16_kernel(const float* __restrict__ in, float* __restrict__ out,
                      size_t n) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x; i < n;
       i += (size_t)gridDim.x * kThreads) {
    out[i] = round_bf16(__ldg(in + i));
  }
}

// Whether a layer's product takes bf16-rounded operands under 'bf16': the
// TPU kernels (`_mm`, `_mm_t`) keep a product fp32 when its result has a
// last dimension of 1. Features-major that is only the output layer's
// weight gradient (the row sums); row-major also the forward h @ W when
// fan_out is 1 and the backward dv @ W^T when fan_in is 1.
inline bool rounds_forward(bool row_major, int fan_out) {
  return !row_major || fan_out > 1;
}
inline bool rounds_dh(bool row_major, int fan_in) {
  return !row_major || fan_in > 1;
}

// Launches out[i] = bf16(in[i]) over `count` floats on `stream` (a weight's
// rounded copy); returns the launch's error.
inline cudaError_t launch_round_bf16(const float* in, float* out, size_t count,
                                     cudaStream_t stream) {
  const size_t blocks = (count + kThreads - 1) / kThreads;
  round_bf16_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), kThreads, 0,
                      stream>>>(in, out, count);
  return cudaGetLastError();
}

}  // namespace
