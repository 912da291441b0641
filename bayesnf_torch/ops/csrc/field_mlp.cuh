// Shared building blocks of the port's field-MLP kernels for Hopper (sm_90a):
// the block size, the field's scalar functions, block and warp sums in a
// fixed order, the cross-row kernels of the backward (weight gradients, row
// sums) and the rule of which products round under 'bf16'. `fused_train.cu`
// (K1) and `fused_mlp_t.cu` (K2, K3, K4a, K4b) build on them through
// `field_layers.cuh`; every reduction has a fixed order and none uses
// atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 9;  // depth <= 8, + output
constexpr int kWarps = kThreads / 32;

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

// dw[e] (+)= a[e] b[e]^T over `len` rows: a (E, m, ld), b (E, nn, ld),
// dw (E, m, nn). 128 x 128 output tile per block, 8 x 8 per thread, rows
// staged 8 at a time. Each output is summed over rows in order by one
// thread; `accumulate` adds the chunk's sum to what dw holds.
constexpr int kGTile = 128;
constexpr int kGK = 8;
constexpr int kGLd = kGTile + 4;
constexpr int kGLoads = kGTile * kGK / kThreads;  // 4 per operand per thread

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
      as[i % kGK][i / kGK] = pa[q];
      bs[i % kGK][i / kGK] = pb[q];
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

// Whether a product takes bf16-rounded operands under 'bf16': the TPU
// kernels (`_mm`, `_mm_t`) keep a product fp32 when its result has a last
// dimension of 1. Features-major that is only the output layer's weight
// gradient (the row sums); row-major also the forward h @ W when fan_out is
// 1 (the output layer's, and every hidden one's at width 1) and the W dv
// product dv @ W^T when fan_in is 1 (the output layer's at width 1, and the
// first layer's with one encoded feature). A hidden weight gradient of one
// column stays fp32 in both layouts.
__host__ __device__ constexpr bool rounds_forward(bool row_major,
                                                  int fan_out) {
  return !row_major || fan_out > 1;
}
__host__ __device__ constexpr bool rounds_dh(bool row_major, int fan_in) {
  return !row_major || fan_in > 1;
}

}  // namespace
