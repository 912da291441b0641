// A register-tiled fp32 GEMM engine on Hopper's SIMT pipe (sm_90a), for the
// layer-wise products of the field MLP's kernels (`field_layers.cuh`):
//
//   out(m, n) = sum_k A(k, m) * B(k, n),  m < M, k < K, n in the block's tile,
//
// with B(k, n) = b[k * ldb + n] (an activation or cotangent held
// features-major in scratch, contiguous along the rows n) and A either
// k-major, A(k, m) = a[k * lda + m] (the forward's W_l[k][c]), or m-major,
// A(k, m) = a[m * lda + k] (the backward's W_l[m][c] with the reduction over
// c). Each result goes to the caller's epilogue, never to memory, so the
// bias, scale, activation and its gradient fuse into the product.
//
// A block of 256 threads owns a 128 x 128 output tile (blockIdx.x along M,
// blockIdx.y along N), each thread an 8 x 8 accumulator, as `wgrad_kernel`
// in `field_mlp.cuh`. The operands stream through a ring of kSgStages
// shared-memory stages of kSgK reduction rows, filled with `cp.async`
// (16-byte copies along contiguous rows, 4-byte copies where the m-major
// operand is transposed as it lands, zero-fill past M and K), so loads stay
// kSgStages - 1 stages ahead with one barrier per stage. The B tile is
// always whole (the caller pads N to the tile: the callers size their
// scratch in 128-row tiles).
//
// Order. Every output is one fp32 FMA chain over k = 0, 1, ..., K - 1, in
// one thread (no split-K, no atomics), so a result does not depend on the
// tiling or on the other blocks. (The 'bf16' products run on the
// tensor cores instead: `wgmma_gemm.cuh`.)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "field_mlp.cuh"

namespace {

constexpr int kSgTile = 128;          // block tile along M and along N
constexpr int kSgK = 8;               // reduction rows per stage
constexpr int kSgStages = 3;          // stages in flight
constexpr int kSgLd = kSgTile + 4;    // staged row stride (floats)
static_assert(kThreads == 256, "the engine maps 256 threads to 16 x 16");

__device__ __forceinline__ unsigned shared_address(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes from global `src` to shared `dst`, or 4 zero bytes when !valid
// (src is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16 bytes (both addresses 16-byte aligned), or 16 zero bytes when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of this thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The block's 128 x 128 tile of A^T B, handed to `epi(m, n, v)` for each
// row m < M and each run of four columns n..n+3 (v[j] is column n + j).
// kAKMajor picks A's layout (see the header); `a_vec` allows 16-byte copies
// of a k-major A (lda % 4 == 0 and `a` 16-byte aligned); b and ldb must
// allow them always.
template <bool kAKMajor, typename Epilogue>
__device__ __forceinline__ void simt_gemm(const float* __restrict__ a, int lda,
                                          bool a_vec,
                                          const float* __restrict__ b, int ldb,
                                          int M, int K, Epilogue epi) {
  __shared__ __align__(16) float as[kSgStages][kSgK][kSgLd];
  __shared__ __align__(16) float bs[kSgStages][kSgK][kSgLd];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int m0 = blockIdx.x * kSgTile, n0 = blockIdx.y * kSgTile;
  // This thread's copies: one 4-float run of B and of a k-major A (row
  // `lk`, columns `l4`..`l4`+3), or four single elements of an m-major A
  // (element q at row (tid + q * 256) % kSgK, column (tid + q * 256) / kSgK).
  const int lk = tid / 32, l4 = (tid % 32) * 4;

  auto load = [&](int s, int t) {
    const int k0 = t * kSgK;
    {
      const int k = k0 + lk;
      cp_async16(&bs[s][lk][l4], k < K ? b + (size_t)k * ldb + n0 + l4 : b,
                 k < K);
    }
    if constexpr (kAKMajor) {
      const int k = k0 + lk, m = m0 + l4;
      if (a_vec && m + 4 <= M) {
        cp_async16(&as[s][lk][l4], k < K ? a + (size_t)k * lda + m : a, k < K);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = k < K && m + j < M;
          cp_async4(&as[s][lk][l4 + j], ok ? a + (size_t)k * lda + m + j : a,
                    ok);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = tid + q * kThreads;
        const int kk = i % kSgK, mm = i / kSgK;
        const int k = k0 + kk, m = m0 + mm;
        const bool ok = k < K && m < M;
        cp_async4(&as[s][kk][mm], ok ? a + (size_t)m * lda + k : a, ok);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  auto step = [&](int s, int kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(&as[s][kk][ty * 4]);
    const float4 a1 = *reinterpret_cast<const float4*>(&as[s][kk][64 + ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&bs[s][kk][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&bs[s][kk][64 + tx * 4]);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  };

  const int nk = (K + kSgK - 1) / kSgK;
#pragma unroll
  for (int s = 0; s < kSgStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int t = 0; t < nk; ++t) {
    const int s = t % kSgStages;
    cp_async_wait<kSgStages - 2>();  // this thread's copies of stage t
    // Every copy of stage t is visible, and every thread is done with the
    // stage that the next load overwrites (read in iteration t - 1).
    __syncthreads();
    if (t + kSgStages - 1 < nk) {
      load((t + kSgStages - 1) % kSgStages, t + kSgStages - 1);
    }
    cp_async_commit();
    const int kmax = K - t * kSgK;
    if (kmax >= kSgK) {
#pragma unroll
      for (int kk = 0; kk < kSgK; ++kk) step(s, kk);
    } else {
      for (int kk = 0; kk < kmax; ++kk) step(s, kk);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                          acc[i][4 * h + 3]};
      epi(m, n0 + h * 64 + tx * 4, v);
    }
  }
}

}  // namespace
