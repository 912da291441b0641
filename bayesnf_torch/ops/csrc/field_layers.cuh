// The field MLP's layer-wise kernels for Hopper (sm_90a), shared by K1
// (`fused_train.cu`) and by K2, K3, K4a and K4b (`fused_mlp_t.cu`): per
// hidden layer one GEMM over a chunk of rows with the elementwise work fused
// into its epilogue, and the cross-row weight gradients, all on activations
// held features-major in a global scratch (E, features, ld), ld the chunk's
// rows in whole 128-row tiles.
//
//   forward      z_l = s_l (W_l^T lhs_l + b_l), lhs_{l+1} = act(z_l) / sqrt(width)
//   W dv         dh_l = W_l dv_l / sqrt(fan_in_l), then dv_{l-1} = dh_l act'(z_{l-1}) s_{l-1}
//                (l >= 1) or dh_0 (l = 0)
//   weight grad  dW_l (+)= sum over the chunk's rows of lhs_l dv_l^T
//
// Under 'f32' the products run on the SIMT engine of `simt_gemm.cuh`, under
// 'bf16' on the tensor-core core of `wgmma_gemm.cuh` (bf16 copies of the
// weights, bf16 twins of lhs_l and dv_l beside the fp32 scratch, one TMA
// tensor map per operand). Each output is one fixed-order sum in one block,
// the scalar sums are per (row tile, layer, 128-column block) partials that
// the callers add in a fixed order: no atomics, so two identical calls are
// bit-equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "field_mlp.cuh"
#include "simt_gemm.cuh"
#include "wgmma_gemm.cuh"

namespace {

// Rows per tile: the GEMMs' N tile, and one thread per row in the per-row
// kernels. Chunks are whole tiles.
constexpr int kRowTile = kSgTile;
constexpr int kRowWarps = kRowTile / 32;
// The output layer's forward sums each row's products in kHeadLanes strided
// chains, then the chains in order (K1's head, and `fused_mlp_t.cu`'s).
constexpr int kHeadLanes = 8;

// The field MLP's part of a call: parameters, the chunk's scratch and its
// place among the rows.
struct FieldArgs {
  const float* w[kMaxLayers];      // (E, fan_in_l, fan_out_l)
  const float* b[kMaxLayers];      // (E, fan_out_l)
  bool w_vec[kMaxLayers];          // W_l allows 16-byte copies
  const float* scales_raw;         // (E, depth + 1)
  const float* logit;              // (E,)
  float* lhs[kMaxLayers];          // (E, fan_in_l, ld) chunk scratch
  float* z[kMaxLayers];            // (E, width, ld), l < depth
  float* dv[kMaxLayers];           // (E, fan_out_l, ld)
  float* dh0;                      // (E, F, ld) scratch, or the caller's
  __nv_bfloat16* lhs_bf[kMaxLayers];  // 'bf16': lhs_l's twin, l < depth
  __nv_bfloat16* dv_bf[kMaxLayers];   // 'bf16': dv_l's twin, l < depth
  float* layer_partials;           // (E, num_tiles, depth, col_blocks, 2)
  float rsqrt[kMaxLayers];         // 1/sqrt(fan_in_l), rounded from double
  int depth;
  int num_features;
  int width;
  int n_rows;                      // rows N: the stride of the row inputs
  int n_valid;                     // rows that count: index < n_valid
  int row0;                        // first row of this chunk
  int ld;                          // scratch row stride (rows per chunk)
  int tile0;                       // global index of the chunk's first tile
  int num_tiles;                   // tiles over all N rows
  int col_blocks;                  // 128-column blocks of a hidden layer
};

// Sums of `count` per-thread values over a row tile's kRowTile threads in a
// fixed order (a shuffle tree per warp, then the warps in order), written
// to out[0..count) by thread 0. `red` holds count * kRowWarps floats.
__device__ __forceinline__ void tile_sums(const float* vals, int count,
                                          float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int v = 0; v < count; ++v) {
    const float s = warp_sum(vals[v]);
    if (lane == 0) red[v * kRowWarps + warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int v = 0; v < count; ++v) {
      float total = 0.f;
      for (int w = 0; w < kRowWarps; ++w) total += red[v * kRowWarps + w];
      out[v] = total;
    }
  }
  __syncthreads();  // `red` is free again
}

// Member e's layer partials of (global) row tile `tile` and hidden layer l.
__device__ __forceinline__ float* layer_partials(const FieldArgs& args, int e,
                                                 int tile, int l) {
  return args.layer_partials +
         (((size_t)e * args.num_tiles + tile) * args.depth + l) *
             args.col_blocks * 2;
}

// --- Hidden layer l's forward: z_l = s_l (W_l^T lhs_l + b_l) and
// lhs_{l+1} = act(z_l) / sqrt(width); grid (width / 128, row tiles,
// members). kStoreZ writes z_l too (a backward reads it).
template <bool kStoreZ>
__global__ void __launch_bounds__(kThreads, 2)
    forward_kernel(const FieldArgs args, int l) {
  const int e = blockIdx.z;
  const int width = args.width;
  const int fan_in = l == 0 ? args.num_features : width;
  const size_t ld = args.ld;
  const float* b = args.b[l] + (size_t)e * width;
  const float s = softplus(args.scales_raw[(size_t)e * (args.depth + 1) + l]);
  const float wgt = sigmoid(args.logit[e]);
  const float rs_next = args.rsqrt[l + 1];
  float* zg = kStoreZ ? args.z[l] + (size_t)e * width * ld : nullptr;
  float* out = args.lhs[l + 1] + (size_t)e * width * ld;
  simt_gemm<true>(
      args.w[l] + (size_t)e * fan_in * width, width, args.w_vec[l],
      args.lhs[l] + (size_t)e * fan_in * ld, (int)ld, width, fan_in,
      [&](int c, int n, const float (&v)[4]) {
        const float bj = __ldg(b + c);
        float zz[4], h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zz[j] = s * (v[j] + bj);
          h[j] = blended_act(zz[j], wgt) * rs_next;
        }
        if constexpr (kStoreZ) {
          *reinterpret_cast<float4*>(zg + c * ld + n) =
              make_float4(zz[0], zz[1], zz[2], zz[3]);
        }
        *reinterpret_cast<float4*>(out + c * ld + n) =
            make_float4(h[0], h[1], h[2], h[3]);
      });
}

// --- The same on the tensor cores ('bf16'): A = W_l's bf16 copy
// (MN-major), B = lhs_l's twin (MN-major); the epilogue also writes
// lhs_{l+1}'s twin when layer l + 1 is hidden. Without z (a forward alone)
// lhs_{l+1} is written in fp32 only for the output layer, its one fp32
// reader. Grid as forward_kernel's.
template <bool kStoreZ>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
    tc_forward_kernel(const FieldArgs args, int l,
                      const __grid_constant__ CUtensorMap w_map,
                      const __grid_constant__ CUtensorMap lhs_map) {
  extern __shared__ uint8_t tc_smem[];
  const int e = blockIdx.z;
  const int width = args.width;
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  float acc[64];
  tc_mainloop<kMNMajor, kMNMajor>(w_map, lhs_map, m0, n0, e, width, args.ld,
                                  l == 0 ? args.num_features : width, tc_smem,
                                  acc);
  const size_t ld = args.ld;
  const float* b = args.b[l] + (size_t)e * width;
  const float s = softplus(args.scales_raw[(size_t)e * (args.depth + 1) + l]);
  const float wgt = sigmoid(args.logit[e]);
  const float rs_next = args.rsqrt[l + 1];
  const size_t off = (size_t)e * width * ld;
  float* zg = kStoreZ ? args.z[l] + off : nullptr;
  float* out = kStoreZ || l + 1 == args.depth ? args.lhs[l + 1] + off
                                              : nullptr;
  __nv_bfloat16* out_bf = l + 1 < args.depth ? args.lhs_bf[l + 1] + off
                                             : nullptr;
  tc_epilogue(acc, m0, n0, width, [&](int c, int n, float v0, float v1) {
    const float bj = __ldg(b + c);
    const float z0 = s * (v0 + bj), z1 = s * (v1 + bj);
    const float h0 = blended_act(z0, wgt) * rs_next;
    const float h1 = blended_act(z1, wgt) * rs_next;
    if constexpr (kStoreZ) {
      *reinterpret_cast<float2*>(zg + c * ld + n) = make_float2(z0, z1);
    }
    if (kStoreZ || out != nullptr) {
      *reinterpret_cast<float2*>(out + c * ld + n) = make_float2(h0, h1);
    }
    if (out_bf != nullptr) {
      *reinterpret_cast<__nv_bfloat162*>(out_bf + c * ld + n) =
          __floats2bfloat162_rn(h0, h1);
    }
  });
}

// Where the first layer's W dv product writes dh_0: the (E, F, ld) chunk
// scratch (K1), or the caller's dh0 for the chunk's rows below n_valid,
// features-major (E, F, n_rows) (K3) or row-major (E, n_rows, F) (K4b).
enum Dh0Out : int { kDh0Scratch = 0, kDh0Features = 1, kDh0Rows = 2 };

// Element (k, n) of the chunk's dh_0 in the caller's `kDh0` layout: `dh0`
// is member e's first chunk row, `stride` the rows N (features-major) or
// the features F (row-major).
template <int kDh0>
__device__ __forceinline__ float& dh0_at(float* dh0, size_t stride, int k,
                                         int n) {
  return kDh0 == kDh0Rows ? dh0[(size_t)n * stride + k]
                          : dh0[(size_t)k * stride + n];
}

// Member e's first chunk row of the caller's dh0, and its stride (dh0_at).
template <int kDh0>
__device__ __forceinline__ float* dh0_chunk(const FieldArgs& args, int e,
                                            size_t* stride) {
  const size_t f = args.num_features, n = args.n_rows;
  *stride = kDh0 == kDh0Rows ? f : n;
  return kDh0 == kDh0Rows ? args.dh0 + ((size_t)e * n + args.row0) * f
                          : args.dh0 + (size_t)e * f * n + args.row0;
}

// --- dh = W_l dv_l / sqrt(fan_in_l) (W_l of shape (fan_in_l, width));
// for l >= 1 the epilogue turns it into dv_{l-1} = dh act'(z_{l-1}) s_{l-1}
// (kTwin: and its bf16 twin, for a tensor-core product that reads it) with
// the block's sums of dz z and dh dact/dw, for l = 0 it writes dh_0 where
// kDh0 says. Grid (fan_in_l / 128, row tiles, members).
template <bool kFirst, int kDh0 = kDh0Scratch, bool kTwin = false>
__global__ void __launch_bounds__(kThreads, 2)
    backward_kernel(const FieldArgs args, int l) {
  __shared__ float red[kWarps];
  const int e = blockIdx.z;
  const int width = args.width;
  const int fan_in = kFirst ? args.num_features : width;
  const size_t ld = args.ld;
  const float rs = args.rsqrt[l];
  const float* w = args.w[l] + (size_t)e * fan_in * width;
  const float* dv = args.dv[l] + (size_t)e * width * ld;
  if constexpr (kFirst && kDh0 != kDh0Scratch) {
    size_t stride;
    float* dh0 = dh0_chunk<kDh0>(args, e, &stride);
    const int len = args.n_valid - args.row0;
    simt_gemm<false>(w, width, false, dv, (int)ld, fan_in, width,
                     [&](int k, int n, const float (&v)[4]) {
#pragma unroll
                       for (int j = 0; j < 4; ++j) {
                         if (n + j < len) {
                           dh0_at<kDh0>(dh0, stride, k, n + j) = v[j] * rs;
                         }
                       }
                     });
  } else if constexpr (kFirst) {
    float* dh0 = args.dh0 + (size_t)e * fan_in * ld;
    simt_gemm<false>(w, width, false, dv, (int)ld, fan_in, width,
                     [&](int k, int n, const float (&v)[4]) {
                       *reinterpret_cast<float4*>(dh0 + k * ld + n) =
                           make_float4(v[0] * rs, v[1] * rs, v[2] * rs,
                                       v[3] * rs);
                     });
  } else {
    const float s =
        softplus(args.scales_raw[(size_t)e * (args.depth + 1) + l - 1]);
    const float wgt = sigmoid(args.logit[e]);
    const float* zg = args.z[l - 1] + (size_t)e * width * ld;
    float* dvg = args.dv[l - 1] + (size_t)e * width * ld;
    __nv_bfloat16* dvg_bf =
        kTwin ? args.dv_bf[l - 1] + (size_t)e * width * ld : nullptr;
    float dzz = 0.f, dlogit = 0.f;
    simt_gemm<false>(
        w, width, false, dv, (int)ld, fan_in, width,
        [&](int k, int n, const float (&v)[4]) {
          const float4 z4 = *reinterpret_cast<const float4*>(zg + k * ld + n);
          const float z[4] = {z4.x, z4.y, z4.z, z4.w};
          float out[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float dact_dz, dact_dw;
            blended_act_grad(z[j], wgt, &dact_dz, &dact_dw);
            const float dh = v[j] * rs;
            dlogit += dh * dact_dw;
            const float dz = dh * dact_dz;
            dzz += dz * z[j];
            out[j] = dz * s;
          }
          *reinterpret_cast<float4*>(dvg + k * ld + n) =
              make_float4(out[0], out[1], out[2], out[3]);
          if constexpr (kTwin) {
            __nv_bfloat162* bf =
                reinterpret_cast<__nv_bfloat162*>(dvg_bf + k * ld + n);
            bf[0] = __floats2bfloat162_rn(out[0], out[1]);
            bf[1] = __floats2bfloat162_rn(out[2], out[3]);
          }
        });
    dzz = block_sum(dzz, red);
    dlogit = block_sum(dlogit, red);
    if (threadIdx.x == 0) {
      float* lp = layer_partials(args, e, args.tile0 + blockIdx.y, l - 1);
      lp[blockIdx.x * 2] = dzz;
      lp[blockIdx.x * 2 + 1] = dlogit;
    }
  }
}

// --- The same on the tensor cores ('bf16'): A = W_l's bf16 copy
// (K-major: W_l[k][c], the reduction over c), B = dv_l's twin (MN-major);
// for l >= 1 the epilogue also writes dv_{l-1}'s twin. Grid as
// backward_kernel's.
static_assert(kTcThreads == kThreads, "block_sum sums kThreads threads");

template <bool kFirst, int kDh0 = kDh0Scratch>
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
    tc_backward_kernel(const FieldArgs args, int l,
                       const __grid_constant__ CUtensorMap w_map,
                       const __grid_constant__ CUtensorMap dv_map) {
  extern __shared__ uint8_t tc_smem[];
  __shared__ float red[kTcThreads / 32];
  const int e = blockIdx.z;
  const int width = args.width;
  const int fan_in = kFirst ? args.num_features : width;
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  float acc[64];
  tc_mainloop<kKMajor, kMNMajor>(w_map, dv_map, m0, n0, e, fan_in, args.ld,
                                 width, tc_smem, acc);
  const size_t ld = args.ld;
  const float rs = args.rsqrt[l];
  if constexpr (kFirst && kDh0 != kDh0Scratch) {
    size_t stride;
    float* dh0 = dh0_chunk<kDh0>(args, e, &stride);
    const int len = args.n_valid - args.row0;
    tc_epilogue(acc, m0, n0, fan_in, [&](int k, int n, float v0, float v1) {
      if (n < len) dh0_at<kDh0>(dh0, stride, k, n) = v0 * rs;
      if (n + 1 < len) dh0_at<kDh0>(dh0, stride, k, n + 1) = v1 * rs;
    });
  } else if constexpr (kFirst) {
    float* dh0 = args.dh0 + (size_t)e * fan_in * ld;
    tc_epilogue(acc, m0, n0, fan_in, [&](int k, int n, float v0, float v1) {
      *reinterpret_cast<float2*>(dh0 + k * ld + n) =
          make_float2(v0 * rs, v1 * rs);
    });
  } else {
    const float s =
        softplus(args.scales_raw[(size_t)e * (args.depth + 1) + l - 1]);
    const float wgt = sigmoid(args.logit[e]);
    const size_t off = (size_t)e * width * ld;
    const float* zg = args.z[l - 1] + off;
    float* dvg = args.dv[l - 1] + off;
    __nv_bfloat16* dvg_bf = args.dv_bf[l - 1] + off;
    float dzz = 0.f, dlogit = 0.f;
    tc_epilogue(acc, m0, n0, width, [&](int k, int n, float v0, float v1) {
      const float2 z2 = *reinterpret_cast<const float2*>(zg + k * ld + n);
      const float z[2] = {z2.x, z2.y}, v[2] = {v0, v1};
      float out[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float dact_dz, dact_dw;
        blended_act_grad(z[j], wgt, &dact_dz, &dact_dw);
        const float dh = v[j] * rs;
        dlogit += dh * dact_dw;
        const float dz = dh * dact_dz;
        dzz += dz * z[j];
        out[j] = dz * s;
      }
      *reinterpret_cast<float2*>(dvg + k * ld + n) = make_float2(out[0], out[1]);
      *reinterpret_cast<__nv_bfloat162*>(dvg_bf + k * ld + n) =
          __floats2bfloat162_rn(out[0], out[1]);
    });
    dzz = block_sum(dzz, red);
    dlogit = block_sum(dlogit, red);
    if (threadIdx.x == 0) {
      float* lp = layer_partials(args, e, args.tile0 + blockIdx.y, l - 1);
      lp[blockIdx.x * 2] = dzz;
      lp[blockIdx.x * 2 + 1] = dlogit;
    }
  }
}

// --- The hidden weight gradient on the tensor cores ('bf16'):
// dw(k, c) (+)= sum over the chunk's `len` rows of lhs_l[k][n] dv_l[c][n],
// A = lhs_l's twin and B = dv_l's twin, both K-major (the rows are the
// reduction); `accumulate` adds the chunk's sum to what dw holds, so the
// chunks add in order. dw is (E, fan_in, width); grid (fan_in / 128,
// width / 128, members).
__global__ void __launch_bounds__(kTcThreads, kTcBlocksPerSm)
    tc_wgrad_kernel(const __grid_constant__ CUtensorMap lhs_map,
                    const __grid_constant__ CUtensorMap dv_map,
                    float* __restrict__ dw, int fan_in, int width, int len,
                    int accumulate) {
  extern __shared__ uint8_t tc_smem[];
  const int e = blockIdx.z;
  const int m0 = blockIdx.x * kTcTile, n0 = blockIdx.y * kTcTile;
  float acc[64];
  tc_mainloop<kKMajor, kKMajor>(lhs_map, dv_map, m0, n0, e, fan_in, width,
                                len, tc_smem, acc);
  float* out = dw + (size_t)e * fan_in * width;
  tc_epilogue(acc, m0, n0, fan_in, [&](int k, int c, float v0, float v1) {
    const float v[2] = {v0, v1};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (c + j < width) {
        float* p = out + (size_t)k * width + c + j;
        *p = accumulate ? *p + v[j] : v[j];
      }
    }
  });
}

// A hidden W_l (rows of `width` floats) as bf16 rows of `ldw` >= width,
// zero past the width: the tensor-core products' A operand.
__global__ void __launch_bounds__(kThreads)
    weights_bf16_kernel(const float* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, size_t rows,
                        int width, int ldw) {
  for (size_t i = blockIdx.x * (size_t)kThreads + threadIdx.x;
       i < rows * ldw; i += (size_t)gridDim.x * kThreads) {
    const size_t r = i / ldw;
    const int c = (int)(i % ldw);
    out[i] = __float2bfloat16_rn(c < width ? __ldg(w + r * width + c) : 0.f);
  }
}

// --- Host side.

inline int col_blocks(int width) { return (width + kSgTile - 1) / kSgTile; }

// 'bf16': the bf16 weight copies' row stride, a multiple of 8 elements
// (TMA's 16-byte strides), and their elements per member.
inline int padded_width(int width) { return (width + 7) / 8 * 8; }
inline size_t weight_copies(int num_features, int width, int depth) {
  return depth ? (num_features + (size_t)(depth - 1) * width) *
                     padded_width(width)
               : 0;
}

// A launch's status when a tensor map could not be made (no cudaError_t
// has this value).
constexpr int kTensorMapError = 2000;

// The tensor maps of the 'bf16' products, per hidden layer l.
struct TcMaps {
  CUtensorMap w[kMaxLayers];    // W_l's bf16 copy: (width, fan_in_l, E)
  CUtensorMap lhs[kMaxLayers];  // lhs_l's twin: (ld, fan_in_l, E)
  CUtensorMap dv[kMaxLayers];   // dv_l's twin: (ld, width, E)
};

// Opts a tensor-core kernel into kTcSmemBytes of dynamic shared memory.
template <typename Kernel>
cudaError_t set_tc_smem(Kernel* kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemBytes);
}

// 'bf16': each hidden W_l's bf16 copy into w_bf[l] (rows padded to
// padded_width), and the tensor maps of the products' operands: the copies,
// lhs_l's twins and, where the scratch holds them, dv_l's. The scratch does
// not move between chunks, so the maps serve every chunk. Returns a
// cudaError_t, or kTensorMapError.
inline int prepare_tc(const FieldArgs& args, __nv_bfloat16* const* w_bf,
                      int members, TcMaps* maps, cudaStream_t s) {
  const int width = args.width, ldw = padded_width(width);
  const size_t ld = args.ld;
  for (int l = 0; l < args.depth; ++l) {
    const int fan_in = l == 0 ? args.num_features : width;
    const size_t count = (size_t)members * fan_in * ldw;
    const size_t blocks = (count + kThreads - 1) / kThreads;
    weights_bf16_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096),
                          kThreads, 0, s>>>(args.w[l], w_bf[l],
                                            (size_t)members * fan_in, width,
                                            ldw);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (!encode_tc_map(&maps->w[l], w_bf[l], width, fan_in, members, ldw,
                       (size_t)fan_in * ldw) ||
        !encode_tc_map(&maps->lhs[l], args.lhs_bf[l], ld, fan_in, members,
                       ld, (size_t)fan_in * ld) ||
        (args.dv_bf[l] != nullptr &&
         !encode_tc_map(&maps->dv[l], args.dv_bf[l], ld, width, members, ld,
                        (size_t)width * ld))) {
      return kTensorMapError;
    }
  }
  return 0;
}

// The hidden layers' forwards of one chunk of `tiles` row tiles. Under
// 'bf16' each runs on the tensor cores where its product rounds
// (`rounds_forward`); row-major at width 1 none does, and the SIMT
// forwards' fp32 outputs are all their readers take.
template <bool kStoreZ, bool kRowMajor = false>
cudaError_t launch_forward_layers(const FieldArgs& args, bool bf16,
                                  const TcMaps& maps, int tiles, int members,
                                  cudaStream_t s) {
  const dim3 hidden(col_blocks(args.width), tiles, members);
  const bool tc = bf16 && rounds_forward(kRowMajor, args.width);
  for (int l = 0; l < args.depth; ++l) {
    if (tc) {
      tc_forward_kernel<kStoreZ><<<hidden, kTcThreads, kTcSmemBytes, s>>>(
          args, l, maps.w[l], maps.lhs[l]);
    } else {
      forward_kernel<kStoreZ><<<hidden, kThreads, 0, s>>>(args, l);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The W dv chain of one chunk, from the last hidden layer's dv (which the
// caller's head wrote) down to dh_0 (kDh0: see backward_kernel). Under
// 'bf16' a product runs on the tensor cores where it rounds (`rounds_dh`);
// row-major, a layer >= 1 at width 1 runs on the SIMT engine instead and
// writes dv's bf16 twin as well, which the first layer's product reads when
// it rounds.
template <int kDh0, bool kRowMajor = false>
cudaError_t launch_wdv_chain(const FieldArgs& args, bool bf16,
                             const TcMaps& maps, int tiles, int members,
                             cudaStream_t s) {
  const dim3 hidden(col_blocks(args.width), tiles, members);
  const bool tc = bf16 && rounds_dh(kRowMajor, args.width);
  cudaError_t err;
  for (int l = args.depth - 1; l >= 1; --l) {
    if (tc) {
      tc_backward_kernel<false><<<hidden, kTcThreads, kTcSmemBytes, s>>>(
          args, l, maps.w[l], maps.dv[l]);
    } else if (bf16) {
      backward_kernel<false, kDh0Scratch, kRowMajor>
          <<<hidden, kThreads, 0, s>>>(args, l);
    } else {
      backward_kernel<false><<<hidden, kThreads, 0, s>>>(args, l);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (args.depth > 0) {
    const dim3 first(col_blocks(args.num_features), tiles, members);
    if (bf16 && rounds_dh(kRowMajor, args.num_features)) {
      tc_backward_kernel<true, kDh0>
          <<<first, kTcThreads, kTcSmemBytes, s>>>(args, 0, maps.w[0],
                                                   maps.dv[0]);
    } else {
      backward_kernel<true, kDh0><<<first, kThreads, 0, s>>>(args, 0);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The cross-row sums of one chunk, over its `len` rows (whole tiles: rows
// past the valid ones carry zero cotangents): the hidden weight gradients,
// every bias gradient and dW_out, into `dweights` and `dbiases` (host
// arrays of depth + 1 device pointers); `acc` adds to what they hold.
inline cudaError_t launch_weight_grads(const FieldArgs& args, bool bf16,
                                       const TcMaps& maps,
                                       void* const* dweights,
                                       void* const* dbiases, int members,
                                       int len, int acc, cudaStream_t s) {
  const int depth = args.depth, width = args.width, ld = args.ld;
  cudaError_t err;
  int fan_in = args.num_features;
  for (int l = 0; l < depth; ++l) {
    float* dw = static_cast<float*>(dweights[l]);
    if (bf16 && width > 1) {
      // Rounded operands, as the TPU kernel's when dv_l has more than
      // one column.
      const dim3 grid(col_blocks(fan_in), col_blocks(width), members);
      tc_wgrad_kernel<<<grid, kTcThreads, kTcSmemBytes, s>>>(
          maps.lhs[l], maps.dv[l], dw, fan_in, width, len, acc);
    } else if (bf16) {
      // One column: the fp32 row sums, as the output layer's.
      const int warps = members * fan_in;
      rowdot_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
          args.lhs[l], args.dv[l], dw, members, fan_in, len, ld, acc);
    } else {
      const dim3 grid((width + kGTile - 1) / kGTile,
                      (fan_in + kGTile - 1) / kGTile, members);
      wgrad_kernel<<<grid, kThreads, 0, s>>>(
          args.lhs[l], args.dv[l], dw, fan_in, width, len, ld, acc);
    }
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    fan_in = width;
  }
  for (int l = 0; l <= depth; ++l) {
    const int fan_out = l == depth ? 1 : width;
    const int warps = members * fan_out;
    rowdot_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
        args.dv[l], nullptr, static_cast<float*>(dbiases[l]), members,
        fan_out, len, ld, acc);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int warps = members * fan_in;
  rowdot_kernel<<<(warps + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      args.lhs[depth], args.dv[depth], static_cast<float*>(dweights[depth]),
      members, fan_in, len, ld, acc);
  return cudaGetLastError();
}

}  // namespace
