// Fused ensemble field-MLP forward, features-major layout, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_forward_kernel_t` reached through
// `fused_field_mlp_t` / `_forward_t` in bayesnf_tpu/ops/fused_mlp.py. Per
// ensemble member e and row n it computes
//
//   h_0 = concat(feature groups)                          (F rows)
//   z_l = s_l * (W_l^T (h_l / sqrt(fan_in_l)) + b_l),  h_{l+1} = act(z_l)
//   pred = s_out * (W_out^T (h_depth / sqrt(width)) + b_out)
//
// with s = softplus(scales_raw), act(z) = w*elu(z) + (1-w)*tanh(z) and
// w = sigmoid(logit), all in fp32 (FMA, no TF32, no fast-math intrinsics).
//
// What bounds it: at the serving path's shapes (64 members x 38,096 rows,
// width 512, depth 2, F = 49) one predict is ~1.4 TFLOP of fp32 FMA, so the
// kernel is bound by the SIMT fp32 pipe, not by memory: the inputs are
// ~64 x 49 x 4 B per row and the weights of one member (~1 MiB) are read by
// all of its row tiles, so they stay in the 50 MB L2.
//
// Design. The TPU kernel keeps a member's weights and a tile's activations in
// tens of MB of VMEM; a Hopper block has 227 KB of shared memory and one
// 512 x 512 fp32 matrix is 1 MiB. So here:
//   - grid = (row tiles, members): rows on x, since gridDim.y caps at 65,535;
//   - a block keeps its TR rows' activations in shared memory, features-major
//     (h[k][r], row stride TR + 4), in two buffers that the layers ping-pong
//     between, so no activation touches device memory;
//   - weights stream from global memory in (kKTile x 512) tiles, staged
//     through shared memory and prefetched into registers one tile ahead;
//   - each thread accumulates an (TR/4 rows x 8 columns) register tile, which
//     makes it 2 shared loads of 16 B of W and TR/16 broadcast loads of h per
//     8*TR/4 FMAs;
//   - the output layer (fan_out 1) reduces across the width per row in a fixed
//     order (deterministic), and only rows < n_rows are written.
// Making it fast (wgmma, TMA, bf16 operands) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroups = 4;                        // threads along rows
constexpr int kColGroups = kThreads / kRowGroups;    // 64 along columns
constexpr int kColsPerPass = 8 * kColGroups;         // 512 output columns
constexpr int kKTile = 8;                            // W rows per staged tile
constexpr int kPrefetch = kKTile * kColsPerPass / kThreads;  // 16 per thread
constexpr int kMaxLayers = 9;                        // depth <= 8, + output

struct MlpArgs {
  const float* h0;                 // (E, F, N)
  const float* w[kMaxLayers];      // (E, fan_in_l, fan_out_l)
  const float* b[kMaxLayers];      // (E, fan_out_l)
  const float* scales_raw;         // (E, depth + 1)
  const float* logit;              // (E,)
  float* out;                      // (E, N)
  float rsqrt[kMaxLayers];         // 1/sqrt(fan_in_l), rounded from double
  int depth;
  int num_features;
  int width;
  int n_rows;
};

__device__ __forceinline__ float softplus(float x) {
  // jax.nn.softplus: logaddexp(x, 0).
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float blended_act(float z, float w) {
  const float q = expf(fminf(z, 0.f));
  const float elu = z > 0.f ? z : q - 1.f;
  return w * elu + (1.f - w) * tanhf(z);
}

// Loads W[k0:k0+kKTile, j0:j0+kColsPerPass] (zero outside the matrix) into
// registers; consecutive threads read consecutive columns.
__device__ __forceinline__ void load_w_tile(float (&pre)[kPrefetch],
                                            const float* __restrict__ w,
                                            int fan_in, int fan_out, int k0,
                                            int j0, int tid) {
#pragma unroll
  for (int q = 0; q < kPrefetch; ++q) {
    const int i = tid + q * kThreads;
    const int k = k0 + i / kColsPerPass;
    const int j = j0 + i % kColsPerPass;
    pre[q] = (k < fan_in && j < fan_out) ? __ldg(w + (size_t)k * fan_out + j)
                                         : 0.f;
  }
}

template <int TR>
__global__ void __launch_bounds__(kThreads, 1)
    fused_mlp_t_fwd_kernel(const MlpArgs args) {
  constexpr int RT = TR / kRowGroups;  // rows per thread, a multiple of 4
  constexpr int LDH = TR + 4;          // padded row stride of the buffers
  static_assert(RT % 4 == 0, "rows per thread must allow float4 loads");

  extern __shared__ __align__(16) float smem[];
  const int width = args.width;
  const int kmax = max(args.num_features, width);
  float* bufs[2] = {smem, smem + kmax * LDH};
  float* w_tile = smem + 2 * kmax * LDH;  // [kKTile][kColsPerPass]

  const int tid = threadIdx.x;
  const int cg = tid % kColGroups;
  const int r0 = (tid / kColGroups) * RT;
  const int e = blockIdx.y;
  const int row0 = blockIdx.x * TR;
  const int n = args.n_rows;
  const int num_w = args.depth + 1;
  const float* scales_raw = args.scales_raw + (size_t)e * num_w;
  const float wgt = sigmoid(args.logit[e]);

  // h_0 / sqrt(F) for this tile; rows past n_rows are zero and never stored.
  {
    const int f = args.num_features;
    const float* h0 = args.h0 + (size_t)e * f * n;
    const float rs = args.rsqrt[0];
    for (int i = tid; i < f * TR; i += kThreads) {
      const int k = i / TR, r = i % TR;
      const int row = row0 + r;
      bufs[0][k * LDH + r] = row < n ? h0[(size_t)k * n + row] * rs : 0.f;
    }
  }
  __syncthreads();

  int fan_in = args.num_features;
  for (int l = 0; l < args.depth; ++l) {
    const float* w = args.w[l] + (size_t)e * fan_in * width;
    const float* b = args.b[l] + (size_t)e * width;
    const float s = softplus(scales_raw[l]);
    const float rs_next = args.rsqrt[l + 1];
    const float* hin = bufs[l & 1];
    float* hout = bufs[(l + 1) & 1];

    for (int j0 = 0; j0 < width; j0 += kColsPerPass) {
      float acc[RT][8];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;

      float pre[kPrefetch];
      load_w_tile(pre, w, fan_in, width, 0, j0, tid);
      for (int k0 = 0; k0 < fan_in; k0 += kKTile) {
        __syncthreads();  // every warp is done with the previous tile
#pragma unroll
        for (int q = 0; q < kPrefetch; ++q) w_tile[tid + q * kThreads] = pre[q];
        __syncthreads();
        if (k0 + kKTile < fan_in) {
          load_w_tile(pre, w, fan_in, width, k0 + kKTile, j0, tid);
        }
#pragma unroll
        for (int kk = 0; kk < kKTile; ++kk) {
          if (k0 + kk < fan_in) {
            const float* hk = hin + (k0 + kk) * LDH + r0;
            float hv[RT];
#pragma unroll
            for (int i = 0; i < RT; i += 4) {
              const float4 v = *reinterpret_cast<const float4*>(hk + i);
              hv[i] = v.x;
              hv[i + 1] = v.y;
              hv[i + 2] = v.z;
              hv[i + 3] = v.w;
            }
            const float* wk = w_tile + kk * kColsPerPass + cg * 4;
            const float4 wa = *reinterpret_cast<const float4*>(wk);
            const float4 wb =
                *reinterpret_cast<const float4*>(wk + kColsPerPass / 2);
            const float wv[8] = {wa.x, wa.y, wa.z, wa.w,
                                 wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int i = 0; i < RT; ++i)
#pragma unroll
              for (int c = 0; c < 8; ++c)
                acc[i][c] = fmaf(hv[i], wv[c], acc[i][c]);
          }
        }
      }

      // Bias, layer scale and activation; the next layer's 1/sqrt(fan_in)
      // is applied on the way into its input buffer.
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int j = j0 + cg * 4 + (c & 3) + (c >> 2) * (kColsPerPass / 2);
        if (j < width) {
          const float bj = b[j];
          float* dst = hout + j * LDH + r0;
#pragma unroll
          for (int i = 0; i < RT; ++i) {
            dst[i] = blended_act(s * (acc[i][c] + bj), wgt) * rs_next;
          }
        }
      }
    }
    __syncthreads();
    fan_in = width;
  }

  // Output layer: pred[r] = s_out * (sum_k W_out[k] h[k][r] + b_out). Thread
  // (g, r) sums k = g, g + G, ...; the G partials meet in shared memory and
  // are added in a fixed order.
  {
    constexpr int G = kThreads / TR;
    const float* w = args.w[args.depth] + (size_t)e * fan_in;
    const float* hin = bufs[args.depth & 1];
    const int r = tid % TR, g = tid / TR;
    float part = 0.f;
    for (int k = g; k < fan_in; k += G) part = fmaf(hin[k * LDH + r], w[k], part);
    float* red = w_tile;  // free: every warp passed the barrier above
    red[g * TR + r] = part;
    __syncthreads();
    if (tid < TR) {
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) acc += red[q * TR + tid];
      const int row = row0 + tid;
      if (row < n) {
        const float s_out = softplus(scales_raw[args.depth]);
        args.out[(size_t)e * n + row] = s_out * (acc + args.b[args.depth][e]);
      }
    }
  }
}

template <int TR>
cudaError_t launch(const MlpArgs& args, int num_members, size_t smem_bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_t_fwd_kernel<TR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((args.n_rows + TR - 1) / TR, num_members);
  fused_mlp_t_fwd_kernel<TR><<<grid, kThreads, smem_bytes, stream>>>(args);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs (bytes); the Python wrapper picks tile_rows
// with it.
size_t bnf_fused_mlp_t_fwd_smem_bytes(int tile_rows, int num_features,
                                      int width) {
  const int kmax = num_features > width ? num_features : width;
  return (2 * (size_t)kmax * (tile_rows + 4) + (size_t)kKTile * kColsPerPass) *
         sizeof(float);
}

// Launches the forward on `stream`. Pointers are device pointers to
// contiguous float32 tensors; `weights`/`biases` are host arrays of depth + 1
// device pointers; `rsqrts` is a host array of depth + 1 floats. Returns the
// launch's cudaError_t (0 on success).
int bnf_fused_mlp_t_fwd(const void* h0, const void* const* weights,
                        const void* const* biases, const void* scales_raw,
                        const void* logit, void* out, const float* rsqrts,
                        int depth, int num_members, int num_features, int width,
                        int n_rows, int tile_rows, void* stream) {
  if (depth < 0 || depth + 1 > kMaxLayers || num_members < 1 ||
      num_members > 65535 || n_rows < 1 || num_features < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MlpArgs args = {};
  args.h0 = static_cast<const float*>(h0);
  for (int l = 0; l <= depth; ++l) {
    args.w[l] = static_cast<const float*>(weights[l]);
    args.b[l] = static_cast<const float*>(biases[l]);
    args.rsqrt[l] = rsqrts[l];
  }
  args.scales_raw = static_cast<const float*>(scales_raw);
  args.logit = static_cast<const float*>(logit);
  args.out = static_cast<float*>(out);
  args.depth = depth;
  args.num_features = num_features;
  args.width = width;
  args.n_rows = n_rows;
  const size_t smem =
      bnf_fused_mlp_t_fwd_smem_bytes(tile_rows, num_features, width);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tile_rows) {
    case 32:
      return static_cast<int>(launch<32>(args, num_members, smem, s));
    case 16:
      return static_cast<int>(launch<16>(args, num_members, smem, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* bnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
