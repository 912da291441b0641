// The exact quantiles of a uniform mixture of Normals, up to 32 quantiles of
// every row in one launch, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package searches in plain jnp
// (bayesnf_tpu/inference/quantiles.py `normal_mixture_quantile_root`, a
// vectorized Chandrupatla search of a fixed 60 iterations). The port's plain
// search (bayesnf_torch/inference/quantiles.py, the 'torch' backend's and the
// CPU's) is the same loop in eager PyTorch: ~107 small ops an iteration,
// ~6,400 a quantile, most of them on lanes that converged long before. This
// kernel runs that search with a stop per row.
//
// For a row n with member means mu[k][n] (k < K) and member scales s[k]:
//
//   F(x) = mean_k ndtr((x - mu[k][n]) / s[k]) - q,
//   ndtr(z) = (1 + erf(z / sqrt(2))) / 2 (torch.special.ndtr's form),
//
// searched on the bracket [min mu - 5 max s, max mu + 5 max s] (the
// statistics come as device scalars, over every valid row of the table) by
// `find_root_chandrupatla`'s update, step for step: its interpolation test,
// its t clamp, value tolerance 1e-5, position tolerance 1e-8 plus 2 eps |x|,
// at most 60 iterations, and the answer the endpoint with the least |F|
// seen. The plain search freezes a converged lane and runs on; here the
// row leaves its loop, which gives the same root. All of it in fp32 (no
// fast-math; erff is within 2 ulp), products that feed a sum rounded apart
// (`__fmul_rn`), as PyTorch's separate ops round them.
//
// What bounds it: at the air_quality VI predict (K = 480 members, 38,144
// searched rows, 3 quantiles) the means are 73.2 MB, read once: 22 us at
// 3.35 TB/s. A search evaluates F 2 + (its iterations) times, K members
// each; at 7 operations a member (erff counted as one) that is ~3 GFLOP,
// ~0.05 ms at 67 TFLOP/s, a floor: erff and the IEEE division take ~30
// instructions between them. So it is bound by the FP32 pipe, and the
// 60-iteration search spent ~8x that work on rows that had converged.
//
// Design: a block takes a tile of consecutive rows and stages all K
// members' means of those rows in shared memory once, with coalesced loads
// (row pitch tile + 1, so that the 32 lanes reading one row's members hit
// 32 banks), and the K scales beside them. Each warp runs whole searches:
// the (row, quantile) tasks of the tile in turn, its 32 lanes splitting a
// row's members (lane l takes members l, l + 32, ...; a row's loop is
// uniform across its warp, so a row that converges frees its warp at
// once). A lane sums its members in order and the warp adds the 32 partial
// sums by an xor butterfly, which leaves the same bits in every lane. The
// order of the sum depends on K alone: not on the rows, the tile a row
// lands in, or the grid. So a chunk of rows searched alone gives the whole
// table's bits (the streamed predict, the ranks of a mesh). The tile's rows
// adapt to K (48 KB of shared memory a block, the counters' 384 bytes
// included: 64 rows at K <= 184, 16 at K = 480, 4 at K = 1,920); past
// 3,048 members not even two rows fit, and the warps read the means from
// device memory (L2) in the same order.

#include <cfloat>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// Quantiles one launch takes (passed by value); the caller launches once
// for each group of them.
constexpr int kMaxQuantiles = 32;
constexpr int kMaxIterations = 60;
constexpr int kMaxTileRows = 64;
constexpr int kMinTileRows = 2;
// The rows of a tile in the unstaged mode (K past the shared memory).
constexpr int kUnstagedTileRows = 8;
// A block's shared memory without an opt-in, static and dynamic: the
// dynamic part is what the per-quantile counters leave.
constexpr size_t kSharedBudget =
    48 * 1024 - kMaxQuantiles * (sizeof(int) + sizeof(unsigned long long));
constexpr float kSqrtHalf = 0.70710677f;  // float(M_SQRT1_2), as ndtr's.
constexpr float kValueTolerance = 1e-5f;
constexpr float kPositionTolerance = 1e-8f;
constexpr float kTwoEps = 2.0f * FLT_EPSILON;

struct Quantiles {
  float q[kMaxQuantiles];
};

// F(x) of one row, in every lane of the warp: member k's mean at
// mu[k * stride], its scale at sc[k].
__device__ __forceinline__ float mixture_cdf_gap(
    float x, const float* mu, int64_t stride, const float* sc, int members,
    float q, int lane) {
  float acc = 0.0f;
  for (int k = lane; k < members; k += 32) {
    const float z = (x - mu[k * stride]) / sc[k];
    acc += (1.0f + erff(z * kSqrtHalf)) * 0.5f;
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, offset);
  }
  return acc / static_cast<float>(members) - q;
}

__device__ __forceinline__ int sign_of(float v) {
  return (0.0f < v) - (v < 0.0f);
}

__device__ __forceinline__ float safe(float d) { return d == 0.0f ? 1.0f : d; }

// One Chandrupatla search of one row, in every lane of its warp; the root,
// and the iterations it ran in `*iterations`.
__device__ float search_row(const float* mu, int64_t stride, const float* sc,
                            int members, float q, float low, float high,
                            int lane, int* iterations) {
  float b = low;
  float fb = mixture_cdf_gap(low, mu, stride, sc, members, q, lane);
  float a = high;
  float fa = mixture_cdf_gap(high, mu, stride, sc, members, q, lane);
  // The third point c of the plain search is kept there only for frozen
  // lanes: each step derives c2 from a and b.
  float t = 0.5f;
  bool take = fabsf(fa) < fabsf(fb);
  float best_x = take ? a : b;
  float best_f = take ? fa : fb;
  int it = 0;
  while (it < kMaxIterations) {
    const float xt = __fadd_rn(a, __fmul_rn(t, b - a));
    const float ft = mixture_cdf_gap(xt, mu, stride, sc, members, q, lane);
    ++it;
    const bool same = sign_of(ft) == sign_of(fa);
    const float a2 = xt, fa2 = ft;
    const float b2 = same ? b : a, fb2 = same ? fb : fa;
    const float c2 = same ? a : b, fc2 = same ? fa : fb;
    take = fabsf(fa2) < fabsf(fb2);
    const float xm = take ? a2 : b2;
    const float fm = take ? fa2 : fb2;
    if (fabsf(fm) < fabsf(best_f)) {
      best_x = xm;
      best_f = fm;
    }
    const float tol =
        __fadd_rn(__fmul_rn(kTwoEps, fabsf(xm)), kPositionTolerance);
    float width = fabsf(b2 - a2);
    width = width < FLT_MIN ? FLT_MIN : width;  // torch.clamp(min=tiny)
    const float tlim = tol / width;
    if (fabsf(best_f) <= kValueTolerance || tlim > 0.5f) break;

    // Inverse quadratic interpolation when the iterate layout permits.
    const float xi = (a2 - b2) / (c2 == b2 ? 1.0f : c2 - b2);
    const float phi = (fa2 - fb2) / (fc2 == fb2 ? 1.0f : fc2 - fb2);
    const float one_phi = 1.0f - phi;
    const bool iqi_ok = __fmul_rn(phi, phi) < xi &&
                        __fmul_rn(one_phi, one_phi) < 1.0f - xi &&
                        c2 != b2 && fc2 != fb2 && fb2 != fa2 && fc2 != fa2;
    const float t_iqi = __fadd_rn(
        __fmul_rn(fa2 / safe(fb2 - fa2), fc2 / safe(fb2 - fc2)),
        __fmul_rn(__fmul_rn((c2 - a2) / safe(b2 - a2),
                            fa2 / safe(fc2 - fa2)),
                  fb2 / safe(fc2 - fb2)));
    t = iqi_ok ? t_iqi : 0.5f;
    // torch.clamp(t, min=tlim, max=1 - tlim): 1 - tlim where tlim passes
    // it; NaN stays NaN.
    if (!isnan(t)) t = fminf(fmaxf(t, tlim), 1.0f - tlim);
    a = a2;
    b = b2;
    fa = fa2;
    fb = fb2;
  }
  *iterations = it;
  return best_x;
}

// Grid: one block a tile of `tile_rows` rows. out (num_q, out_ld): the
// roots; most (num_q) or null: the most iterations a row ran, per quantile;
// total (num_q) or null: the iterations summed over the rows, per quantile.
__global__ void __launch_bounds__(kThreads)
    mixture_quantile_kernel(const float* __restrict__ means, int64_t ld,
                            const float* __restrict__ scales,
                            const float* __restrict__ min_mean,
                            const float* __restrict__ max_mean,
                            const float* __restrict__ max_scale,
                            Quantiles qs, int num_q, float* __restrict__ out,
                            int64_t out_ld, int* __restrict__ most,
                            unsigned long long* __restrict__ total,
                            int members, int rows, int tile_rows, int staged) {
  extern __shared__ float smem[];
  __shared__ int block_most[kMaxQuantiles];
  __shared__ unsigned long long block_total[kMaxQuantiles];
  const int row0 = blockIdx.x * tile_rows;
  const int tile = min(tile_rows, rows - row0);
  const float* mu;
  int64_t stride;
  const float* sc;
  if (staged) {
    const int pitch = tile_rows + 1;
    float* s_mu = smem;
    float* s_sc = smem + static_cast<int64_t>(members) * pitch;
    for (int i = threadIdx.x; i < members * tile_rows; i += kThreads) {
      const int k = i / tile_rows, r = i % tile_rows;
      s_mu[k * pitch + r] =
          r < tile ? means[k * ld + row0 + r] : 0.0f;
    }
    for (int k = threadIdx.x; k < members; k += kThreads) s_sc[k] = scales[k];
    mu = s_mu;
    stride = pitch;
    sc = s_sc;
  } else {
    mu = means + row0;
    stride = ld;
    sc = scales;
  }
  if (threadIdx.x < kMaxQuantiles) {
    block_most[threadIdx.x] = 0;
    block_total[threadIdx.x] = 0;
  }
  __syncthreads();

  const float spread = __fmul_rn(5.0f, *max_scale);
  const float low = *min_mean - spread;
  const float high = *max_mean + spread;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int task = warp; task < tile * num_q; task += kWarps) {
    const int r = task % tile, j = task / tile;
    int iterations;
    const float root = search_row(mu + r, stride, sc, members, qs.q[j], low,
                                  high, lane, &iterations);
    if (lane == 0) {
      out[j * out_ld + row0 + r] = root;
      if (most != nullptr) atomicMax(&block_most[j], iterations);
      if (total != nullptr) {
        atomicAdd(&block_total[j], static_cast<unsigned long long>(iterations));
      }
    }
  }
  if (most != nullptr || total != nullptr) {
    __syncthreads();
    if (threadIdx.x < num_q) {
      if (most != nullptr) {
        atomicMax(&most[threadIdx.x], block_most[threadIdx.x]);
      }
      if (total != nullptr) {
        atomicAdd(&total[threadIdx.x], block_total[threadIdx.x]);
      }
    }
  }
}

// Rows a block stages for `members` members, and its dynamic shared memory;
// staged false where even kMinTileRows rows do not fit.
void plan(int members, int* tile_rows, size_t* smem_bytes, int* staged) {
  for (int rows = kMaxTileRows; rows >= kMinTileRows; rows /= 2) {
    const size_t bytes =
        (static_cast<size_t>(members) * (rows + 1) + members) * sizeof(float);
    if (bytes <= kSharedBudget) {
      *tile_rows = rows;
      *smem_bytes = bytes;
      *staged = 1;
      return;
    }
  }
  *tile_rows = kUnstagedTileRows;
  *smem_bytes = 0;
  *staged = 0;
}

}  // namespace

extern "C" {

// Roots of `num_q` <= 32 quantiles (host floats) for `rows` rows, in one
// launch on `stream`: means (members, ld) on the device, rows contiguous,
// the first `rows` of each searched; scales (members); min_mean, max_mean,
// max_scale device scalars; out (num_q, rows); most (num_q) ints and total
// (num_q) 64-bit ints, each or null, raised to the most iterations any row
// ran and by the iterations the rows ran, per quantile. Returns the CUDA
// error of the launch (cudaErrorInvalidValue past 32 quantiles), or 0.
int bnf_mixture_quantiles(const float* means, int64_t ld, const float* scales,
                          const float* min_mean, const float* max_mean,
                          const float* max_scale, const float* quantiles,
                          int num_q, float* out, int* most, int64_t* total,
                          int members, int rows, void* stream) {
  if (num_q > kMaxQuantiles) return static_cast<int>(cudaErrorInvalidValue);
  if (rows <= 0 || num_q <= 0) return 0;
  int tile_rows, staged;
  size_t smem_bytes;
  plan(members, &tile_rows, &smem_bytes, &staged);
  const int blocks = (rows + tile_rows - 1) / tile_rows;
  Quantiles qs{};
  for (int j = 0; j < num_q; ++j) qs.q[j] = quantiles[j];
  mixture_quantile_kernel<<<blocks, kThreads, smem_bytes,
                            static_cast<cudaStream_t>(stream)>>>(
      means, ld, scales, min_mean, max_mean, max_scale, qs, num_q, out, rows,
      most, reinterpret_cast<unsigned long long*>(total), members, rows,
      tile_rows, staged);
  return static_cast<int>(cudaGetLastError());
}

const char* bnf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
