// A bf16 tensor-core GEMM core for Hopper (sm_90a), for the 'bf16' products
// of the training kernel (`fused_train.cu`): the hidden forwards, the
// backward's W dv products and the hidden weight gradients.
//
//   D(m, n) = sum_k A(m, k) * B(k, n),  m < M, k < K, n in the block's tile,
//
// with bf16 operands in device memory, exact products and fp32 sums in
// registers (wgmma m64n128k16.f32.bf16.bf16). Each operand is described by a
// 3-D TMA tensor map (inner dimension, outer dimension, member), so one map
// serves every member. An operand is K-major (inner = K, outer = M or N) or
// MN-major (inner = M or N, outer = K); wgmma's transpose bits take either
// layout of 16-bit operands from shared memory, so no operand is transposed
// in memory:
//
//   product            A                         B
//   forward            W_l (c, k), MN-major      lhs_l (k, n), MN-major
//   W dv               W_l (k, c), K-major       dv_l (c, n), MN-major
//   weight gradient    lhs_l (k, n), K-major     dv_l (c, n), K-major
//
// A block of two warpgroups owns a 128 x 128 output tile (blockIdx.x along M,
// blockIdx.y along N, blockIdx.z the member); warpgroup g owns M rows 64g ..
// 64g + 63 and holds them as one m64n128 accumulator (64 floats a thread).
// The maps' box is 64 x 64 elements (128 bytes along the inner dimension,
// the 128-byte swizzle), so a stage holds two boxes of A and two of B, 64
// reduction steps deep. Thread 0 keeps kTcStages stages in flight with TMA
// (`cp.async.bulk.tensor`), each completing on its own `mbarrier`; the
// warpgroups wait on the stage's barrier, issue four k16 wgmmas, keep one
// stage's group in flight, and a block barrier hands the stage they finished
// back to thread 0. One block per tile, two blocks an SM (kTcBlocksPerSm):
// no warp specialisation, no persistence, no clusters. TMA fills zeros past
// the maps' extents, so a ragged K or M needs no masking; a warpgroup whose
// rows all lie past M loads and computes nothing (F = 49 rows fill one
// 64-row warpgroup).
//
// Order. Each output is the fp32 accumulation of the k16 steps in k order
// within one block (no split-K, no atomics): a result does not depend on the
// other blocks, and two identical calls are bit-equal.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTcTile = 128;                       // output tile along M and N
constexpr int kTcBox = 64;                         // map box: 64 x 64 elements
constexpr int kTcK = kTcBox;                       // reduction depth per stage
constexpr int kTcStages = 3;                       // stages in flight
constexpr int kTcThreads = 256;                    // two warpgroups
constexpr int kTcBoxBytes = kTcBox * kTcBox * 2;   // 8 KB
constexpr int kTcStageBytes = 4 * kTcBoxBytes;     // A: two boxes, B: two
// Dynamic shared memory of a GEMM block: the stages (1024-byte aligned, as
// the 128-byte swizzle's 8-row atoms require), one mbarrier each, and the
// slack to align the base.
constexpr int kTcSmemBytes =
    kTcStages * kTcStageBytes + kTcStages * 8 + 1024;
// Blocks an SM: while one block runs its epilogue (fp32 loads and stores,
// no products) the other's products keep the tensor cores busy. Two fit
// in 228 KB of shared memory at 3 stages and in the register file at 128
// a thread, the 64 accumulators included, without spills.
constexpr int kTcBlocksPerSm = 2;
static_assert(kTcBlocksPerSm * kTcSmemBytes <= 227 * 1024,
              "the blocks' stages must fit in an SM's shared memory");

// Operand layouts (see the header).
enum TcMajor : int { kKMajor = 0, kMNMajor = 1 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of `map` at (c0, c1, c2) into shared `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_3d(const CUtensorMap* map,
                                            uint32_t dst, uint32_t bar, int c0,
                                            int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma's shared-memory matrix descriptor for the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout B128.
__device__ __forceinline__ uint64_t tc_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// The descriptor of k16 step j of an operand whose 64-deep stage starts at
// `base`: a K-major operand steps 32 bytes along its swizzled 128-byte rows
// (8-row atoms 1024 bytes apart); an MN-major one steps 16 rows of 128 bytes
// (8-row groups 1024 bytes apart, the second 64-wide box 8 KB on).
template <int kMajor>
__device__ __forceinline__ uint64_t tc_step_desc(uint32_t base, int j) {
  if constexpr (kMajor == kKMajor) {
    return tc_desc(base + 32 * j, 0, 1024);
  } else {
    return tc_desc(base + 2048 * j, kTcBoxBytes, 1024);
  }
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Pins the accumulator registers at this point of the program: the
// compiler may not move their reads or writes across it (wgmma writes them
// asynchronously, behind its wait).
__device__ __forceinline__ void fence_acc(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// d += A B for one m64n128k16 step, both operands in shared memory; kTA and
// kTB are the transpose bits (1: MN-major).
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, %67, %68, %69, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(1), "n"(1), "n"(kTA), "n"(kTB));
}

// The block's 128 x 128 tile of A B over K, into warpgroup g's accumulator
// `acc` (rows m0 + 64g ..); columns at N and past it are undefined. `smem`
// is the block's dynamic shared memory (kTcSmemBytes). Every thread of the
// block must call it.
template <int kAMajor, int kBMajor>
__device__ __forceinline__ void tc_mainloop(const CUtensorMap& map_a,
                                            const CUtensorMap& map_b, int m0,
                                            int n0, int e, int M, int N, int K,
                                            uint8_t* smem, float (&acc)[64]) {
  const int tid = threadIdx.x, wg = tid / 128;
  const uint32_t base = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t bars = base + kTcStages * kTcStageBytes;
  // The boxes of A and B that hold rows below M or columns below N; a
  // block always has the first of each. A box past the extents is not
  // loaded: its products would land only in outputs that are discarded.
  const int a_boxes = M - m0 > kTcBox ? 2 : 1;
  const int b_boxes = N - n0 > kTcBox ? 2 : 1;
  const bool active = m0 + kTcBox * wg < M;
  const uint32_t tx = (a_boxes + b_boxes) * kTcBoxBytes;
  const int nk = (K + kTcK - 1) / kTcK;

  auto stage_a = [&](int s) { return base + s * kTcStageBytes; };
  auto stage_b = [&](int s) { return stage_a(s) + 2 * kTcBoxBytes; };
  // Thread 0: the loads of reduction block t into its stage.
  auto issue = [&](int t) {
    const int s = t % kTcStages, k0 = t * kTcK;
    const uint32_t bar = bars + 8 * s;
    mbar_expect_tx(bar, tx);
    for (int i = 0; i < a_boxes; ++i) {
      const int mn = m0 + i * kTcBox;
      tma_load_3d(&map_a, stage_a(s) + i * kTcBoxBytes, bar,
                  kAMajor == kKMajor ? k0 : mn, kAMajor == kKMajor ? mn : k0,
                  e);
    }
    for (int i = 0; i < b_boxes; ++i) {
      const int mn = n0 + i * kTcBox;
      tma_load_3d(&map_b, stage_b(s) + i * kTcBoxBytes, bar,
                  kBMajor == kKMajor ? k0 : mn, kBMajor == kKMajor ? mn : k0,
                  e);
    }
  };

  if (tid == 0) {
    for (int s = 0; s < kTcStages; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int t = 0; t < nk && t < kTcStages; ++t) issue(t);
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_acc(acc);

  const uint32_t a_off = wg * kTcBoxBytes;  // this warpgroup's rows of A
  for (int t = 0; t < nk; ++t) {
    const int s = t % kTcStages;
    mbar_wait(bars + 8 * s, (t / kTcStages) & 1);
    if (active) {
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kTcK / 16; ++j) {
        wgmma_m64n128k16<kAMajor, kBMajor>(
            acc, tc_step_desc<kAMajor>(stage_a(s) + a_off, j),
            tc_step_desc<kBMajor>(stage_b(s), j));
      }
      wgmma_commit();
      // Block t - 1's products are done; block t's may still run.
      wgmma_wait<1>();
      fence_acc(acc);
    }
    // Every warpgroup is done with the stage of block t - 1.
    __syncthreads();
    if (tid == 0 && t >= 1 && t - 1 + kTcStages < nk) issue(t - 1 + kTcStages);
  }
  if (active) wgmma_wait<0>();
  fence_acc(acc);
}

// Hands each pair of neighbouring accumulator columns of the block's tile
// to `epi(m, n, v0, v1)` (v0 at column n, v1 at n + 1), for rows m < M, in a
// fixed order: wgmma's m64nN fragment gives thread (warp w, lane q) of
// warpgroup g rows 64g + 16w + q / 4 and that + 8, and in each 8-column
// group i the columns 8i + 2 (q % 4) and the one after.
template <typename Epilogue>
__device__ __forceinline__ void tc_epilogue(const float (&acc)[64], int m0,
                                            int n0, int M, Epilogue epi) {
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = m0 + 64 * (tid / 128) + 16 * ((tid & 127) / 32) + lane / 4;
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = row + 8 * h;
    if (m >= M) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      epi(m, col + 8 * i, acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// --- Host side.

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point
// query (no -lcuda); nullptr when libcuda has none.
inline PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of bf16 `base` with extents (inner, outer, members), `ld`
// elements between outer rows and `member_stride` between members, in
// 64 x 64 boxes with the 128-byte swizzle; zero fill past the extents.
// Returns false if libcuda refuses it (strides must be multiples of 16
// bytes, the base 16-byte aligned).
inline bool encode_tc_map(CUtensorMap* map, const void* base, uint64_t inner,
                          uint64_t outer, uint64_t members, uint64_t ld,
                          uint64_t member_stride) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {inner, outer, members};
  const cuuint64_t strides[2] = {ld * 2, member_stride * 2};
  const cuuint32_t box[3] = {kTcBox, kTcBox, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
