// The bf16 GEMM core of the port's tensor-core kernels, for Hopper (sm_90a):
// C (M, N) = A (M, K) B (K, N), bf16 operands, float32 accumulators, with an
// epilogue that the caller supplies (round and store; threshold and pack).
// Used by output_layer_bwd.cu (dh = dl W^T, dW = h^T dl) and
// decode_threshold_pack.cu ((h W + b) > 0).
//
// Design: a TMA + mbarrier ring of STAGES shared-memory stages feeding
// wgmma.mma_async m64n256k16 (f32 += bf16 x bf16).
// - One producer warp (one elected thread) issues the TMA loads of each
//   128 x 64 A tile and 64 x 256 B tile into a stage, with 128-byte swizzle,
//   and waits for the stage to be released before it refills it.
// - Two consumer warpgroups each own 64 rows of the 128 x 256 output tile:
//   four wgmma k16 steps per stage; the stage of the previous k block is
//   released once wgmma.wait_group 1 says its products are done, so one
//   group of products is always in flight while the next stage is waited
//   for.
// - Persistent: the grid is at most one block per SM and each block walks
//   output tiles t = blockIdx.x, blockIdx.x + gridDim.x, ... with the M tile
//   index fastest (the M tiles that share a B strip run together, so B is
//   read from device memory about once). The producer runs on into the
//   next tile while the consumers run the epilogue, so the next tile's
//   first stages are loaded by the time the epilogue ends.
// - Split K: a tile index also carries a K range (split s of `splits`), so
//   a product with few output tiles and a long K (dh) can fill the card;
//   the epilogue then writes float32 partials that a second pass sums in a
//   fixed order (no atomics).
//
// Operand majors. Each of A and B is K-major (K contiguous in memory) or
// MN-major (M resp. N contiguous); wgmma reads both from the swizzled
// tiles through its descriptors' layout and the instruction's transpose
// bits (bf16 allows either). The TMA box is 64 elements (128 bytes, the
// swizzle span) along the contiguous dimension:
// - K-major: one box of 64 (K) x 128 (A) or 256 (B) rows per stage: rows
//   of 128 bytes, 8-row swizzle atoms of 1024 bytes (descriptor SBO), a
//   k16 step moves the start address 32 bytes along the row.
// - MN-major: boxes of 64 (M or N) x 64 (K), 2 for A and 4 for B, 8 KB apart
//   (descriptor LBO, the stride between 64-wide MN chunks); each K row is
//   128 bytes, 8 K rows make a 1024-byte atom (SBO), a k16 step moves the
//   start address 16 rows = 2048 bytes.
// Global row strides must be multiples of 16 bytes (the wrappers pad K and
// N to multiples of 8); boxes beyond the matrix are zero-filled by TMA, so
// ragged M, N and K need no masks in the main loop, and the epilogues mask
// rows >= M and columns >= N.
//
// The TMA descriptors are encoded on the host with cuTensorMapEncodeTiled,
// a libcuda function looked up with cudaGetDriverEntryPointByVersion (the
// library links only the CUDA runtime), and passed by value as
// __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gm2 {

constexpr int BM = 128, BN = 256, BK = 64, STAGES = 4;
constexpr int CONSUMERS = 2;                        // warpgroups, 64 rows each
constexpr int THREADS = CONSUMERS * 128 + 32;       // + one producer warp
constexpr int BOX_BYTES = 64 * BK * 2;              // one 64-wide MN box: 8 KB
constexpr int A_BYTES = BM * BK * 2;                // 16 KB
constexpr int B_BYTES = BN * BK * 2;                // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr uint32_t SW_ATOM = 1024;                  // 8 rows of 128 bytes

// Output tiles, their K ranges and the grid.
struct GemmShape {
  int M, N, K;
  int m_tiles, n_tiles, k_blocks, kb_per_split, tiles;
};

inline GemmShape gemm_shape(int M, int N, int K, int splits) {
  GemmShape s;
  s.M = M; s.N = N; s.K = K;
  s.m_tiles = (M + BM - 1) / BM;
  s.n_tiles = (N + BN - 1) / BN;
  s.k_blocks = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > s.k_blocks) splits = s.k_blocks;
  s.kb_per_split = (s.k_blocks + splits - 1) / splits;
  splits = (s.k_blocks + s.kb_per_split - 1) / s.kb_per_split;
  s.tiles = s.m_tiles * s.n_tiles * splits;
  return s;
}

__device__ __forceinline__ void tile_coords(const GemmShape& s, int t, int& m0,
                                            int& n0, int& split, int& kb0,
                                            int& kb1) {
  const int mt = t % s.m_tiles, rest = t / s.m_tiles;
  m0 = mt * BM;
  n0 = (rest % s.n_tiles) * BN;
  split = rest / s.n_tiles;
  kb0 = split * s.kb_per_split;
  kb1 = min(kb0 + s.kb_per_split, s.k_blocks);
}

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
__device__ __forceinline__ void fence_acc(float (&d)[BN / 2]) {
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, f32) += A (64 x 16) B (16 x 256), bf16 from shared memory
// (128 accumulators a thread). TA / TB: 0 = K-major, 1 = MN-major.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_k16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The accumulator fragment of m64n256k16 (PTX ISA, wgmma D layout): thread
// t of the warpgroup holds, for each 8-column group j, d[4j], d[4j+1] at
// (row, 8j + 2q + {0, 1}) and d[4j+2], d[4j+3] at (row + 8, the same
// columns), with row = 16 (t / 32) + (t % 32) / 4 and q = t % 4. An
// epilogue is called once per tile and consumer warpgroup with the row of
// d[0] (rows + 0 and + 8 follow from it), the tile's first column, q and
// the K split.
template <bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_b, const GemmShape s,
            const Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t tiles = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t full = tiles + STAGES * STAGE_BYTES;  // STAGES barriers each
  const uint32_t empty = full + STAGES * 8;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS * 4) {
    // ---- producer: one thread issues every load ----
    if (threadIdx.x % 32 != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      int m0, n0, split, kb0, kb1;
      tile_coords(s, t, m0, n0, split, kb0, kb1);
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t a = tiles + stage * STAGE_BYTES, b = a + A_BYTES;
        const int k0 = kb * BK;
        if (A_MN) {
          for (int i = 0; i < BM / 64; ++i)
            tma_load(a + i * BOX_BYTES, &tma_a, m0 + 64 * i, k0, bar);
        } else {
          tma_load(a, &tma_a, k0, m0, bar);
        }
        if (B_MN) {
          for (int i = 0; i < BN / 64; ++i)
            tma_load(b + i * BOX_BYTES, &tma_b, n0 + 64 * i, k0, bar);
        } else {
          tma_load(b, &tma_b, k0, n0, bar);
        }
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    const int wg = warp / 4, t128 = threadIdx.x % 128;
    const int row_in_tile = 64 * wg + 16 * (t128 / 32) + (t128 % 32) / 4;
    const int q = t128 % 4;
    // A K-major: the warpgroup's 64 rows start 64 x 128 bytes into the
    // tile; A MN-major: its 64 M values are box wg. Both 8 KB.
    const uint32_t a_off = wg * BOX_BYTES;
    constexpr uint32_t A_STEP = A_MN ? 16 * 128 : 32;  // bytes per k16 step
    constexpr uint32_t B_STEP = B_MN ? 16 * 128 : 32;
    constexpr uint32_t A_LBO = A_MN ? BOX_BYTES : 16;
    constexpr uint32_t B_LBO = B_MN ? BOX_BYTES : 16;
    int stage = 0;
    uint32_t phase = 0;
    float d[BN / 2];
    for (int t = blockIdx.x; t < s.tiles; t += gridDim.x) {
      int m0, n0, split, kb0, kb1;
      tile_coords(s, t, m0, n0, split, kb0, kb1);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) d[i] = 0.0f;
      fence_acc(d);
      int prev = -1;
      for (int kb = kb0; kb < kb1; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = tiles + stage * STAGE_BYTES + a_off;
        const uint32_t b = tiles + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_k16<A_MN, B_MN>(d, smem_desc(a + kk * A_STEP, A_LBO, SW_ATOM),
                                smem_desc(b + kk * B_STEP, B_LBO, SW_ATOM));
        wgmma_commit();
        wgmma_wait<1>();  // the previous k block's products are done
        if (prev >= 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (prev >= 0) mbar_arrive(empty + 8 * prev);
      epi(d, m0 + row_in_tile, n0, q, split);
    }
  }
}

// ---------------------------------------------------------------------------
// Epilogues
// ---------------------------------------------------------------------------

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// out[split][row][col] = d (float32), rounded to bf16 if `round`; rows >= M
// and columns >= N (N even) are not stored.
struct EpiStoreF32 {
  float* out;
  int M, N, ldc;
  int64_t split_stride;
  int round;

  __device__ __forceinline__ void operator()(const float (&d)[BN / 2], int row,
                                             int n0, int q, int split) const {
    float* base = out + split * split_stride;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= M) continue;
        float2 v = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
        if (round) { v.x = round_bf16(v.x); v.y = round_bf16(v.y); }
        *reinterpret_cast<float2*>(base + static_cast<int64_t>(r) * ldc + col) = v;
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 row-major matrix of `rows` x `cols` (cols contiguous, a
// multiple of 8) read in boxes of 64 x box_rows with 128-byte swizzle.
inline int tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols,
                      int box_rows) {
  EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr || cols % 8 != 0 ||
      reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// C = A B with A (M, K) and B (K, N) bf16, given as row-major matrices:
// a_mn ? A^T stored (K, M) : A stored (M, K); b_mn ? B stored (K, N) :
// B^T stored (N, K). `grid` blocks (at most one per SM), `splits` K splits.
template <bool A_MN, bool B_MN, class Epi>
int launch_gemm(const void* a, const void* b, int M, int N, int K, int splits,
                int grid, const Epi& epi, cudaStream_t stream) {
  CUtensorMap ta, tb;
  int err = A_MN ? tensor_map(&ta, a, K, M, 64) : tensor_map(&ta, a, M, K, 128);
  if (err == 0) err = B_MN ? tensor_map(&tb, b, K, N, 64) : tensor_map(&tb, b, N, K, BN);
  if (err != 0) return err;
  const GemmShape s = gemm_shape(M, N, K, splits);
  auto kernel = gemm_kernel<A_MN, B_MN, Epi>;
  static bool smem_set = false;
  if (!smem_set) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
    if (err != 0) return err;
    smem_set = true;
  }
  if (grid > s.tiles) grid = s.tiles;
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(ta, tb, s, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gm2
