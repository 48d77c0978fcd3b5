// weight_grad_bf16 for Hopper (sm_90a): the weight gradient of the bf16
// policy's product in one launch.
//
// The product y = x W (models/vae.py::_BF16Matmul: x (B, D) and W (D, N)
// rounded to bf16, float32 sums) has the weight gradient that JAX's
// transpose of its product gives: the float32 cotangent g (B, N) split into
// two bf16 terms, hi = bf16(g) and lo = bf16(g - hi), each multiplied by the
// bf16 x^T, the float32 sum rounded to bf16:
//
//   dW = round_bf16(x^T hi + x^T lo)     (D, N), stored as float32
//
// (ops/kernels.py::weight_grad_bf16_reference). Here the split is made in
// shared memory, each term goes through the tensor cores into an
// accumulator of its own, and the epilogue adds the two in float32, rounds
// each value and stores it once, as the plain version adds its two
// products. One accumulator for both terms would not do: the tensor cores
// align each k16 step's products to the accumulator's exponent and cut the
// bits below it, so the lo products, 2^-8 of the hi sum, lose their low
// bits, and the loss grows with the batch (on an H100 at 2,048 rows x
// 27,520 x 1,024: 32,576 values off the exact rounding, up to 87,192 ulps
// where the sum cancels, against 188 and 24 for the plain version).
//
// What bounds it on an H100: at the training cells' input layer (B = 32,
// D = 55,040, N = 1,024) the products are 2 x 2BDN = 7.2 GFLOP, 7.3 us at
// the bf16 tensor-core peak, against a 225 MB float32 result written once
// (67 us at 3.35 TB/s) and 3.7 MB read: the stores. So the kernel is built
// around keeping the stores going:
// - Persistent: one block an SM, each taking a contiguous range of
//   128 x 128 output tiles, the D tiles fastest, so a block's tiles share
//   one or two N strips and the split of g is made once a strip.
// - Two warpgroups, each owning 64 rows of a tile: per k block of 32 batch
//   rows, four wgmma m64n128k16 steps (x rows 0-15 and 16-31 against hi into
//   the hi accumulator, then against lo into the lo accumulator; 64 + 64
//   registers a thread). The next tile's x block (32 x 128 bf16) is fetched by
//   cp.async, and a new strip's g block split, while the products run; the
//   epilogue of one tile drains while the next tile's products run.
// - Operands MN-major in 128-byte-swizzled shared memory, laid out as TMA's
//   SWIZZLE_128B would lay them (gemm_sm90.cuh's descriptors): 64-wide boxes
//   of 32 K rows of 128 bytes, 4 KB apart (LBO), 8-row atoms (SBO), a k16
//   step 16 rows = 2,048 bytes on. Rows past B and columns past D or N are
//   zero-filled, so a ragged batch, D or N needs no mask in the products.
// - The epilogue adds the two accumulators, rounds each sum to bf16 and
//   stores it as float32. Where a block has more than one tile (the input layer), through shared
//   memory, so that each warp stores whole 512-byte row segments and the
//   stores stream; where each block has one tile (the hidden layers, the
//   heads), straight from the accumulator fragments (float2 stores, each a
//   full 32-byte sector), which spares that tile the staging's latency.
//
// The launch is on the caller's stream; nothing synchronises or allocates,
// so a CUDA graph captures it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace gm2 {
namespace wgrad {

constexpr int TM = 128;                     // output rows (of D) a tile
constexpr int TN = 128;                     // output columns (of N) a tile
constexpr int KB = 32;                      // batch rows a k block
constexpr int THREADS = 256;                // two warpgroups, 64 rows each
constexpr uint32_t BOX = KB * 128;          // a 64-wide box of KB rows: 4 KB
constexpr uint32_t A_BYTES = TM / 64 * BOX;  // an x block: 8 KB
constexpr uint32_t B_BYTES = TN / 64 * BOX;  // a hi or a lo block: 16 KB
constexpr uint32_t K16_STEP = 16 * 128;     // 16 K rows
constexpr int STAGE_ROW = TN + 8;           // floats a staged row (no bank conflicts)
constexpr uint32_t STAGE_BYTES = 2 * 64 * STAGE_ROW * 4;
constexpr uint32_t OPERAND_BYTES = 2 * A_BYTES + 2 * 2 * B_BYTES;

constexpr uint32_t smem_bytes(bool staged) {
  return 1024 + OPERAND_BYTES + (staged ? STAGE_BYTES : 0);
}

struct Shape {
  int B, D, N;
  int m_tiles, n_tiles, k_blocks, tiles;
};

inline Shape shape(int B, int D, int N) {
  Shape s;
  s.B = B; s.D = D; s.N = N;
  s.m_tiles = (D + TM - 1) / TM;
  s.n_tiles = (N + TN - 1) / TN;
  s.k_blocks = (B + KB - 1) / KB;
  s.tiles = s.m_tiles * s.n_tiles;
  return s;
}

// Byte offset of element `col` (a multiple of 8) of K row `row` in a block
// of 64-wide boxes of KB rows with 128-byte swizzle.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  const int chunk = (col & 63) >> 3;
  return (col >> 6) * BOX + row * 128 + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// x rows [k0, k0 + KB), columns [m0, m0 + TM) into an x block (cp.async).
__device__ __forceinline__ void load_x(uint32_t dst, const __nv_bfloat16* x,
                                       const Shape& s, int k0, int m0) {
  for (int u = threadIdx.x; u < KB * TM / 8; u += THREADS) {
    const int row = u / (TM / 8), col = u % (TM / 8) * 8;
    const bool valid = k0 + row < s.B && m0 + col < s.D;
    const __nv_bfloat16* src =
        valid ? x + static_cast<int64_t>(k0 + row) * s.D + m0 + col : x;
    cp_async16(dst + swizzled(row, col), src, valid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// g rows [k0, k0 + KB), columns [n0, n0 + TN), split into its hi and lo
// blocks as ops/kernels.py::mm_f32_bf16 splits it. A thread reads its 8-value
// runs BATCH at a time, all loads of a batch before its first use, so their
// latencies overlap (before the loop, where the accumulators are not live,
// all at once).
template <int BATCH>
__device__ __forceinline__ void split_g(uint32_t hi, uint32_t lo, const float* g,
                                        const Shape& s, int k0, int n0) {
  constexpr int RUNS = KB * TN / 8 / THREADS;  // a thread's 8-value runs
  static_assert(RUNS % BATCH == 0, "whole batches");
#pragma unroll
  for (int b0 = 0; b0 < RUNS; b0 += BATCH) {
    float4 v[BATCH][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int u = threadIdx.x + (b0 + i) * THREADS;
      const int row = u / (TN / 8), col = u % (TN / 8) * 8;
      v[i][0] = v[i][1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (k0 + row < s.B && n0 + col < s.N) {
        const float4* p = reinterpret_cast<const float4*>(
            g + static_cast<int64_t>(k0 + row) * s.N + n0 + col);
        v[i][0] = __ldg(p);
        v[i][1] = __ldg(p + 1);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int u = threadIdx.x + (b0 + i) * THREADS;
      const int row = u / (TN / 8), col = u % (TN / 8) * 8;
      const float f[8] = {v[i][0].x, v[i][0].y, v[i][0].z, v[i][0].w,
                          v[i][1].x, v[i][1].y, v[i][1].z, v[i][1].w};
      __align__(16) __nv_bfloat16 hv[8], lv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        hv[j] = __float2bfloat16_rn(f[j]);
        lv[j] = __float2bfloat16_rn(f[j] - __bfloat162float(hv[j]));
      }
      st_shared16(hi + swizzled(row, col), *reinterpret_cast<const uint4*>(hv));
      st_shared16(lo + swizzled(row, col), *reinterpret_cast<const uint4*>(lv));
    }
  }
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products (gemm_sm90.cuh::fence_acc for TN columns).
__device__ __forceinline__ void fence_acc(float (&d)[TN / 2]) {
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128), bf16 from shared memory,
// both MN-major (gemm_sm90.cuh::wgmma_k16 at N = 128: 64 accumulators a
// thread).
__device__ __forceinline__ void wgmma_n128(float (&d)[TN / 2], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// The accumulator fragment of m64n128k16 (as gemm_sm90.cuh's m64n256k16):
// d[4j + 2h], d[4j + 2h + 1] at (row + 8h, 8j + 2q + {0, 1}) of the
// warpgroup's 64 x 128 block, row = 16 (t / 32) + (t % 32) / 4, q = t % 4.
// A warpgroup stores its first `rows` rows (of 64), from out row r0 on.
__device__ __forceinline__ void store_direct(const float (&d)[TN / 2], float* out,
                                             const Shape& s, int r0, int rows,
                                             int n0, int t128) {
  const int row = 16 * (t128 / 32) + (t128 % 32) / 4, q = t128 % 4;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    if (n0 + 8 * j >= s.N) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row + 8 * h >= rows) continue;
      *reinterpret_cast<float2*>(out + static_cast<int64_t>(r0 + row + 8 * h) * s.N +
                                 n0 + 8 * j + 2 * q) =
          make_float2(round_bf16(d[4 * j + 2 * h]), round_bf16(d[4 * j + 2 * h + 1]));
    }
  }
}

// The same values through the warpgroup's staging rows, then each warp
// stores 512 contiguous bytes of a row at a time.
__device__ __forceinline__ void store_staged(const float (&d)[TN / 2], float* stg,
                                             float* out, const Shape& s, int r0,
                                             int rows, int n0, int t128, int wg) {
  const int row = 16 * (t128 / 32) + (t128 % 32) / 4, q = t128 % 4;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float2*>(stg + (row + 8 * h) * STAGE_ROW + 8 * j + 2 * q) =
          make_float2(round_bf16(d[4 * j + 2 * h]), round_bf16(d[4 * j + 2 * h + 1]));
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  const int cols4 = min(TN, s.N - n0) / 4;
#pragma unroll 4
  for (int i = t128; i < 64 * (TN / 4); i += 128) {
    const int r = i / (TN / 4), c4 = i % (TN / 4);
    if (r < rows && c4 < cols4)
      *reinterpret_cast<float4*>(out + static_cast<int64_t>(r0 + r) * s.N + n0 + 4 * c4) =
          *reinterpret_cast<const float4*>(stg + r * STAGE_ROW + 4 * c4);
  }
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS, 1)
weight_grad_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ out, const Shape s) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t a_buf = base, b_buf = base + 2 * A_BYTES;
  const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
  float* stg = reinterpret_cast<float*>(smem_raw + (base - raw) + OPERAND_BYTES) +
               wg * 64 * STAGE_ROW;

  // this block's tiles, a contiguous range; a step is a tile's k block
  const int t0 = static_cast<int>(static_cast<int64_t>(s.tiles) * blockIdx.x / gridDim.x);
  const int t1 = static_cast<int>(static_cast<int64_t>(s.tiles) * (blockIdx.x + 1) / gridDim.x);
  const int steps = (t1 - t0) * s.k_blocks;
  auto coords = [&](int step, int& m0, int& n0, int& kb) {
    const int t = t0 + step / s.k_blocks;
    kb = step % s.k_blocks;
    m0 = t % s.m_tiles * TM;
    n0 = t / s.m_tiles * TN;
  };

  int m0, n0, kb;
  coords(0, m0, n0, kb);
  load_x(a_buf, x, s, 0, m0);
  split_g<KB * TN / 8 / THREADS>(b_buf, b_buf + B_BYTES, g, s, 0, n0);
  int bsel = 0;  // the hi / lo pair the current step reads
  float d[TN / 2], e[TN / 2];  // the hi and the lo accumulators
  for (int step = 0; step < steps; ++step) {
    // this step's blocks are in; every thread is done with the last step
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    coords(step, m0, n0, kb);
    if (kb == 0) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) d[i] = e[i] = 0.0f;
      fence_acc(d);
      fence_acc(e);
    }
    const uint32_t a = a_buf + (step & 1) * A_BYTES + wg * BOX;
    const uint32_t hi = b_buf + bsel * 2 * B_BYTES, lo = hi + B_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // x rows 0-15, 16-31 against hi, then lo
      const uint64_t da = smem_desc(a + kk * K16_STEP, BOX, SW_ATOM);
      wgmma_n128(d, da, smem_desc(hi + kk * K16_STEP, BOX, SW_ATOM));
      wgmma_n128(e, da, smem_desc(lo + kk * K16_STEP, BOX, SW_ATOM));
    }
    wgmma_commit();
    if (step + 1 < steps) {  // the next step's blocks, while the products run
      int m1, n1, kb1;
      coords(step + 1, m1, n1, kb1);
      load_x(a_buf + ((step + 1) & 1) * A_BYTES, x, s, kb1 * KB, m1);
      if (n1 != n0 || kb1 != kb) {
        bsel ^= 1;
        split_g<1>(b_buf + bsel * 2 * B_BYTES, b_buf + bsel * 2 * B_BYTES + B_BYTES, g,
                s, kb1 * KB, n1);
      }
    }
    wgmma_wait<0>();
    fence_acc(d);
    fence_acc(e);
    if (kb == s.k_blocks - 1) {
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) d[i] += e[i];
      const int r0 = m0 + 64 * wg, rows = min(64, s.D - r0);
      if (STAGED)
        store_staged(d, stg, out, s, r0, rows, n0, t128, wg);
      else
        store_direct(d, out, s, r0, rows, n0, t128);
    }
  }
}

template <bool STAGED>
int launch(const void* x, const void* g, void* out, const Shape& s, int grid,
           cudaStream_t stream) {
  auto kernel = weight_grad_kernel<STAGED>;
  static bool smem_set = false;
  if (!smem_set) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(STAGED)));
    if (err != 0) return err;
    smem_set = true;
  }
  kernel<<<grid, THREADS, smem_bytes(STAGED), stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(g),
      static_cast<float*>(out), s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgrad
}  // namespace gm2

extern "C" {

// x: (B, D) bf16, g: (B, N) float32, out: (D, N) float32, all row-major,
// contiguous and 16-byte aligned, D and N multiples of 8. Writes out =
// round_bf16(x^T hi + x^T lo) (float32 holding bf16 values). sms: the
// card's SM count (one block an SM, fewer where there are fewer tiles).
// The epilogue is staged where a block has more than one tile to store
// (the stores then stream), straight from the fragments where each block
// has one (its latency then counts). Returns the cudaError_t of the launch;
// launches on `stream`, does not synchronise and allocates nothing.
int gm2_weight_grad_bf16(const void* x, const void* g, void* out, int B, int D,
                         int N, int sms, void* stream) {
  if (B <= 0 || D <= 0 || N <= 0 || D % 8 != 0 || N % 8 != 0 || sms <= 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(g) |
       reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const gm2::wgrad::Shape s = gm2::wgrad::shape(B, D, N);
  const int grid = s.tiles < sms ? s.tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return s.tiles > grid ? gm2::wgrad::launch<true>(x, g, out, s, grid, st)
                        : gm2::wgrad::launch<false>(x, g, out, s, grid, st);
}

}  // extern "C"
