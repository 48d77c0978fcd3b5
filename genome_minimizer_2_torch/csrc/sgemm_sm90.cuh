// The float32 GEMM core of the port's CUDA-core kernels, for Hopper (sm_90a):
// C (M, N) = A (M, K) B (K, N), IEEE float32 operands and accumulators
// (fmaf on the CUDA cores: the tensor cores would round float32 operands to
// TF32), with an epilogue that the caller supplies (store; threshold and
// pack). Used by output_layer_bwd.cu (dh = dl W^T, dW = h^T dl) and
// decode_threshold_pack.cu ((h W + b) > 0), as gemm_sm90.cuh is the core
// of their bf16 routes.
//
// What bounds it on an H100: the 67 TFLOP/s of the CUDA cores. The
// products the port runs here do about 250 (the decode at (512, 1,024,
// 55,040)) and 340 (dW and dh at (2,048, 1,024, 55,040), with the dl pass)
// operations per byte they must move, far above the card's 20 float32
// operations per byte of device memory, so the design keeps the FMA pipes
// fed:
// - A 128 x 128 output tile per block of 256 threads; thread (ty, tx) of a
//   16 x 16 grid owns an 8 x 8 register tile: rows 4 ty .. 4 ty + 3 and
//   64 + 4 ty .. + 3, columns 4 tx .. 4 tx + 3 and 64 + 4 tx .. + 3. A warp
//   holds 4 x 8 threads of the grid. Each k step reads four float4 from
//   shared memory (two of A, two of B) for 64 FMAs; the fragments of step
//   k + 1 are read while step k computes.
// - K streams through dynamic shared memory in tiles of BK = 16, loaded
//   STAGES - 1 = 3 tiles ahead of the compute, with one __syncthreads a
//   tile. 64 KB a block (96 KB with both operands K-major): two blocks fit
//   an SM.
// - Both operands are computed from k-major stages, [k][128 rows or
//   columns], so the compute loop reads float4 along M and N. Each operand
//   gets there by one of three routes (Route):
//   * MN-major (M resp. N contiguous in memory; the decode's W, dW's h and
//     dl) has that layout already: 16-byte cp.async copies straight into a
//     ring of STAGES stages, one warp a 512-byte row of the tile,
//     zero-filled beyond the matrix.
//   * K-major (K contiguous; the decode's h) beside an MN-major operand:
//     each thread loads two float4 along K into registers (4 neighbouring
//     threads read 64 contiguous bytes of a row) and stores their values
//     into the tile's k-major stage once the current tile is computed.
//   * Both operands K-major (dh's dl and W): the 16 staging registers of
//     two operands do not fit beside the 64 accumulators in the 128 that
//     hold two blocks an SM, so each operand is copied as it lies into a
//     ring of STAGES raw stages, and transposed into one of two k-major
//     stages once the tile before it is computed. A thread moves exactly
//     the 2 x 4 values it copied, so the raw ring needs no barrier, and the
//     copies keep their 3-tile lead (registers could stage two operands
//     only half a tile ahead, too little to cover the loads). The decode's
//     h, which sits in L2, measured faster on registers than through the
//     raw ring.
//   The 4-float column chunk c of k row k of a transposed operand is
//   stored at chunk c ^ (2 ((k / 4) % 4)), which spreads a warp's 32 stores
//   over the 32 banks; the compute loop applies the same XOR to the chunk
//   it reads, and its float4 reads stay conflict-free (a quarter warp reads
//   8 distinct chunks of one 128-byte span, or one).
// - Split K: a tile index also carries a K range (split s of `splits`), so
//   a product with few output tiles and a long K (dh) fills the card; the
//   epilogue then writes float32 partials that a second pass sums in split
//   order (no atomics).
// - Tiles are numbered M tile fastest, so the blocks that share a strip of
//   B run side by side and B is read from device memory about once.
// The wrappers pad rows to multiples of 8 floats (16-byte cp.async and
// float4 sources), so a 4-float chunk lies wholly inside or outside the
// matrix; ragged M, N and K tiles load as 0 and the epilogues mask rows
// >= M and columns >= N. Offsets into the operands are 64-bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gm2 {
namespace sgemm {

constexpr int BM = 128, BN = 128, BK = 16, STAGES = 4, THREADS = 256;
constexpr int MIN_BLOCKS = 2;   // blocks an SM should hold
constexpr int TILE = BK * 128;  // floats of one operand's stage: 8 KB

// Output tiles, their K ranges and the grid.
struct Shape {
  int M, N, K;
  int m_tiles, n_tiles, k_tiles, kt_per_split, splits, tiles;
};

inline Shape shape(int M, int N, int K, int splits) {
  Shape s;
  s.M = M; s.N = N; s.K = K;
  s.m_tiles = (M + BM - 1) / BM;
  s.n_tiles = (N + BN - 1) / BN;
  s.k_tiles = (K + BK - 1) / BK;
  if (splits < 1) splits = 1;
  if (splits > s.k_tiles) splits = s.k_tiles > 0 ? s.k_tiles : 1;
  s.kt_per_split = (s.k_tiles + splits - 1) / splits;
  s.splits = s.kt_per_split > 0 ? (s.k_tiles + s.kt_per_split - 1) / s.kt_per_split : 1;
  s.tiles = s.m_tiles * s.n_tiles * s.splits;
  return s;
}

// Row i of the thread's register tile, as an offset in the block tile
// (column j likewise, with tx).
__device__ __forceinline__ int tile_row(int i, int ty) {
  return (i & 3) + (i >> 2) * 64 + ty * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The XOR a K-major operand's stage applies to the 4-float chunks of k row k.
__device__ __forceinline__ constexpr int chunk_xor(int k) {
  return ((k >> 2) & 3) << 1;
}

// How an operand reaches its k-major stages.
enum Route {
  MN_COPY,    // MN-major: cp.async straight into a ring of STAGES stages
  K_REGS,     // K-major, the other operand MN-major: through registers
  K_RAW_RING  // both K-major: through a ring of raw stages
};

// Loads of one operand's tiles into its region of shared memory, by the
// tile's index `idx` within the block's K range: fetch starts the loads of
// a tile, stash (K_REGS) stores the registers of the last fetch, transpose
// (K_RAW_RING) fills a k-major stage from a raw one, stage gives the
// k-major stage that the compute reads. MN-major: element (k, i) at
// p[k ld + i]; K-major: element (k, i) at p[i ld + k]. i runs over the
// block's 128 rows (A) or columns (B) from i0, up to `extent` (M or N).
template <Route R>
struct Loader;

template <>
struct Loader<MN_COPY> {
  static constexpr int FLOATS = STAGES * TILE;
  const float* p;
  int64_t ld;
  int i0, extent, K, tid;

  // Thread t copies chunk t % 32 of k rows t / 32 and t / 32 + 8.
  __device__ __forceinline__ void fetch(float* region, int idx, int kt) {
    float* stage = region + (idx % STAGES) * TILE;
    const int c = (tid % 32) * 4, gi = i0 + c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = tid / 32 + 8 * r, gk = kt * BK + k;
      const bool valid = gk < K && gi < extent;
      cp_async16(stage + k * 128 + c,
                 valid ? p + static_cast<int64_t>(gk) * ld + gi : p, valid);
    }
  }
  __device__ __forceinline__ void stash(float*, int) {}
  __device__ __forceinline__ void transpose(float*, int) {}
  __device__ __forceinline__ const float* stage(const float* region, int idx) const {
    return region + (idx % STAGES) * TILE;
  }
};

// Store the 4 values k = 4 cc .. 4 cc + 3 of row i of a K-major tile into
// a k-major stage: chunk i / 4 of k row k goes to chunk (i / 4) ^
// chunk_xor(k), the same XOR for all 4.
__device__ __forceinline__ void store_k_major(float* stage, int i, int cc,
                                              float4 v) {
  float* d = stage + 4 * cc * 128 + ((((i >> 2) ^ chunk_xor(4 * cc)) << 2) | (i & 3));
  d[0] = v.x;
  d[128] = v.y;
  d[256] = v.z;
  d[384] = v.w;
}

// Thread t moves the 4 values k = 4 (t % 4) .. + 3 of rows t / 4 and
// t / 4 + 64 (4 neighbouring threads: 64 contiguous bytes of a row).
template <>
struct Loader<K_REGS> {
  static constexpr int FLOATS = STAGES * TILE;
  const float* p;
  int64_t ld;
  int i0, extent, K, tid;
  float4 v[2];

  __device__ __forceinline__ void fetch(float*, int, int kt) {
    const int gk = kt * BK + 4 * (tid % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int gi = i0 + tid / 4 + 64 * r;
      v[r] = (gk < K && gi < extent)
                 ? __ldg(reinterpret_cast<const float4*>(
                       p + static_cast<int64_t>(gi) * ld + gk))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
  __device__ __forceinline__ void stash(float* region, int idx) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      store_k_major(region + (idx % STAGES) * TILE, tid / 4 + 64 * r, tid % 4, v[r]);
  }
  __device__ __forceinline__ void transpose(float*, int) {}
  __device__ __forceinline__ const float* stage(const float* region, int idx) const {
    return region + (idx % STAGES) * TILE;
  }
};

// A ring of STAGES raw stages [128][BK] that cp.async fills with the tile
// as it lies in memory, then two k-major stages. A thread transposes
// exactly the chunks it copied, so the raw ring needs only the thread's own
// cp.async.wait_group, no barrier.
template <>
struct Loader<K_RAW_RING> {
  static constexpr int FLOATS = (STAGES + 2) * TILE;
  const float* p;
  int64_t ld;
  int i0, extent, K, tid;

  __device__ __forceinline__ void fetch(float* region, int idx, int kt) {
    float* raw = region + (idx % STAGES) * TILE;
    const int c = 4 * (tid % 4), gk = kt * BK + c;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid / 4 + 64 * r, gi = i0 + i;
      const bool valid = gk < K && gi < extent;
      cp_async16(raw + i * BK + c,
                 valid ? p + static_cast<int64_t>(gi) * ld + gk : p, valid);
    }
  }
  __device__ __forceinline__ void stash(float*, int) {}
  __device__ __forceinline__ void transpose(float* region, int idx) {
    const float* raw = region + (idx % STAGES) * TILE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = tid / 4 + 64 * r;
      store_k_major(region + (STAGES + idx % 2) * TILE, i, tid % 4,
                    *reinterpret_cast<const float4*>(raw + i * BK + 4 * (tid % 4)));
    }
  }
  __device__ __forceinline__ const float* stage(const float* region, int idx) const {
    return region + (STAGES + idx % 2) * TILE;
  }
};

// The route of an operand, given whether it and the other are K-major.
template <bool K_MAJOR, bool OTHER_K_MAJOR>
constexpr Route route = !K_MAJOR ? MN_COPY : OTHER_K_MAJOR ? K_RAW_RING : K_REGS;

template <bool A_K, bool B_K>
constexpr int smem_bytes() {
  return (Loader<route<A_K, B_K>>::FLOATS + Loader<route<B_K, A_K>>::FLOATS) * 4;
}

// The 8 values of k row k that thread index t (ty for A, tx for B) uses.
template <bool SWIZZLED>
__device__ __forceinline__ void fragment(const float* stage, int k, int t,
                                         float (&f)[8]) {
  const int c = SWIZZLED ? (t ^ chunk_xor(k)) : t;
  const float4 lo = *reinterpret_cast<const float4*>(stage + k * 128 + c * 4);
  const float4 hi = *reinterpret_cast<const float4*>(stage + k * 128 + 64 + c * 4);
  f[0] = lo.x; f[1] = lo.y; f[2] = lo.z; f[3] = lo.w;
  f[4] = hi.x; f[5] = hi.y; f[6] = hi.z; f[7] = hi.w;
}

template <bool A_K, bool B_K>
__device__ __forceinline__ void compute_stage(const float* as, const float* bs,
                                              int ty, int tx,
                                              float (&acc)[8][8]) {
  float a[2][8], b[2][8];
  fragment<A_K>(as, 0, ty, a[0]);
  fragment<B_K>(bs, 0, tx, b[0]);
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    if (k + 1 < BK) {
      fragment<A_K>(as, k + 1, ty, a[(k + 1) & 1]);
      fragment<B_K>(bs, k + 1, tx, b[(k + 1) & 1]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[i][j] = fmaf(a[k & 1][i], b[k & 1][j], acc[i][j]);
  }
}

// A_K / B_K: whether A (M, K) / B (K, N) is K-major in memory. Epi is
// called as epi(acc, m0, n0, ty, tx, split) once the tile's K range is
// summed; acc[i][j] is C[m0 + tile_row(i, ty)][n0 + tile_row(j, tx)].
template <bool A_K, bool B_K, typename Epi>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sgemm_kernel(const float* __restrict__ A, int64_t lda,
             const float* __restrict__ B, int64_t ldb, Shape s, Epi epi) {
  extern __shared__ __align__(16) float smem[];
  using LA = Loader<route<A_K, B_K>>;
  using LB = Loader<route<B_K, A_K>>;
  float* ra = smem;               // A's region
  float* rb = smem + LA::FLOATS;  // B's region
  // (ty, tx) of the 16 x 16 thread grid: a warp holds 4 x 8 of it, a 32 x 64
  // part of the tile, so its fragments are 4 distinct float4 of A and 8 of B
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = (warp % 2) * 8 + lane % 8, ty = (warp / 2) * 4 + lane / 8;
  const int t = blockIdx.x, rest = t / s.m_tiles;
  const int m0 = (t % s.m_tiles) * BM, n0 = (rest % s.n_tiles) * BN;
  const int split = rest / s.n_tiles;
  const int kt0 = split * s.kt_per_split;
  const int n_kt = min(s.kt_per_split, s.k_tiles - kt0);
  LA la{A, lda, m0, s.M, s.K, tid};
  LB lb{B, ldb, n0, s.N, s.K, tid};
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  // Copies run STAGES - 1 tiles ahead, one commit group a tile (empty past
  // the end), so wait_group STAGES - 2 means: this thread's copies of every
  // tile but the newest STAGES - 2 have landed. Where no operand takes the
  // raw ring, the wait for tile it sits just before the barrier of
  // iteration it; with the raw ring, the wait for tile it + 1 comes before
  // its transpose at the end of iteration it (waiting there for the copies
  // of an operand that needs no transpose slows the kernel).
  constexpr bool raw = route<A_K, B_K> == K_RAW_RING || route<B_K, A_K> == K_RAW_RING;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_kt) {
      la.fetch(ra, i, kt0 + i);
      lb.fetch(rb, i, kt0 + i);
      la.stash(ra, i);
      lb.stash(rb, i);
    }
    cp_async_commit();
  }
  if (raw && n_kt > 0) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile 0
    la.transpose(ra, 0);
    lb.transpose(rb, 0);
  }
  for (int it = 0; it < n_kt; ++it) {
    if (!raw) cp_async_wait<STAGES - 2>();  // this thread's copies of tile it
    // tile it is in place (every thread's copies landed, the K-major ones
    // stored or transposed), and every thread is done with tile it - 1
    __syncthreads();
    const int next = it + STAGES - 1;
    if (next < n_kt) {
      la.fetch(ra, next, kt0 + next);
      lb.fetch(rb, next, kt0 + next);
    }
    cp_async_commit();
    compute_stage<A_K, B_K>(la.stage(ra, it), lb.stage(rb, it), ty, tx, acc);
    if (next < n_kt) {
      la.stash(ra, next);
      lb.stash(rb, next);
    }
    if (raw && it + 1 < n_kt) {
      cp_async_wait<STAGES - 2>();  // this thread's copies of tile it + 1
      la.transpose(ra, it + 1);
      lb.transpose(rb, it + 1);
    }
  }
  epi(acc, m0, n0, ty, tx, split);
}

// Store C (or split s's partial C at out + s * split_stride) as float32,
// row stride ldc; N a multiple of 4, out 16-byte aligned.
struct EpiStore {
  float* out;
  int M, N;
  int64_t ldc, split_stride;

  __device__ __forceinline__ void operator()(const float (&acc)[8][8], int m0,
                                             int n0, int ty, int tx,
                                             int split) const {
    float* base = out + split * split_stride;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + tile_row(i, ty);
      if (row >= M) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = n0 + h * 64 + tx * 4;
        if (col < N)
          *reinterpret_cast<float4*>(base + row * ldc + col) = make_float4(
              acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
};

template <bool A_K, bool B_K, typename Epi>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(sgemm_kernel<A_K, B_K, Epi>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<A_K, B_K>());
}

// Blocks of this product an SM holds at once (registers and shared memory).
template <bool A_K, bool B_K, typename Epi>
cudaError_t blocks_per_sm(int* n) {
  cudaError_t err = allow_smem<A_K, B_K, Epi>();
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      n, sgemm_kernel<A_K, B_K, Epi>, THREADS, smem_bytes<A_K, B_K>());
}

// One launch on `stream`: every output tile of every split, one block each.
template <bool A_K, bool B_K, typename Epi>
int launch(const float* a, int64_t lda, const float* b, int64_t ldb,
           const Shape& s, const Epi& epi, cudaStream_t stream) {
  cudaError_t err = allow_smem<A_K, B_K, Epi>();
  if (err != cudaSuccess) return static_cast<int>(err);
  sgemm_kernel<A_K, B_K, Epi><<<s.tiles, THREADS, smem_bytes<A_K, B_K>(), stream>>>(
      a, lda, b, ldb, s, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sgemm
}  // namespace gm2
