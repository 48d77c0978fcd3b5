// decode_threshold_pack for Hopper (sm_90a): packed = pack8((h @ W + b) > 0).
//
// Replaces the TPU kernel genome_minimizer_2_tpu/ops/pallas_kernels.py::
// decode_threshold_pack (_dtp_kernel, pallas_call at :130). It computes the
// same function, not the same block structure: the Pallas body packs bits
// with a packing-matrix matmul on the MXU and stores int32 because Mosaic
// could not split lanes or cast to uint8. Here the epilogue thresholds the
// float32 accumulators, packs 8 columns into one byte (bit k = column
// 8c + k, little bit order) and stores the uint8 directly. The (M, N)
// logits never reach device memory; only the packed bytes are written.
//
// Shapes: h (M, K) and W (K, N) row-major in the operand type, b (N,)
// float32, out (M, ceil(N/8)) uint8. W is in the JAX (in, out) layout, so
// it is read with no transpose.
//
// What bounds it on an H100: at the pipeline's shape (M = 512, K = 1024,
// N = 55,040) one launch is 57.7 GFLOP against 113 MB of bf16 W, so the
// arithmetic (about 58 us at the bf16 tensor-core peak) outweighs the bytes
// (about 34 us at 3.35 TB/s).
//
// bf16 operands run on the tensor cores: the GEMM core of gemm_sm90.cuh
// (TMA ring + wgmma m64n256k16, persistent, M tiles fastest so the 4 M
// tiles of a 512-row chunk that share a strip of W run together and W is
// read from device memory about once), with h K-major and W MN-major (N
// contiguous). The epilogue works on the accumulator fragment: each thread
// holds 2 adjacent columns of each 8-column group for rows r and r + 8, so
// a byte's 8 bits lie in the 4 threads of a quad; each thread builds 4
// consecutive bytes in one word, the quad ORs its words together with two
// xor shuffles, and one thread of the quad stores the word.
// TMA needs row strides that are multiples of 16 bytes: the wrapper pads K
// and N to multiples of 8 (a bf16 row of N = 1,003 values is 2,006 bytes)
// with zero weights and zero bias, so padding columns pack as 0 (the
// threshold is strict), and the output width ceil(N/8) is unchanged.
//
// float32 operands keep the CUDA-core kernel below (the tensor cores would
// round float32 operands to TF32, and the float32 policy is IEEE): a
// shared-memory tiled GEMM, a 64 x 128 output tile per 256-thread block, K
// streamed through shared memory 32 at a time. Thread (ty, tx) of the
// 16 x 16 grid computes rows ty + 16 i (i < 4) and columns 8 tx .. 8 tx + 7
// of the tile, i.e. 4 output bytes. Ragged M, N and K are masked:
// out-of-range operands load as 0, columns >= N pack as 0 bits, rows >= M
// and bytes beyond the output width are not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int ROWS_PER_THREAD = BM / 16;  // 4

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__global__ void __launch_bounds__(THREADS)
dtp_kernel(const T* __restrict__ h, const T* __restrict__ w,
           const float* __restrict__ b, uint8_t* __restrict__ out, int M,
           int K, int N, int out_cols) {
  // As is stored k-major (transposed) so the inner loop reads a column of
  // the h tile with one broadcast per row; Bs keeps W's row-major layout.
  // As has one column of padding so the transposing stores do not all
  // land in one bank.
  __shared__ __align__(16) float As[BK][BM + 1];
  __shared__ __align__(16) float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[ROWS_PER_THREAD][8];
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // h tile: BM x BK, consecutive threads walk K (coalesced rows of h).
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[c][r] = (gm < M && gk < K)
                     ? to_float(h[static_cast<int64_t>(gm) * K + gk])
                     : 0.0f;
    }
    // W tile: BK x BN, consecutive threads walk N (coalesced rows of W).
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int gk = k0 + r, gn = n0 + c;
      Bs[r][c] = (gk < K && gn < N)
                     ? to_float(w[static_cast<int64_t>(gk) * N + gn])
                     : 0.0f;
    }
    __syncthreads();

#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[ROWS_PER_THREAD];
      float bv[8];
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i) a[i] = As[k][ty + 16 * i];
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8 + 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < ROWS_PER_THREAD; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, strict threshold, 8 -> 1 pack, one uint8 store per row.
  const int col0 = n0 + tx * 8;
  const int byte_col = col0 / 8;
  if (byte_col >= out_cols) return;
  float bias[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) bias[j] = (col0 + j < N) ? b[col0 + j] : 0.0f;
#pragma unroll
  for (int i = 0; i < ROWS_PER_THREAD; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= M) continue;
    unsigned int byte = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const bool bit = (col0 + j < N) && (acc[i][j] + bias[j] > 0.0f);
      byte |= static_cast<unsigned int>(bit) << j;
    }
    out[static_cast<int64_t>(gm) * out_cols + byte_col] =
        static_cast<uint8_t>(byte);
  }
}

template <typename T>
int launch(const void* h, const void* w, const void* b, void* out, int M,
           int K, int N, cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int out_cols = (N + 7) / 8;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  dtp_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const float*>(b), static_cast<uint8_t*>(out), M, K, N,
      out_cols);
  return static_cast<int>(cudaGetLastError());
}


// Threshold and pack the accumulator fragment (see gemm_sm90.cuh for its
// layout): bit 2q + e of byte j of row r is column 8j + 2q + e. Four
// consecutive bytes are built in one word per thread, ORed over the quad
// with two xor shuffles, and stored by one lane of the quad. N is a
// multiple of 8, so a column pair is in range or out of it as a whole.
struct EpiPack {
  uint8_t* out;
  const float* bias;
  int M, N, out_cols;

  __device__ __forceinline__ void store4(int row, int byte, unsigned int w) const {
    if (row >= M) return;
    const int64_t off = static_cast<int64_t>(row) * out_cols + byte;
    if (byte + 4 <= out_cols && off % 4 == 0) {
      *reinterpret_cast<unsigned int*>(out + off) = w;
    } else {
      for (int i = 0; i < 4 && byte + i < out_cols; ++i)
        out[off + i] = static_cast<uint8_t>(w >> (8 * i));
    }
  }

  __device__ __forceinline__ void operator()(const float (&d)[gm2::BN / 2],
                                             int row, int n0, int q, int) const {
#pragma unroll
    for (int t = 0; t < gm2::BN / 32; ++t) {
      unsigned int w0 = 0, w1 = 0;  // rows row and row + 8
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * t + jj, col = n0 + 8 * j + 2 * q, sh = 8 * jj + 2 * q;
        if (col < N) {
          const float2 b = *reinterpret_cast<const float2*>(bias + col);
          w0 |= (static_cast<unsigned int>(d[4 * j] + b.x > 0.0f) << sh) |
                (static_cast<unsigned int>(d[4 * j + 1] + b.y > 0.0f) << (sh + 1));
          w1 |= (static_cast<unsigned int>(d[4 * j + 2] + b.x > 0.0f) << sh) |
                (static_cast<unsigned int>(d[4 * j + 3] + b.y > 0.0f) << (sh + 1));
        }
      }
      w0 |= __shfl_xor_sync(0xffffffffu, w0, 1);
      w0 |= __shfl_xor_sync(0xffffffffu, w0, 2);
      w1 |= __shfl_xor_sync(0xffffffffu, w1, 1);
      w1 |= __shfl_xor_sync(0xffffffffu, w1, 2);
      if (q == (t & 3)) {
        const int byte = n0 / 8 + 4 * t;
        if (byte < out_cols) {
          store4(row, byte, w0);
          store4(row + 8, byte, w1);
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// float32 operands (the CUDA-core kernel). Returns the cudaError_t of the
// launch (0 = cudaSuccess). Launches on `stream`, does not synchronise and
// allocates nothing.
int gm2_decode_threshold_pack(const void* h, const void* w, const void* b,
                              void* out, int M, int K, int N, void* stream) {
  return launch<float>(h, w, b, out, M, K, N, static_cast<cudaStream_t>(stream));
}

// bf16 operands (the tensor-core route): K and N multiples of 8, h and w
// 16-byte aligned; grid: blocks of the product (the SM count).
int gm2_decode_threshold_pack_bf16(const void* h, const void* w, const void* b,
                                   void* out, int M, int K, int N, int grid,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EpiPack epi{static_cast<uint8_t*>(out), static_cast<const float*>(b), M,
                    N, (N + 7) / 8};
  return gm2::launch_gemm<false, true>(h, w, M, N, K, 1, grid, epi,
                                       static_cast<cudaStream_t>(stream));
}

const char* gm2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
