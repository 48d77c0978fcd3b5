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
// float32 operands run on the CUDA cores (the tensor cores would round
// float32 operands to TF32, and the float32 policy is IEEE): the SIMT GEMM
// core of sgemm_sm90.cuh (128 x 128 tiles of 8 x 8 register tiles, a
// 4-stage ring of k16 stages, M tiles fastest), h K-major and transposed on
// its way into shared memory, W MN-major through cp.async; 4 x 430 tiles
// at the pipeline's shape. Its epilogue works on the thread's register
// tile: a thread holds 4 adjacent columns of each of its 8 rows twice (at
// 4 tx and 64 + 4 tx), i.e. half a byte; it thresholds them into a nibble,
// takes its neighbour's (tx ^ 1) with one xor shuffle, and the even thread
// of the pair stores the byte. The wrapper pads K and N to multiples of 8
// with zero weights and zero bias, as for bf16. Bound at the pipeline's
// shape: 57.7 GFLOP at the 67 TFLOP/s float32 peak, 0.86 ms, against 0.07
// ms for its 227 MB: operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "sgemm_sm90.cuh"

namespace {

// Threshold and pack the SIMT core's register tile (sgemm_sm90.cuh): the
// 4 columns 4 tx .. 4 tx + 3 (+ 64 h) of a row make the low (tx even) or
// high (tx odd) nibble of byte (n0 + 64 h) / 8 + tx / 2. N is a multiple of
// 8, so a nibble is in range or out of it as a whole.
struct EpiPackF32 {
  uint8_t* out;
  const float* bias;
  int M, N, out_cols;

  __device__ __forceinline__ void operator()(const float (&acc)[8][8], int m0,
                                             int n0, int ty, int tx, int) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + 64 * h + 4 * tx;
      const bool in = col < N;
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = in ? bias[col + j] : 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        unsigned int nib = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          nib |= static_cast<unsigned int>(in && acc[i][4 * h + j] + b[j] > 0.0f) << j;
        const unsigned int other = __shfl_xor_sync(0xffffffffu, nib, 1);
        const int row = m0 + gm2::sgemm::tile_row(i, ty);
        if ((tx & 1) == 0 && in && row < M)
          out[static_cast<int64_t>(row) * out_cols + col / 8] =
              static_cast<uint8_t>(nib | (other << 4));
      }
    }
  }
};

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

// float32 operands (the CUDA-core route): K and N multiples of 8, h, w and
// b 16-byte aligned. Returns the cudaError_t of the launch (0 =
// cudaSuccess). Launches on `stream`, does not synchronise and allocates
// nothing.
int gm2_decode_threshold_pack(const void* h, const void* w, const void* b,
                              void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EpiPackF32 epi{static_cast<uint8_t*>(out), static_cast<const float*>(b),
                       M, N, N / 8};
  // h (M, K) K-major, W (K, N) MN-major
  return gm2::sgemm::launch<true, false>(
      static_cast<const float*>(h), K, static_cast<const float*>(w), N,
      gm2::sgemm::shape(M, N, K, 1), epi, static_cast<cudaStream_t>(stream));
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
