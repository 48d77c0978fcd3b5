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
// bf16 operands run on the tensor cores: the clustered GEMM core of
// gemm_cluster_sm90.cuh, h K-major and W MN-major (N contiguous), 128 x 256
// tiles in clusters of up to 4 CTAs along M that load each stage of W once,
// by TMA multicast (the plan's cm, by its fill rule: 2 at the pipeline's
// shape on an H100, whose GPCs hold 66 clusters of 2 but 30 of 4).
// K = 1,024 is only 16 k blocks a tile, so the epilogue, which stops the
// tensor cores, is a large share of a tile's time: with a first epilogue
// that read its bias from device memory between its shuffles and stored 4
// bytes a lane, about a third of the decode on an H100. This one reads the
// bias strip from shared memory, loaded there under the main loop, and
// stores the packed rows from shared memory as 16-byte words. It works on
// the accumulator fragment: each thread holds 2 adjacent columns of each
// 8-column group for rows r and r + 8, so a byte's 8 bits lie in the 4
// threads of a quad; each thread builds 4 consecutive bytes in one word
// and the quad ORs its words together with two xor shuffles.
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

#include "gemm_cluster_sm90.cuh"
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
// layout): bit 2q + e of byte j of row r is column 8j + 2q + e. The unit's
// bias strip (256 floats) is loaded into shared memory as the unit starts
// (one value a consumer thread, double-buffered by turn), so its latency
// hides under the main loop. Four consecutive bytes are built in one word
// per thread, ORed over the quad with two xor shuffles, and written by one
// lane of the quad into the warpgroup's 64 x 32-byte tile of packed rows
// in shared memory; then each thread stores 16 bytes of it (a 16-byte store
// where the row's bytes are 16-byte aligned, else byte by byte). N is a
// multiple of 8, so a column pair is in range or out of it as a whole.
struct EpiPack {
  static constexpr int SMEM = 2 * gm2::BN * 4 + 2 * 64 * 32;  // bias x 2, rows x 2
  uint8_t* out;
  const float* bias;
  int M, N, out_cols;

  __device__ __forceinline__ void begin(int n0, uint32_t smem, int turn) const {
    const int col = n0 + threadIdx.x;  // one of the 256 consumer threads
    const float b = col < N ? bias[col] : 0.0f;
    asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(smem + (turn & 1) * gm2::BN * 4 +
                                                      4 * threadIdx.x),
                 "f"(b)
                 : "memory");
  }

  __device__ __forceinline__ void operator()(const float (&d)[gm2::BN / 2], int row,
                                             int n0, int q, uint32_t smem,
                                             int turn) const {
    gm2::cl::named_barrier(1, gm2::CONSUMERS * 128);  // the unit's bias is in place
    const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
    const int r = 16 * (t128 / 32) + (t128 % 32) / 4;  // row - the warpgroup's first
    const uint32_t bias_s = smem + (turn & 1) * gm2::BN * 4;
    const uint32_t tile = smem + 2 * gm2::BN * 4 + wg * 64 * 32;
#pragma unroll
    for (int t = 0; t < gm2::BN / 32; ++t) {
      unsigned int w0 = 0, w1 = 0;  // rows r and r + 8
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * t + jj, col = n0 + 8 * j + 2 * q, sh = 8 * jj + 2 * q;
        float2 b;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(b.x), "=f"(b.y)
                     : "r"(bias_s + 4 * (8 * j + 2 * q)));
        if (col < N) {
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
        asm volatile(
            "st.shared.u32 [%0], %1;\n"
            "st.shared.u32 [%2], %3;\n" ::"r"(tile + r * 32 + 4 * t),
            "r"(w0), "r"(tile + (r + 8) * 32 + 4 * t), "r"(w1)
            : "memory");
      }
    }
    gm2::cl::named_barrier(2 + wg, 128);  // the warpgroup's packed rows are in place
    const int rr = t128 / 2, half = t128 % 2;
    const int grow = row - r + rr, byte = n0 / 8 + 16 * half;
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(tile + rr * 32 + 16 * half));
    if (grow < M && byte < out_cols) {
      const int64_t off = static_cast<int64_t>(grow) * out_cols + byte;
      if (byte + 16 <= out_cols && off % 16 == 0) {
        *reinterpret_cast<uint4*>(out + off) = v;
      } else {
        const uint8_t* bytes = reinterpret_cast<const uint8_t*>(&v);
        for (int i = 0; i < 16 && byte + i < out_cols; ++i) out[off + i] = bytes[i];
      }
    }
    gm2::cl::named_barrier(2 + wg, 128);  // read before the next unit's rows
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
// 16-byte aligned; cm: CTAs of a cluster, clusters: clusters of the
// persistent grid (ops/kernels.py::decode_plan).
int gm2_decode_threshold_pack_bf16(const void* h, const void* w, const void* b,
                                   void* out, int M, int K, int N, int cm,
                                   int clusters, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 != 0 || N % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const EpiPack epi{static_cast<uint8_t*>(out), static_cast<const float*>(b), M,
                    N, (N + 7) / 8};
  // h (M, K) K-major, W (K, N) MN-major
  return gm2::cl::launch_gemm(h, w, M, N, K, cm, clusters, epi,
                                           static_cast<cudaStream_t>(stream));
}

// Clusters of cm CTAs of the bf16 decode that the card holds at once.
int gm2_decode_threshold_pack_bf16_max_clusters(int cm, int* n) {
  return gm2::cl::max_clusters<EpiPack>(cm, n);
}

const char* gm2_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
