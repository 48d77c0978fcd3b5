// gather_row_blocks for Hopper (sm_90a): out[i*B : (i+1)*B] = x[idx[i]*B : +B].
//
// Replaces the TPU kernel genome_minimizer_2_tpu/ops/pallas_kernels.py::
// gather_row_blocks (_gather_blocks_kernel, pallas_call at :204): the epoch
// shuffle, which permutes blocks of B consecutive rows of the training
// matrix. The Pallas kernel issued HBM->HBM DMAs with the indices in
// scalar prefetch, and B = 8 was forced by the TPU's (8, 128) HBM tiling.
// Here the block size is a parameter (B = 1 is the exact row permutation)
// and each row block is one contiguous run of B * row_bytes bytes.
//
// What bounds it on an H100: it moves bytes and does no arithmetic. At the
// training path's shape (4,608 rows x 55,040 bf16 genes, B = 8) it reads
// and writes 507 MB each, about 0.30 ms at 3.35 TB/s.
//
// Design: one CTA per output row block reads its source index once and
// copies the run with 16-byte vector loads and stores (consecutive threads
// on consecutive 16 bytes, so every warp access is coalesced), falling
// back to 4-byte or 1-byte words when the run or the pointers are not
// aligned to 16 bytes. An index outside [0, n_src_blocks) traps, so a bad
// permutation surfaces as a device error at the next synchronisation
// instead of reading outside x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

template <typename W>
__global__ void __launch_bounds__(THREADS)
gather_blocks_kernel(const W* __restrict__ x, const int64_t* __restrict__ idx,
                     W* __restrict__ out, int64_t words_per_block,
                     int64_t n_src_blocks) {
  const int64_t i = blockIdx.x;
  const int64_t src = idx[i];
  if (src < 0 || src >= n_src_blocks) __trap();
  const W* from = x + src * words_per_block;
  W* to = out + i * words_per_block;
  for (int64_t k = threadIdx.x; k < words_per_block; k += THREADS)
    to[k] = from[k];
}

template <typename W>
int launch(const void* x, const int64_t* idx, void* out, int64_t m,
           int64_t block_bytes, int64_t n_src_blocks, cudaStream_t stream) {
  const int64_t words = block_bytes / static_cast<int64_t>(sizeof(W));
  gather_blocks_kernel<W><<<static_cast<unsigned int>(m), THREADS, 0, stream>>>(
      static_cast<const W*>(x), idx, static_cast<W*>(out), words,
      n_src_blocks);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x: the source rows, n_src_blocks blocks of block_bytes bytes each
// (trailing rows that do not fill a block are never addressed); idx: m
// int64 block ordinals on the device; out: m * block_bytes bytes. Returns
// the cudaError_t of the launch; launches on `stream`, does not
// synchronise and allocates nothing.
int gm2_gather_row_blocks(const void* x, const void* idx, void* out, int64_t m,
                          int64_t block_bytes, int64_t n_src_blocks,
                          void* stream) {
  if (m <= 0 || block_bytes <= 0 || m > 0x7FFFFFFF)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) |
                          static_cast<uintptr_t>(block_bytes);
  if (align % 16 == 0)
    return launch<uint4>(x, ix, out, m, block_bytes, n_src_blocks, s);
  if (align % 4 == 0)
    return launch<uint32_t>(x, ix, out, m, block_bytes, n_src_blocks, s);
  return launch<uint8_t>(x, ix, out, m, block_bytes, n_src_blocks, s);
}

}  // extern "C"
