// gather_row_blocks for Hopper (sm_90a): out[i*B : (i+1)*B] = x[idx[i]*B : +B].
//
// Replaces the TPU kernel genome_minimizer_2_tpu/ops/pallas_kernels.py::
// gather_row_blocks (_gather_blocks_kernel, pallas_call at :204): the epoch
// shuffle, which permutes blocks of B consecutive rows of the training
// matrix. The Pallas kernel issued HBM->HBM DMAs with the indices in
// scalar prefetch, and B = 8 was forced by the TPU's (8, 128) HBM tiling.
// Here the block size is a parameter (B = 1 is the exact row permutation)
// and each row block is one contiguous run of block_bytes = B * row_bytes.
//
// What bounds it on an H100: it moves bytes and does no arithmetic. At the
// training path's shape (4,608 rows x 55,040 bf16 genes, B = 8) it reads
// and writes 507 MB each, about 0.30 ms at 3.35 TB/s.
//
// Design. The output is m runs of block_bytes; run i comes from source
// block idx[i]. One CTA per SM. The wrapper (ops/kernels.py::gather_split)
// deals the output's bytes out in rounds: round r gives CTA c the `chunk`
// bytes at (r * ctas + c) * chunk, and what is left after the full rounds
// is split evenly in units of the route's word, so the CTAs' byte counts
// differ by at most one word. All CTAs work on one round at a time: the
// bytes in flight form one sliding window, as in a plain copy, which the
// device memory serves faster than one stream per CTA through distant
// regions. A CTA cuts each of its pieces at run ends into chunks
// (ops/kernels.py::gather_chunks makes the same walk on the host).
// - Bulk route (x, out and block_bytes 16-byte aligned; chunk 32 KB): one
//   thread per CTA moves every chunk with the bulk async copy engine,
//   through a ring of STAGES shared-memory stages. The copy in,
//   cp.async.bulk global -> shared, completes on the stage's mbarrier
//   (expect_tx = the chunk's bytes); once it has, the same thread issues the
//   copy out, cp.async.bulk shared -> global, as one bulk group. LOOKAHEAD
//   copies in are kept in flight; before a stage is refilled,
//   cp.async.bulk.wait_group.read lets only the newest STAGES - LOOKAHEAD
//   copies out still read shared memory. No byte passes through registers.
// - Word route (anything else, e.g. bf16 rows of odd width): no full rounds
//   (one contiguous range a CTA), every thread copying WORD_UNROLL words of
//   16, 4 or 1 bytes in flight, consecutive threads on consecutive words.
// The wrapper picks the route by alignment; it is not a fallback.
// The index of a chunk's run is read one chunk ahead. An index outside
// [0, n_src_blocks) traps, so a bad permutation surfaces as a device error
// at the next synchronisation instead of reading outside x.

#include "gemm_sm90.cuh"  // smem_u32 and the mbarrier wrappers

namespace {

using gm2::mbar_expect_tx;
using gm2::mbar_init;
using gm2::mbar_wait;
using gm2::smem_u32;

constexpr int STAGES = 6, LOOKAHEAD = 4;  // bulk ring: stages, copies in in flight
constexpr int64_t MAX_CHUNK = 32 * 1024;  // bytes of one stage
constexpr int WORD_THREADS = 1024, WORD_UNROLL = 4;

__device__ __forceinline__ int64_t imin(int64_t a, int64_t b) { return a < b ? a : b; }

// The deal: `rounds` full rounds of `chunk` bytes a CTA, then CTA c's share
// of the rest, [rest(c), rest(c + 1)), in units of `unit` bytes.
struct Split {
  int64_t unit, chunk, rounds, per_cta, extra, ctas;
  __host__ __device__ __forceinline__ int64_t rest(int64_t c) const {
    return rounds * ctas * chunk + unit * (c * per_cta + (c < extra ? c : extra));
  }
};

// CTA c's chunks in order: [pos, pos + bytes()) lies in run `run`, at
// offset() within it.
struct Walk {
  Split sp;
  int64_t c, bb, piece, pos, end, run, run_end;
  __device__ __forceinline__ Walk(const Split& s, int64_t c_, int64_t bb_)
      : sp(s), c(c_), bb(bb_), piece(0) {
    enter();
  }
  // the bytes of `piece`: a full round's chunk, or (piece == rounds) the rest
  __device__ __forceinline__ void enter() {
    if (piece < sp.rounds) {
      pos = (piece * sp.ctas + c) * sp.chunk;
      end = pos + sp.chunk;
    } else {
      pos = sp.rest(c);
      end = sp.rest(c + 1);
    }
    run = pos / bb;
    run_end = (run + 1) * bb;
  }
  __device__ __forceinline__ bool done() const { return piece >= sp.rounds && pos >= end; }
  __device__ __forceinline__ int64_t bytes() const { return imin(run_end, end) - pos; }
  __device__ __forceinline__ int64_t offset() const { return pos - (run_end - bb); }
  __device__ __forceinline__ void next() {
    pos = imin(run_end, end);
    if (pos < end) {  // the piece goes on in the next run
      ++run;
      run_end += bb;
    } else if (piece < sp.rounds) {
      ++piece;
      enter();
    }
  }
};

// The source block of a chunk's run; traps outside [0, n_src).
__device__ __forceinline__ int64_t checked(int64_t block, int64_t n_src) {
  if (block < 0 || block >= n_src) __trap();
  return block;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int S, int L>
__global__ void __launch_bounds__(32, 1)
gather_bulk_kernel(const char* __restrict__ x, const int64_t* __restrict__ idx,
                   char* __restrict__ out, int64_t bb, int64_t n_src, Split split) {
  static_assert(L >= 1 && L < S, "a stage must be free to refill");
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[S];
  Walk in(split, blockIdx.x, bb), out_w = in;
  if (threadIdx.x != 0 || in.done()) return;
  const uint32_t ring0 = smem_u32(ring);
  const uint32_t stage_bytes = static_cast<uint32_t>(split.chunk);
  for (int s = 0; s < S; ++s) mbar_init(smem_u32(&full[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  int64_t loaded = 0, src = idx[in.run];
  auto load = [&]() {
    const int s = static_cast<int>(loaded % S);
    const uint32_t bytes = static_cast<uint32_t>(in.bytes());
    const uint32_t bar = smem_u32(&full[s]);
    const char* from = x + checked(src, n_src) * bb + in.offset();
    in.next();
    if (!in.done()) src = idx[in.run];  // in flight until the next load
    mbar_expect_tx(bar, bytes);
    bulk_load(ring0 + s * stage_bytes, from, bytes, bar);
    ++loaded;
  };
  while (loaded < L && !in.done()) load();
  for (int64_t t = 0; !out_w.done(); ++t) {
    const int s = static_cast<int>(t % S);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((t / S) & 1));
    // the stage was written by the async proxy; order it before the copy out
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    bulk_store(out + out_w.pos, ring0 + s * stage_bytes,
               static_cast<uint32_t>(out_w.bytes()));
    out_w.next();
    if (!in.done()) {
      // chunk t + L refills the stage of chunk t + L - S, whose copy out is
      // older than the newest S - L
      bulk_wait_read<S - L>();
      load();
    }
  }
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename W, int U>
__global__ void __launch_bounds__(WORD_THREADS)
gather_words_kernel(const char* __restrict__ x, const int64_t* __restrict__ idx,
                    char* __restrict__ out, int64_t bb, int64_t n_src, Split split) {
  Walk w(split, blockIdx.x, bb);
  if (w.done()) return;
  int64_t src = idx[w.run];
  while (!w.done()) {
    const W* from = reinterpret_cast<const W*>(x + checked(src, n_src) * bb + w.offset());
    W* to = reinterpret_cast<W*>(out + w.pos);
    const int64_t n = w.bytes() / static_cast<int64_t>(sizeof(W));
    w.next();
    if (!w.done()) src = idx[w.run];  // in flight while this chunk is copied
    for (int64_t k = threadIdx.x; k < n; k += WORD_THREADS * U) {
      W v[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u * WORD_THREADS < n) v[u] = from[k + u * WORD_THREADS];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (k + u * WORD_THREADS < n) to[k + u * WORD_THREADS] = v[u];
    }
  }
}

template <int S, int L>
int launch_bulk(const void* x, const int64_t* idx, void* out, int64_t bb, int64_t n_src,
                const Split& split, cudaStream_t stream) {
  const int smem = static_cast<int>(S * split.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      gather_bulk_kernel<S, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_bulk_kernel<S, L><<<static_cast<unsigned int>(split.ctas), 32, smem, stream>>>(
      static_cast<const char*>(x), idx, static_cast<char*>(out), bb, n_src, split);
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int U>
int launch_words(const void* x, const int64_t* idx, void* out, int64_t bb, int64_t n_src,
                 const Split& split, cudaStream_t stream) {
  gather_words_kernel<W, U>
      <<<static_cast<unsigned int>(split.ctas), WORD_THREADS, 0, stream>>>(
          static_cast<const char*>(x), idx, static_cast<char*>(out), bb, n_src, split);
  return static_cast<int>(cudaGetLastError());
}

// The deal must cover the m * block_bytes output bytes, in units of the
// route's word, and the route's alignment must hold.
bool valid(const void* x, const void* out, int64_t m, int64_t bb, const Split& sp) {
  if (m <= 0 || bb <= 0 || sp.ctas <= 0 || sp.ctas > 0x7FFFFFFF) return false;
  if (sp.unit != 16 && sp.unit != 4 && sp.unit != 1) return false;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(out) | static_cast<uintptr_t>(bb);
  if (align % sp.unit != 0) return false;
  if (sp.chunk <= 0 || sp.chunk % sp.unit != 0 || sp.rounds < 0) return false;
  if (sp.per_cta < 0 || sp.extra < 0 || sp.extra >= sp.ctas) return false;
  // the bulk route's pieces, the rest's included, must fit a ring stage
  const int64_t rest_max = sp.unit * (sp.per_cta + (sp.extra > 0 ? 1 : 0));
  if (sp.unit == 16 ? sp.chunk > MAX_CHUNK || rest_max > sp.chunk : sp.rounds != 0)
    return false;
  return sp.rest(sp.ctas) == m * bb;
}

}  // namespace

extern "C" {

// x: the source rows, n_src_blocks blocks of block_bytes bytes each
// (trailing rows that do not fill a block are never addressed); idx: m
// int64 block ordinals on the device; out: m * block_bytes bytes. word: 16
// takes the bulk route, 4 and 1 the word route; (ctas, chunk, rounds,
// per_cta, extra): the deal of ops/kernels.py::gather_split. Returns the
// cudaError_t of the launch; launches on `stream`, does not synchronise and
// allocates nothing.
int gm2_gather_row_blocks(const void* x, const void* idx, void* out, int64_t m,
                          int64_t block_bytes, int64_t n_src_blocks, int64_t word,
                          int64_t ctas, int64_t chunk, int64_t rounds, int64_t per_cta,
                          int64_t extra, void* stream) {
  const Split split{word, chunk, rounds, per_cta, extra, ctas};
  if (!valid(x, out, m, block_bytes, split))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  if (word == 16)
    return launch_bulk<STAGES, LOOKAHEAD>(x, ix, out, block_bytes, n_src_blocks, split, s);
  if (word == 4)
    return launch_words<uint32_t, WORD_UNROLL>(x, ix, out, block_bytes, n_src_blocks,
                                               split, s);
  return launch_words<uint8_t, WORD_UNROLL>(x, ix, out, block_bytes, n_src_blocks,
                                            split, s);
}

}  // extern "C"
