// Sample mode's two host counts over packed bitmask rows (8 genes a byte,
// little bit order), each one pass over the rows:
//
// - gm2_popcount_rows: set bits a row (genome sizes), by 64-bit word with
//   the hardware popcount, then the tail bytes of a width that is not a
//   multiple of 8, written straight into the int64 output;
// - gm2_count_essential: genes a row with any of their positions set, from
//   a table of (byte, mask, gene) entries sorted by byte, so that a row is
//   read front to back once; each thread ORs a row's bits into a per-gene
//   flag buffer of its own, then counts the flags that are set.
//
// Rows are read through a row stride, so row slices and column slices of a
// wider array need no copy. A call splits its rows into blocks that the
// calling thread and up to threads - 1 workers of a persistent pool take in
// turn. Idle workers sleep in the kernel (a futex wait) between calls;
// nothing spins. A call returns the number of threads that took part.
//
// Plain C interface, loaded with ctypes (sample/host_counts.py), which
// releases the GIL for the call. Built with g++ by ops/_build.py.

#include <limits.h>
#include <linux/futex.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/syscall.h>
#include <unistd.h>

#if defined(__x86_64__)
#define GM2_POPCNT __attribute__((target("popcnt")))
#else
#define GM2_POPCNT
#endif

namespace {

constexpr int kMaxWorkers = 63;  // the call word holds up to 255 helpers
constexpr int64_t kBlockRows = 16;
constexpr int64_t kLine = 64;

struct Job {
  void (*run)(const Job&, int64_t lo, int64_t hi, int slot);
  const uint8_t* data;
  int64_t rows, width, stride;
  int64_t* out;
  // gm2_count_essential only
  const int64_t* byte;
  const uint8_t* mask;
  const int32_t* gene;
  int64_t entries, genes;
  uint8_t* flags;  // a flag buffer for each thread, by slot
  int64_t flags_stride;  // whole cache lines apart: no line is shared
  // The row blocks in one contiguous part a thread: a thread takes its own
  // part's blocks first, so that with the same thread count both counts of
  // a chunk read a row on the same thread (from its core's cache), then
  // takes what is left of the others'.
  struct alignas(kLine) Part {
    int64_t next, end;
  } parts[kMaxWorkers + 1];
  int parts_used;
};

// Split the rows' blocks into `threads` parts.
void plan(Job& job, int threads) {
  const int64_t blocks = (job.rows + kBlockRows - 1) / kBlockRows;
  job.parts_used = threads;
  for (int p = 0; p < threads; ++p) {
    job.parts[p].next = blocks * p / threads;
    job.parts[p].end = blocks * (p + 1) / threads;
  }
}

// Take blocks, of the slot's own part first, until none is left.
void drain(Job& job, int slot) {
  for (int k = 0; k < job.parts_used; ++k) {
    Job::Part& part = job.parts[(slot + k) % job.parts_used];
    for (;;) {
      int64_t b = __atomic_fetch_add(&part.next, 1, __ATOMIC_RELAXED);
      if (b >= part.end) break;
      int64_t lo = b * kBlockRows;
      int64_t hi = lo + kBlockRows < job.rows ? lo + kBlockRows : job.rows;
      job.run(job, lo, hi, slot);
    }
  }
}

long futex(uint32_t* word, int op, uint32_t val) {
  return syscall(SYS_futex, word, op, val, nullptr, nullptr, 0);
}

// The pool: a call posts its helper count in a new `call` word and wakes
// every sleeping worker with one futex call; a worker whose slot is beyond
// the call's helpers goes back to sleep. The last helper done wakes the
// caller on `pending`. The word holds a call counter above the helper
// count (8 bits), so a worker reads both at once.
struct Pool {
  pthread_mutex_t call_mu;  // one call on the pool at a time
  uint32_t call;            // (calls posted << 8) | helpers of the last
  uint32_t pending;         // helpers still on the current call
  Job* job;
  int started;
};

Pool pool = {PTHREAD_MUTEX_INITIALIZER, 0, 0, nullptr, 0};
pthread_once_t atfork_once = PTHREAD_ONCE_INIT;

// A forked child has none of the parent's threads: start the pool afresh.
void reset_in_child() {
  pthread_mutex_init(&pool.call_mu, nullptr);
  pool.pending = 0;
  pool.started = 0;
}

void register_atfork() { pthread_atfork(nullptr, nullptr, reset_in_child); }

// `arg` carries the worker's slot and the call word when it was started.
void* worker_main(void* arg) {
  const uint64_t a = reinterpret_cast<uintptr_t>(arg);
  const uint32_t slot = static_cast<uint32_t>(a & 0xffffffffu);
  uint32_t seen = static_cast<uint32_t>(a >> 32);
  for (;;) {
    uint32_t w;
    while ((w = __atomic_load_n(&pool.call, __ATOMIC_ACQUIRE)) == seen)
      futex(&pool.call, FUTEX_WAIT_PRIVATE, seen);
    seen = w;
    if (slot > (w & 0xffu)) continue;
    drain(*pool.job, slot);
    if (__atomic_sub_fetch(&pool.pending, 1, __ATOMIC_ACQ_REL) == 0)
      futex(&pool.pending, FUTEX_WAKE_PRIVATE, 1);
  }
  return nullptr;
}

// Start workers up to `want` (under call_mu); returns how many there are.
int grow(int want) {
  while (pool.started < want) {
    const uint64_t arg = (static_cast<uint64_t>(pool.call) << 32) | (pool.started + 1);
    pthread_t tid;
    pthread_attr_t attr;
    pthread_attr_init(&attr);
    pthread_attr_setdetachstate(&attr, PTHREAD_CREATE_DETACHED);
    pthread_attr_setstacksize(&attr, 1 << 16);
    int rc = pthread_create(&tid, &attr, worker_main, reinterpret_cast<void*>(arg));
    pthread_attr_destroy(&attr);
    if (rc != 0) break;
    ++pool.started;
  }
  return pool.started;
}

// Run the job on the calling thread and up to threads - 1 workers (no
// more than it has blocks); returns the threads that took part.
int run(Job& job, int threads) {
  int64_t helpers = threads - 1;
  const int64_t blocks = (job.rows + kBlockRows - 1) / kBlockRows;
  if (helpers > blocks - 1) helpers = blocks - 1;
  if (helpers > kMaxWorkers) helpers = kMaxWorkers;
  if (helpers <= 0) {
    plan(job, 1);
    drain(job, 0);
    return 1;
  }
  pthread_once(&atfork_once, register_atfork);
  pthread_mutex_lock(&pool.call_mu);
  int n = grow(static_cast<int>(helpers));
  if (n > helpers) n = static_cast<int>(helpers);
  plan(job, n + 1);
  pool.job = &job;
  __atomic_store_n(&pool.pending, static_cast<uint32_t>(n), __ATOMIC_RELAXED);
  __atomic_store_n(&pool.call, ((pool.call >> 8) + 1) << 8 | static_cast<uint32_t>(n),
                   __ATOMIC_RELEASE);
  futex(&pool.call, FUTEX_WAKE_PRIVATE, INT_MAX);
  drain(job, 0);
  uint32_t p;
  while ((p = __atomic_load_n(&pool.pending, __ATOMIC_ACQUIRE)) != 0)
    futex(&pool.pending, FUTEX_WAIT_PRIVATE, p);
  pthread_mutex_unlock(&pool.call_mu);
  return n + 1;
}

GM2_POPCNT void popcount_block(const Job& job, int64_t lo, int64_t hi, int) {
  const int64_t words = job.width / 8;
  for (int64_t r = lo; r < hi; ++r) {
    const uint8_t* row = job.data + r * job.stride;
    uint64_t c0 = 0, c1 = 0, c2 = 0, c3 = 0;
    int64_t w = 0;
    for (; w + 4 <= words; w += 4) {
      uint64_t x[4];
      memcpy(x, row + 8 * w, sizeof x);
      c0 += __builtin_popcountll(x[0]);
      c1 += __builtin_popcountll(x[1]);
      c2 += __builtin_popcountll(x[2]);
      c3 += __builtin_popcountll(x[3]);
    }
    for (; w < words; ++w) {
      uint64_t x;
      memcpy(&x, row + 8 * w, sizeof x);
      c0 += __builtin_popcountll(x);
    }
    for (int64_t b = 8 * words; b < job.width; ++b) c1 += __builtin_popcount(row[b]);
    job.out[r] = static_cast<int64_t>(c0 + c1 + c2 + c3);
  }
}

void essential_block(const Job& job, int64_t lo, int64_t hi, int slot) {
  uint8_t* flags = job.flags + slot * job.flags_stride;
  for (int64_t r = lo; r < hi; ++r) {
    const uint8_t* row = job.data + r * job.stride;
    memset(flags, 0, job.genes);
    for (int64_t e = 0; e < job.entries; ++e) {
      int64_t b = job.byte[e];
      flags[job.gene[e]] |= row[b < 0 ? b + job.width : b] & job.mask[e];
    }
    int64_t n = 0;
    for (int64_t g = 0; g < job.genes; ++g) n += flags[g] != 0;
    job.out[r] = n;
  }
}

}  // namespace

extern "C" {

// Set bits of each of `rows` rows of `width` bytes, `stride` bytes apart,
// into out[rows]. Returns the threads used.
int gm2_popcount_rows(const uint8_t* data, int64_t rows, int64_t width,
                      int64_t stride, int64_t* out, int threads) {
  Job job{};
  job.run = popcount_block;
  job.data = data;
  job.rows = rows;
  job.width = width;
  job.stride = stride;
  job.out = out;
  return run(job, threads);
}

// Genes with a set position in each of `rows` rows of `width` bytes:
// entry e ORs (row[byte[e]] & mask[e]) into gene[e]'s flag (a negative
// byte counts from the row's end, as numpy indexes). Entries sorted by
// byte read each row in address order. Returns the threads used, or -1
// with no memory.
int gm2_count_essential(const uint8_t* data, int64_t rows, int64_t width,
                        int64_t stride, const int64_t* byte,
                        const uint8_t* mask, const int32_t* gene,
                        int64_t entries, int64_t genes, int64_t* out,
                        int threads) {
  if (threads < 1) threads = 1;
  if (threads > kMaxWorkers + 1) threads = kMaxWorkers + 1;
  Job job{};
  job.run = essential_block;
  job.data = data;
  job.rows = rows;
  job.width = width;
  job.stride = stride;
  job.out = out;
  job.byte = byte;
  job.mask = mask;
  job.gene = gene;
  job.entries = entries;
  job.genes = genes;
  job.flags_stride = (genes + kLine - 1) / kLine * kLine + kLine;
  job.flags = static_cast<uint8_t*>(aligned_alloc(kLine, threads * job.flags_stride));
  if (job.flags == nullptr) return -1;
  int used = run(job, threads);
  free(job.flags);
  return used;
}

}  // extern "C"
