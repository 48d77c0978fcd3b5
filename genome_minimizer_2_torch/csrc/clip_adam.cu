// clip_adam for Hopper (sm_90a): the fused clip-by-global-norm + Adam +
// apply update of every parameter leaf of a training step, in place, in
// one launch.
//
// Replaces the TPU kernel tools/opt_microbench3.py::adam_pallas_loop
// (pallas_call at :74), which runs genome_minimizer_2_tpu/ops/optimizer.py::
// _adam_math (:46-55) on (rows, 1024) f32 blocks with the four scalars in
// SMEM. Same arithmetic, in the optax op order and with no contraction
// (every operation rounds once, through the __f*_rn intrinsics, so the
// plain PyTorch version gives the same bits):
//
//   g  = norm < max_norm ? g : (g / norm) * max_norm
//   m' = 0.1 * g + 0.9 * m            v' = 0.001 * (g * g) + 0.999 * v
//   p' = p + (-lr) * ((m' / bc1) / (sqrt(v' / bc2) + 1e-8))
//
// m and v are stored in float32 or bfloat16 (read and widened to float32,
// written back rounded to nearest even); g and p are float32. The scalars
// norm, bc1, bc2 and lr are read from device memory, so a training step
// never waits on the host for them.
//
// What bounds it on an H100: bytes. Per value it reads g, m, v, p and
// writes m, v, p: 20 bytes with bf16 moments, 28 with float32 ones; over
// the v0 model's 117.2 M parameters that is 0.70 / 0.98 ms at 3.35 TB/s.
// The work beside them: three IEEE divisions (four when clipping) and one
// IEEE square root a value, each a MUFU approximation (RCP, RSQ) refined
// by FFMAs with a range check (FCHK) before a slow path that normal
// operands never take, and 7 FMUL/FADD. In the sm_90a SASS of the
// float32-moment kernel (CUDA 12.8; chip_smoke.py::clip_adam_sass counts
// it) a value on the vector path takes 66.5 instructions without
// clipping, 29 of them FP32 (17 FFMA, 8 FMUL, 4 FADD), 4 MUFU and 3 FCHK;
// 82.1 with it (35 FP32, 5 MUFU). Over 117.2 M values that is 0.23 ms of
// an H100's dispatch rate, 0.10 ms of its FP32 rate and 0.11 ms of its MUFU
// rate (16 an SM a clock): a third of the byte time at bf16 moments.
//
// Design, for the bytes:
// - One launch a step over every leaf (up to MAX_LEAVES): a table of the
//   leaves' pointers, sizes, heads and first units is a kernel parameter,
//   passed by value (no copy from the host, so a CUDA graph records the
//   launch as it stands). The work is cut into units of UNIT = 8 values,
//   numbered over the leaves in order.
// - One block of 512 threads an SM. A warp takes tiles of 32 units (256
//   values), and the grid's warps sweep the units together, tile by tile
//   (warp w of the grid takes tiles w, w + warps, ...): every SM streams
//   from one moving front of each array, which kept an H100's DRAM busier
//   than giving each block its own contiguous range (more blocks or
//   threads an SM, or two tiles a warp in flight, did not help there).
// - In a tile on one leaf's vector path, lane l takes the 4 values at
//   256 t + 4 l and 256 t + 128 + 4 l: g and p as float4 loads, m and v
//   as float4 (float32) or 8-byte (bf16) loads, so each load and store of
//   the warp covers one contiguous span; all loads go out before any
//   arithmetic, then m, v and p are stored.
// - A leaf's vector path starts at its head, the first value at which all
//   four arrays are 16-byte aligned (a view at an odd offset has a head of
//   up to 7 values); a tile that is not wholly on one leaf's vector path
//   (at most two a leaf: its head, its tail, a leaf boundary) goes value
//   by value, each lane its unit, in the same launch. A leaf whose arrays
//   share no aligned value (head -1) is wholly on that path.
// The host's plan (ops/kernels.py::clip_adam_plan) and this kernel cut the
// leaves the same way; its tests run the plan on the CPU.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_LEAVES = 64;  // leaves a launch's table holds
constexpr int UNIT = 8;         // values a thread updates at a time
constexpr int TILE = 32;        // units a warp takes at a time
constexpr int ROW = 7;          // int64 words of a leaf in the host's table

struct Leaf {
  const float* g;
  void* m;
  void* v;
  float* p;
  int64_t n;      // values
  int64_t begin;  // the leaf's first unit in the launch
  int64_t head;   // values before the first aligned chunk; -1: no chunk
};

struct Table {
  Leaf leaf[MAX_LEAVES];
  int64_t units;  // all leaves' units
  int32_t count;  // leaves
};
// kernel parameters are limited to 4 KB
static_assert(sizeof(Table) + 16 <= 4096, "the leaf table is too large");

struct Consts {
  float norm, max_norm, bc1, bc2, neg_lr;
  bool clip;
};

__device__ __forceinline__ void adam(float g, float m, float v, float p,
                                     const Consts& c, float& mn, float& vn,
                                     float& pn) {
  if (c.clip) g = __fmul_rn(__fdiv_rn(g, c.norm), c.max_norm);
  mn = __fadd_rn(__fmul_rn(0.1f, g), __fmul_rn(0.9f, m));
  vn = __fadd_rn(__fmul_rn(0.001f, __fmul_rn(g, g)), __fmul_rn(0.999f, v));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c.bc2)), 1e-8f);
  const float update = __fdiv_rn(__fdiv_rn(mn, c.bc1), denom);
  pn = __fadd_rn(p, __fmul_rn(c.neg_lr, update));
}

// 4 values at an aligned address: 16 bytes of float, 8 of bf16 (the value
// at the lower address in the low half of a word)
__device__ __forceinline__ void load4(const float* a, float* x) {
  const float4 q = *reinterpret_cast<const float4*>(a);
  x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* a, float* x) {
  const uint2 w = *reinterpret_cast<const uint2*>(a);
  x[0] = __uint_as_float(w.x << 16);
  x[1] = __uint_as_float(w.x & 0xffff0000u);
  x[2] = __uint_as_float(w.y << 16);
  x[3] = __uint_as_float(w.y & 0xffff0000u);
}
__device__ __forceinline__ void store4(float* a, const float* x) {
  *reinterpret_cast<float4*>(a) = make_float4(x[0], x[1], x[2], x[3]);
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}
__device__ __forceinline__ void store4(__nv_bfloat16* a, const float* x) {
  *reinterpret_cast<uint2*>(a) =
      make_uint2(bf16_pair(x[0], x[1]), bf16_pair(x[2], x[3]));
}

__device__ __forceinline__ float load1(const float* a) { return *a; }
__device__ __forceinline__ float load1(const __nv_bfloat16* a) {
  return __bfloat162float(*a);
}
__device__ __forceinline__ void store1(float* a, float x) { *a = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* a, float x) {
  *a = __float2bfloat16_rn(x);
}

// a warp's tile of 256 values from value e on (every array 16-byte
// aligned there): lane l takes values e + 4l .. + 3 and e + 128 + 4l .. + 3
template <typename M>
__device__ __forceinline__ void warp_tile(const Leaf& leaf, int64_t e,
                                          int lane, const Consts& c) {
  float g[UNIT], m[UNIT], v[UNIT], p[UNIT];
  M* ms = static_cast<M*>(leaf.m);
  M* vs = static_cast<M*>(leaf.v);
  const int64_t e0 = e + 4 * lane, e1 = e0 + 128;
  load4(leaf.g + e0, g);
  load4(leaf.g + e1, g + 4);
  load4(ms + e0, m);
  load4(ms + e1, m + 4);
  load4(vs + e0, v);
  load4(vs + e1, v + 4);
  load4(leaf.p + e0, p);
  load4(leaf.p + e1, p + 4);
#pragma unroll
  for (int i = 0; i < UNIT; ++i) adam(g[i], m[i], v[i], p[i], c, m[i], v[i], p[i]);
  store4(ms + e0, m);
  store4(ms + e1, m + 4);
  store4(vs + e0, v);
  store4(vs + e1, v + 4);
  store4(leaf.p + e0, p);
  store4(leaf.p + e1, p + 4);
}

// unit `local` of the leaf, value by value: a chunk of its vector path
// (local < chunks), else scalar values k0 .. k0 + UNIT - 1 of its head and
// tail, the k-th being value k of the head or of the tail after the chunks
template <typename M>
__device__ __forceinline__ void unit_by_value(const Leaf& leaf, int64_t local,
                                              const Consts& c) {
  const int64_t chunks = leaf.head < 0 ? 0 : (leaf.n - leaf.head) / UNIT;
  const int64_t after = chunks * UNIT;  // from the head's end to the tail's
  M* m = static_cast<M*>(leaf.m);
  M* v = static_cast<M*>(leaf.v);
  int64_t first, count;
  if (local < chunks) {
    first = leaf.head + local * UNIT;
    count = UNIT;
  } else {
    first = (local - chunks) * UNIT;  // the scalar values' ordinal k
    count = leaf.n - after - first;
    if (count > UNIT) count = UNIT;
  }
  for (int j = 0; j < count; ++j) {
    int64_t e = first + j;
    if (local >= chunks && e >= leaf.head) e += after;
    float mn, vn, pn;
    adam(leaf.g[e], load1(m + e), load1(v + e), leaf.p[e], c, mn, vn, pn);
    store1(m + e, mn);
    store1(v + e, vn);
    leaf.p[e] = pn;
  }
}

template <typename M>
__global__ void __launch_bounds__(THREADS, 1)
clip_adam_kernel(const __grid_constant__ Table t,
                 const float* __restrict__ scalars, float max_norm) {
  Consts c;
  c.norm = scalars[0];
  c.bc1 = scalars[1];
  c.bc2 = scalars[2];
  c.neg_lr = -scalars[3];
  c.max_norm = max_norm;
  c.clip = !(c.norm < max_norm);
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (THREADS / 32);
  int l = 0;  // the leaf of the tile's first unit
  for (int64_t w0 = (static_cast<int64_t>(blockIdx.x) * (THREADS / 32) +
                     threadIdx.x / 32) * TILE;
       w0 < t.units; w0 += warps * TILE) {
    while (l + 1 < t.count && w0 >= t.leaf[l + 1].begin) ++l;
    const Leaf& leaf = t.leaf[l];
    const int64_t local = w0 - leaf.begin;
    const int64_t chunks = leaf.head < 0 ? 0 : (leaf.n - leaf.head) / UNIT;
    if (local + TILE <= chunks) {  // the whole tile on one leaf's vector path
      warp_tile<M>(leaf, leaf.head + local * UNIT, lane, c);
      continue;
    }
    const int64_t u = w0 + lane;  // else each lane its unit, value by value
    if (u >= t.units) continue;
    int k = l;
    while (k + 1 < t.count && u >= t.leaf[k + 1].begin) ++k;
    unit_by_value<M>(t.leaf[k], u - t.leaf[k].begin, c);
  }
}

template <typename M>
int launch(const int64_t* rows, int count, int64_t units, const void* scalars,
           float max_norm, int blocks, cudaStream_t stream) {
  Table t;
  memset(&t, 0, sizeof t);
  for (int i = 0; i < count; ++i) {
    const int64_t* r = rows + static_cast<int64_t>(i) * ROW;
    Leaf& leaf = t.leaf[i];
    leaf.g = reinterpret_cast<const float*>(r[0]);
    leaf.m = reinterpret_cast<void*>(r[1]);
    leaf.v = reinterpret_cast<void*>(r[2]);
    leaf.p = reinterpret_cast<float*>(r[3]);
    leaf.n = r[4];
    leaf.begin = r[5];
    leaf.head = r[6];
  }
  t.units = units;
  t.count = count;
  clip_adam_kernel<M><<<blocks, THREADS, 0, stream>>>(
      t, static_cast<const float*>(scalars), max_norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One launch over `count` (1..64) leaves. `table`: host memory, `count`
// rows of 7 int64 words: the g, m, v, p device pointers (g, p float32; m,
// v float32 (moment_dtype 0) or bfloat16 (1), every leaf alike), the
// leaf's values n > 0, its first unit and its head (ops/kernels.py::
// clip_adam_plan); `units`: all leaves' units; m, v and p are updated in
// place; scalars: float32 device pointer to [norm, bc1, bc2, lr]. Returns
// the cudaError_t of the launch; launches `blocks` blocks (one an SM) on
// `stream`, does not synchronise and allocates nothing.
int gm2_clip_adam(const int64_t* table, int count, int64_t units,
                  int moment_dtype, const void* scalars, float max_norm,
                  int blocks, void* stream) {
  if (count < 1 || count > MAX_LEAVES || units < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0)
    return launch<float>(table, count, units, scalars, max_norm, blocks, s);
  if (moment_dtype == 1)
    return launch<__nv_bfloat16>(table, count, units, scalars, max_norm,
                                 blocks, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
