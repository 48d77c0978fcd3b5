// clip_adam for Hopper (sm_90a): the fused clip-by-global-norm + Adam +
// apply update of one parameter leaf, in place.
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
// What bounds it on an H100: bytes. Per element it reads g, m, v, p and
// writes m, v, p: 20 bytes with bf16 moments, 28 with float32 ones; over
// the v0 model's 117.2 M parameters that is 0.70 / 0.98 ms at 3.35 TB/s.
// It does ~15 flops per element, far below the card's rate. Design: a
// grid-stride loop over the leaf, consecutive threads on consecutive
// elements (coalesced), enough blocks to fill every SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load(const float* a, int64_t i) { return a[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* a, int64_t i) {
  return __bfloat162float(a[i]);
}
__device__ __forceinline__ void store(float* a, int64_t i, float x) { a[i] = x; }
__device__ __forceinline__ void store(__nv_bfloat16* a, int64_t i, float x) {
  a[i] = __float2bfloat16_rn(x);
}

template <typename M>
__global__ void __launch_bounds__(THREADS)
clip_adam_kernel(const float* __restrict__ g, M* __restrict__ m,
                 M* __restrict__ v, float* __restrict__ p, int64_t n,
                 const float* __restrict__ scalars, float max_norm) {
  const float norm = scalars[0];
  const float bc1 = scalars[1];
  const float bc2 = scalars[2];
  const float neg_lr = -scalars[3];
  const bool clip = !(norm < max_norm);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * THREADS;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
       i < n; i += stride) {
    float gi = g[i];
    if (clip) gi = __fmul_rn(__fdiv_rn(gi, norm), max_norm);
    const float mn = __fadd_rn(__fmul_rn(0.1f, gi), __fmul_rn(0.9f, load(m, i)));
    const float vn = __fadd_rn(__fmul_rn(0.001f, __fmul_rn(gi, gi)),
                               __fmul_rn(0.999f, load(v, i)));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, bc2)), 1e-8f);
    const float update = __fdiv_rn(__fdiv_rn(mn, bc1), denom);
    p[i] = __fadd_rn(p[i], __fmul_rn(neg_lr, update));
    store(m, i, mn);
    store(v, i, vn);
  }
}

template <typename M>
int launch(const void* g, void* m, void* v, void* p, int64_t n,
           const void* scalars, float max_norm, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms > 0 ? sms : 132) * 8;
  const unsigned int blocks = static_cast<unsigned int>(want < cap ? want : cap);
  clip_adam_kernel<M><<<blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(g), static_cast<M*>(m), static_cast<M*>(v),
      static_cast<float*>(p), n, static_cast<const float*>(scalars), max_norm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// g, p: float32 (n,); m, v: (n,) float32 (moment_dtype 0) or bfloat16
// (moment_dtype 1), updated in place with p; scalars: float32 device
// pointer to [norm, bc1, bc2, lr]. Returns the cudaError_t of the launch;
// launches on `stream`, does not synchronise and allocates nothing.
int gm2_clip_adam(const void* g, void* m, void* v, void* p, int64_t n,
                  int moment_dtype, const void* scalars, float max_norm,
                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (moment_dtype == 0)
    return launch<float>(g, m, v, p, n, scalars, max_norm, s);
  if (moment_dtype == 1)
    return launch<__nv_bfloat16>(g, m, v, p, n, scalars, max_norm, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
