// output_layer_bwd for Hopper (sm_90a): the backward of the output layer
// and the masked BCE.
//
// Replaces the TPU probe kernels tools/bol_probe.py::make_bwd (2-D grid,
// VMEM accumulators; pallas_call at :92) and ::make_bwd_fullk (1-D grid,
// full-K dots; pallas_call at :187). Both compute one function:
//
//   dl = round_T(g * (sigmoid(l) - y) * mask + g_logits)     (B, D)
//   dW = round_T(h^T dl)   (H, D)     db = sum_rows dl   (D,) f32
//   dh = round_T(dl W^T)   (B, H)
//
// with l the logits, y the targets, mask the (D,) gene mask, g the scalar
// cotangent of the BCE sum (read from device memory), g_logits the optional
// cotangent of the logits themselves (the gene-abundance term; absent for
// v0), and round_T the rounding to the operand type T: bf16 under the mixed
// policy, where JAX rounds the logits' cotangent to the logits' dtype and
// the transpose of its product rounds dW and dh to the operands' dtype.
// dW and dh are stored as float32 (holding bf16 values under bf16).
//
// What bounds it on an H100: at the training path's shape (B = 2,048,
// H = 1,024, D = 55,040) the two products are 2 x 2BHD = 461.7 GFLOP,
// about 0.47 ms at the bf16 tensor-core peak, against ~0.9 GB of traffic
// (0.27 ms at 3.35 TB/s): operations.
//
// bf16 operands: three launches (four with a split dh) on the tensor cores.
// 1. The dl pass reads l, y, mask, g and g_logits once, takes one expf per
//    element, writes dl as bf16 into a (B, D) scratch that the wrapper
//    allocates, and writes db: each block owns 64 columns and walks every
//    row, then sums its 32 row lanes in a fixed order, so db is the same
//    from run to run (no atomics). This gives up the probe's "dl never
//    reaches device memory" on purpose: rebuilding dl inside each product
//    costs an expf and a read of l and y per element for every output
//    tile that needs it (24 times over in the first CUDA-core version),
//    far more than one 225 MB write and two reads of bf16 dl.
// 2. dh = dl W^T on the GEMM core of gemm_sm90.cuh (TMA ring + wgmma),
//    both operands K-major (rows of dl and of W (H, D) are contiguous in
//    D). dh has only (B / 128) x (H / 256) output tiles, 64 at the
//    training shape, against a K of 55,040: the wrapper splits K so that
//    the blocks fill the SMs (2 ways at B = 2,048, 8 at the ragged batch
//    of 512, 16 tiles); the float32 partials are then summed in split
//    order and rounded by a small fourth pass.
// 3. dW = h^T dl on the same core, both operands MN-major (h (B, H) and
//    dl (B, D) are contiguous along H and D), rounded to bf16 in the
//    epilogue.
// Every launch is on the caller's stream; nothing synchronises.
//
// float32 operands take the same three (four) steps on the CUDA cores (the
// tensor cores would round float32 operands to TF32, and the float32
// policy is IEEE), with the products on the SIMT GEMM core of
// sgemm_sm90.cuh (128 x 128 tiles of 8 x 8 register tiles, a 4-stage ring
// of k16 stages):
// 1. The same dl pass stores dl as float32 (451 MB at B = 2,048), for the
//    same reason: the first CUDA-core version rebuilt each element inside
//    every output tile that needed it, 24 expf and 48 float32 reads per
//    element, far more than writing dl once and reading it twice. db is
//    the pass's fixed-order float32 sum.
// 2. dh = dl W^T, both operands K-major (transposed on their way into
//    shared memory); only (B / 128) x (H / 128) tiles, 128 at the training
//    shape, so K is split until the blocks fill the SMs (two blocks each:
//    2 ways at B = 2,048, 8 at 512) and a fourth pass sums the float32
//    partials in split order (no rounding).
// 3. dW = h^T dl, both operands MN-major (cp.async), 8 x 430 tiles at the
//    training shape, stored as float32.
// Bound at the training shape: 461.7 GFLOP at the 67 TFLOP/s float32 peak,
// 6.9 ms, against about 1.8 GB of traffic (0.54 ms): operations.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"
#include "sgemm_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// The dl pass and the split-K sum (both routes), the products of each route
// ---------------------------------------------------------------------------

constexpr int DL_COLS = 64;    // columns per block: 8 lanes x 8 columns
constexpr int DL_ROWS = 32;    // row lanes per block

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_as(float x, const float*) { return x; }

// v holds values of T (rounded already), so the bf16 conversion is exact.
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __float2bfloat16_rn(v[j]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(out);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// dl (B, D) in T (bf16 or float32) and db (D,) f32; D % 8 == 0. Thread
// (ry, cx) owns columns 64 blockIdx.x + 8 cx .. + 7 and rows ry, ry + 32, ...
template <typename T, typename TY>
__global__ void __launch_bounds__(DL_COLS / 8 * DL_ROWS)
dl_pass_kernel(const T* __restrict__ l, const TY* __restrict__ y,
               const float* __restrict__ mask, const float* __restrict__ gptr,
               const T* __restrict__ gl, T* __restrict__ dl,
               float* __restrict__ db, int B, int D) {
  __shared__ float part[DL_ROWS][DL_COLS + 1];
  const int cx = threadIdx.x % 8, ry = threadIdx.x / 8;
  const int c0 = blockIdx.x * DL_COLS + cx * 8;
  const float g = *gptr;
  float acc[8] = {};
  if (c0 < D) {
    float mk[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) mk[j] = mask[c0 + j];
    for (int r = ry; r < B; r += DL_ROWS) {
      const int64_t off = static_cast<int64_t>(r) * D + c0;
      float lv[8], yv[8], gv[8] = {}, out[8];
      load8(l + off, lv);
      load8(y + off, yv);
      if (gl != nullptr) load8(gl + off, gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sig = 1.0f / (1.0f + expf(-lv[j]));
        float d = g * (sig - yv[j]) * mk[j];
        if (gl != nullptr) d += gv[j];
        out[j] = round_as(d, dl);
        acc[j] += out[j];
      }
      store8(dl + off, out);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) part[ry][cx * 8 + j] = acc[j];
  __syncthreads();
  const int c = blockIdx.x * DL_COLS + threadIdx.x;
  if (threadIdx.x < DL_COLS && c < D) {
    float s = 0.0f;
    for (int i = 0; i < DL_ROWS; ++i) s += part[i][threadIdx.x];
    db[c] = s;
  }
}

// out[i] = sum over s of ws[s][i], s in order; rounded to bf16 if ROUND.
template <bool ROUND>
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = ROUND ? gm2::round_bf16(s) : s;
  }
}

template <typename T, typename TY>
int launch_dl_pass(const void* l, const void* y, const void* mask,
                   const void* g, const void* gl, void* dl, void* db, int B,
                   int D, cudaStream_t stream) {
  dl_pass_kernel<T, TY><<<(D + DL_COLS - 1) / DL_COLS, DL_COLS / 8 * DL_ROWS, 0,
                          stream>>>(
      static_cast<const T*>(l), static_cast<const TY*>(y),
      static_cast<const float*>(mask), static_cast<const float*>(g),
      static_cast<const T*>(gl), static_cast<T*>(dl), static_cast<float*>(db),
      B, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename TY>
int launch_bf16(const void* l, const void* y, const void* mask, const void* h,
                const void* w, const void* g, const void* gl, void* dl,
                void* ws, void* dw, void* db, void* dh, int B, int H, int D,
                int grid, int dh_splits, cudaStream_t stream) {
  const auto* dlt = static_cast<const __nv_bfloat16*>(dl);
  int err = launch_dl_pass<__nv_bfloat16, TY>(l, y, mask, g, gl, dl, db, B, D,
                                             stream);
  if (err != 0) return err;
  // dh (B, H) = dl (B, D) . W (H, D)^T: A = dl K-major, B^T = W stored (N, K)
  const int64_t n_dh = static_cast<int64_t>(B) * H;
  const bool split = dh_splits > 1;
  const gm2::EpiStoreF32 epi_dh{static_cast<float*>(split ? ws : dh), B, H, H,
                                n_dh, split ? 0 : 1};
  err = gm2::launch_gemm<false, false>(dlt, w, B, H, D, dh_splits, grid, epi_dh,
                                       stream);
  if (err != 0) return err;
  if (split) {
    const gm2::GemmShape s = gm2::gemm_shape(B, H, D, dh_splits);
    const int used = s.tiles / (s.m_tiles * s.n_tiles);
    splitk_sum_kernel<true><<<grid * 4, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(dh), n_dh, used);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  // dW (H, D) = h^T (H, B) . dl (B, D): A = h stored (K, M), B = dl (K, N)
  const gm2::EpiStoreF32 epi_dw{static_cast<float*>(dw), H, D, D, 0, 1};
  return gm2::launch_gemm<true, true>(h, dlt, H, D, B, 1, grid, epi_dw, stream);
}

// dh on the SIMT core: A = dl (B, D) K-major, B^T = W stored (H, D), K-major.
using DhEpi = gm2::sgemm::EpiStore;

int launch_f32(const void* l, const void* y, const void* mask, const void* h,
               const void* w, const void* g, const void* gl, void* dl,
               void* ws, void* dw, void* db, void* dh, int B, int H, int D,
               int grid, int dh_splits, cudaStream_t stream) {
  namespace sg = gm2::sgemm;
  const auto* dlt = static_cast<const float*>(dl);
  int err = launch_dl_pass<float, float>(l, y, mask, g, gl, dl, db, B, D, stream);
  if (err != 0) return err;
  // dh (B, H) = dl (B, D) . W (H, D)^T
  const int64_t n_dh = static_cast<int64_t>(B) * H;
  const sg::Shape s_dh = sg::shape(B, H, D, dh_splits);
  const bool split = s_dh.splits > 1;
  const DhEpi epi_dh{static_cast<float*>(split ? ws : dh), B, H, H, n_dh};
  err = sg::launch<true, true>(dlt, D, static_cast<const float*>(w), D, s_dh,
                               epi_dh, stream);
  if (err != 0) return err;
  if (split) {
    splitk_sum_kernel<false><<<grid * 4, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(dh), n_dh,
        s_dh.splits);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  // dW (H, D) = h^T (H, B) . dl (B, D): A = h stored (K, M), B = dl (K, N)
  const sg::EpiStore epi_dw{static_cast<float*>(dw), H, D, D, 0};
  return sg::launch<false, false>(static_cast<const float*>(h), H, dlt, D,
                                  sg::shape(H, D, B, 1), epi_dw, stream);
}

}  // namespace

extern "C" {

// float32 operands (the CUDA-core route). l, y, g_logits: (B, D), h:
// (B, H), w: (H, D), all float32; mask: (D,) float32; g: device pointer to
// one float32; g_logits may be null; H and D multiples of 8, every pointer
// 16-byte aligned. dl: a (B, D) float32 scratch; ws: a (dh_splits, B, H)
// float32 scratch, used when dh_splits > 1. grid: the SM count (the split
// sum's blocks / 4). Writes dw (H, D), db (D,), dh (B, H) float32. Returns
// the cudaError_t of the launches; launches on `stream`, does not
// synchronise and allocates nothing.
int gm2_output_layer_bwd(const void* l, const void* y, const void* mask,
                         const void* h, const void* w, const void* g,
                         const void* g_logits, void* dl, void* ws, void* dw,
                         void* db, void* dh, int B, int H, int D, int grid,
                         int dh_splits, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || H % 8 != 0 || D % 8 != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(l, y, mask, h, w, g, g_logits, dl, ws, dw, db, dh, B, H, D,
                    grid, dh_splits, static_cast<cudaStream_t>(stream));
}

// Blocks of the float32 dh product that one SM holds at once (its split
// rule counts them); returns the cudaError_t of the query.
int gm2_output_layer_bwd_f32_blocks_per_sm(int* n) {
  return static_cast<int>(
      gm2::sgemm::blocks_per_sm<true, true, DhEpi>(n));
}

// bf16 operands (the tensor-core route). l, g_logits: (B, D), h: (B, H),
// w: (H, D), all bf16; y: (B, D) bf16 (y_dtype 1) or float32 (0); H and D
// multiples of 8. dl: a (B, D) bf16 scratch; ws: a (dh_splits, B, H)
// float32 scratch, used when dh_splits > 1. grid: blocks of each product
// (the SM count). Writes db (D,) float32 and dw (H, D), dh (B, H) as
// float32 holding bf16 values.
int gm2_output_layer_bwd_bf16(const void* l, const void* y, const void* mask,
                              const void* h, const void* w, const void* g,
                              const void* g_logits, void* dl, void* ws,
                              void* dw, void* db, void* dh, int B, int H,
                              int D, int y_dtype, int grid, int dh_splits,
                              void* stream) {
  if (B <= 0 || H <= 0 || D <= 0 || H % 8 != 0 || D % 8 != 0 || grid <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y_dtype == 1)
    return launch_bf16<__nv_bfloat16>(l, y, mask, h, w, g, g_logits, dl, ws, dw,
                                      db, dh, B, H, D, grid, dh_splits, s);
  if (y_dtype == 0)
    return launch_bf16<float>(l, y, mask, h, w, g, g_logits, dl, ws, dw, db,
                              dh, B, H, D, grid, dh_splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
