// output_layer_bwd for Hopper (sm_90a): the backward of the output layer
// and the masked BCE, with the logits' cotangent built in the prologue.
//
// Replaces the TPU probe kernels tools/bol_probe.py::make_bwd (2-D grid,
// VMEM accumulators; pallas_call at :92) and ::make_bwd_fullk (1-D grid,
// full-K dots; pallas_call at :187). Both compute one function:
//
//   dl = round_T(g * (sigmoid(l) - y) * mask + g_logits)     (B, D)
//   dW = h^T dl   (H, D) f32     db = sum_rows dl   (D,) f32
//   dh = dl W^T   (B, H) f32
//
// with l the logits, y the targets, mask the (D,) gene mask, g the scalar
// cotangent of the BCE sum (read from device memory), g_logits the optional
// cotangent of the logits themselves (the gene-abundance term; absent for
// v0), and round_T the rounding to the operand type T (bf16 under the
// mixed policy, as JAX rounds the logits' cotangent to the logits' dtype).
// dl never reaches device memory: each tile of it is rebuilt from l, y and
// mask in shared memory where a product needs it.
//
// What bounds it on an H100: at the training path's shape (B = 2,048,
// H = 1,024, D = 55,040) the two products are 2 x 2BHD = 461.7 GFLOP, about
// 0.47 ms at the bf16 tensor-core peak, against ~0.8 GB of traffic (0.24 ms
// at 3.35 TB/s): operations. This first version is simple and right, not
// fast: two shared-memory tiled GEMMs on the CUDA cores (float32 FMAs, no
// tensor cores), so it runs far from that bound. mma.sync / wgmma, TMA and
// one persistent launch are the later work that closes it.
//
// Launch A tiles dW over (H / 64) x (D / 128) blocks and streams the batch
// 32 rows at a time; the blocks of the first H tile also sum db. Launch B
// tiles dh over (B / 64) x (H / 128) blocks and streams D 32 at a time.
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) and columns
// 8 tx .. 8 tx + 7 of the output tile. Ragged edges load as 0 and are not
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int RPT = BM / 16;  // rows per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// One element of dl, rounded to T; 0 outside the (B, D) matrix.
template <typename T, typename TY>
__device__ __forceinline__ float dl_at(const T* __restrict__ l,
                                       const TY* __restrict__ y,
                                       const float* __restrict__ mask,
                                       const T* __restrict__ gl, float g,
                                       int b, int n, int B, int D) {
  if (b >= B || n >= D) return 0.0f;
  const int64_t off = static_cast<int64_t>(b) * D + n;
  const float lv = to_float(l[off]);
  const float sig = 1.0f / (1.0f + expf(-lv));
  float d = g * (sig - to_float(y[off])) * mask[n];
  if (gl != nullptr) d += to_float(gl[off]);
  return round_to(d, l);
}

// Register-tile product of one BK slab: acc[i][j] += A[k][row i] B[k][col j].
template <int LDA, int LDB>
__device__ __forceinline__ void slab(float (*As)[LDA], float (*Bs)[LDB],
                                     int ty, int tx, float (&acc)[RPT][8]) {
#pragma unroll 8
  for (int k = 0; k < BK; ++k) {
    float a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) a[i] = As[k][ty + 16 * i];
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][tx * 8 + 4]);
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// Launch A: dW (H, D) = h^T dl, and db (D,) from the first H tile.
template <typename T, typename TY>
__global__ void __launch_bounds__(THREADS)
bwd_dw_kernel(const T* __restrict__ l, const TY* __restrict__ y,
              const float* __restrict__ mask, const T* __restrict__ h,
              const float* __restrict__ gptr, const T* __restrict__ gl,
              float* __restrict__ dw, float* __restrict__ db, int B, int H,
              int D) {
  __shared__ __align__(16) float As[BK][BM];  // h[b0 + k][m0 + m]
  __shared__ __align__(16) float Bs[BK][BN];  // dl[b0 + k][n0 + n]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const bool with_db = blockIdx.x == 0;
  const float g = *gptr;
  float acc[RPT][8] = {};
  float db_acc = 0.0f;

  for (int b0 = 0; b0 < B; b0 += BK) {
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int k = e / BM, mm = e % BM, gb = b0 + k, gm = m0 + mm;
      As[k][mm] = (gb < B && gm < H)
                      ? to_float(h[static_cast<int64_t>(gb) * H + gm])
                      : 0.0f;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int k = e / BN, nn = e % BN;
      Bs[k][nn] = dl_at(l, y, mask, gl, g, b0 + k, n0 + nn, B, D);
    }
    __syncthreads();
    if (with_db && tid < BN) {
#pragma unroll 8
      for (int k = 0; k < BK; ++k) db_acc += Bs[k][tid];
    }
    slab<BM, BN>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  const int col0 = n0 + tx * 8;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= H) continue;
    float* row = dw + static_cast<int64_t>(gm) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + j < D) row[col0 + j] = acc[i][j];
  }
  if (with_db && tid < BN && n0 + tid < D) db[n0 + tid] = db_acc;
}

// Launch B: dh (B, H) = dl W^T, W stored (H, D).
template <typename T, typename TY>
__global__ void __launch_bounds__(THREADS)
bwd_dh_kernel(const T* __restrict__ l, const TY* __restrict__ y,
              const float* __restrict__ mask, const T* __restrict__ w,
              const float* __restrict__ gptr, const T* __restrict__ gl,
              float* __restrict__ dh, int B, int H, int D) {
  __shared__ __align__(16) float As[BK][BM + 1];  // dl[b0 + m][k0 + k]
  __shared__ __align__(16) float Bs[BK][BN + 4];  // w[n0 + n][k0 + k]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * BN, b0 = blockIdx.y * BM;
  const float g = *gptr;
  float acc[RPT][8] = {};

  for (int k0 = 0; k0 < D; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, k = e % BK;
      As[k][mm] = dl_at(l, y, mask, gl, g, b0 + mm, k0 + k, B, D);
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int nn = e / BK, k = e % BK, gn = n0 + nn, gk = k0 + k;
      Bs[k][nn] = (gn < H && gk < D)
                      ? to_float(w[static_cast<int64_t>(gn) * D + gk])
                      : 0.0f;
    }
    __syncthreads();
    slab<BM + 1, BN + 4>(As, Bs, ty, tx, acc);
    __syncthreads();
  }

  const int col0 = n0 + tx * 8;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int gb = b0 + ty + 16 * i;
    if (gb >= B) continue;
    float* row = dh + static_cast<int64_t>(gb) * H;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (col0 + j < H) row[col0 + j] = acc[i][j];
  }
}

template <typename T, typename TY>
int launch(const void* l, const void* y, const void* mask, const void* h,
           const void* w, const void* g, const void* gl, void* dw, void* db,
           void* dh, int B, int H, int D, cudaStream_t stream) {
  const T* lt = static_cast<const T*>(l);
  const TY* yt = static_cast<const TY*>(y);
  const float* mt = static_cast<const float*>(mask);
  const float* gt = static_cast<const float*>(g);
  const T* glt = static_cast<const T*>(gl);
  const dim3 grid_a((H + BM - 1) / BM, (D + BN - 1) / BN);
  bwd_dw_kernel<T, TY><<<grid_a, THREADS, 0, stream>>>(
      lt, yt, mt, static_cast<const T*>(h), gt, glt, static_cast<float*>(dw),
      static_cast<float*>(db), B, H, D);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const dim3 grid_b((H + BN - 1) / BN, (B + BM - 1) / BM);
  bwd_dh_kernel<T, TY><<<grid_b, THREADS, 0, stream>>>(
      lt, yt, mt, static_cast<const T*>(w), gt, glt, static_cast<float*>(dh),
      B, H, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// l, g_logits: (B, D), h: (B, H), w: (H, D), all in the operand type
// (dtype 0 = float32, 1 = bfloat16); y: (B, D) in y_dtype (same codes);
// mask: (D,) float32; g: device pointer to one float32; g_logits may be
// null. Writes dw (H, D), db (D,), dh (B, H) float32. Returns the
// cudaError_t of the launches; launches on `stream`, does not synchronise
// and allocates nothing.
int gm2_output_layer_bwd(const void* l, const void* y, const void* mask,
                         const void* h, const void* w, const void* g,
                         const void* g_logits, void* dw, void* db, void* dh,
                         int B, int H, int D, int dtype, int y_dtype,
                         void* stream) {
  if (B <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && y_dtype == 0)
    return launch<float, float>(l, y, mask, h, w, g, g_logits, dw, db, dh, B, H, D, s);
  if (dtype == 1 && y_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(l, y, mask, h, w, g, g_logits,
                                                dw, db, dh, B, H, D, s);
  if (dtype == 1 && y_dtype == 0)
    return launch<__nv_bfloat16, float>(l, y, mask, h, w, g, g_logits, dw, db,
                                        dh, B, H, D, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
