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
//    tile that needs it (24 times over in the CUDA-core version), far more
//    than one 225 MB write and two reads of bf16 dl.
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
// float32 operands keep the CUDA-core kernels below (the tensor cores
// would round float32 operands to TF32, and the float32 policy is IEEE):
// Launch A tiles dW over (H / 64) x (D / 128) blocks and streams the batch
// 32 rows at a time; the blocks of the first H tile also sum db. Launch B
// tiles dh over (B / 64) x (H / 128) blocks and streams D 32 at a time,
// rebuilding each tile of dl from l, y and mask in shared memory. Thread
// (ty, tx) of a 16 x 16 grid owns rows ty + 16 i (i < 4) and columns
// 8 tx .. 8 tx + 7 of the output tile. Ragged edges load as 0 and are not
// stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_sm90.cuh"

namespace {

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int RPT = BM / 16;  // rows per thread

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

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


// ---------------------------------------------------------------------------
// bf16 operands: the dl pass, the split-K sum and the two products
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

// dl (B, D) bf16 and db (D,) f32; D % 8 == 0. Thread (ry, cx) owns columns
// 64 blockIdx.x + 8 cx .. + 7 and rows ry, ry + 32, ...
template <typename TY>
__global__ void __launch_bounds__(DL_COLS / 8 * DL_ROWS)
dl_pass_kernel(const __nv_bfloat16* __restrict__ l, const TY* __restrict__ y,
               const float* __restrict__ mask, const float* __restrict__ gptr,
               const __nv_bfloat16* __restrict__ gl,
               __nv_bfloat16* __restrict__ dl, float* __restrict__ db, int B,
               int D) {
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
      float lv[8], yv[8], gv[8] = {};
      load8(l + off, lv);
      load8(y + off, yv);
      if (gl != nullptr) load8(gl + off, gv);
      __align__(16) __nv_bfloat16 out[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float sig = 1.0f / (1.0f + expf(-lv[j]));
        float d = g * (sig - yv[j]) * mk[j];
        if (gl != nullptr) d += gv[j];
        out[j] = __float2bfloat16_rn(d);
        acc[j] += __bfloat162float(out[j]);
      }
      *reinterpret_cast<uint4*>(dl + off) = *reinterpret_cast<const uint4*>(out);
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

// out[i] = round_bf16(sum over s of ws[s][i]), s in order.
__global__ void splitk_sum_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int64_t n,
                                  int splits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += ws[k * n + i];
    out[i] = gm2::round_bf16(s);
  }
}

template <typename TY>
int launch_bf16(const void* l, const void* y, const void* mask, const void* h,
                const void* w, const void* g, const void* gl, void* dl,
                void* ws, void* dw, void* db, void* dh, int B, int H, int D,
                int grid, int dh_splits, cudaStream_t stream) {
  const auto* dlt = static_cast<const __nv_bfloat16*>(dl);
  dl_pass_kernel<TY><<<(D + DL_COLS - 1) / DL_COLS, DL_COLS / 8 * DL_ROWS, 0,
                       stream>>>(
      static_cast<const __nv_bfloat16*>(l), static_cast<const TY*>(y),
      static_cast<const float*>(mask), static_cast<const float*>(g),
      static_cast<const __nv_bfloat16*>(gl), static_cast<__nv_bfloat16*>(dl),
      static_cast<float*>(db), B, D);
  int err = static_cast<int>(cudaGetLastError());
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
    splitk_sum_kernel<<<grid * 4, 256, 0, stream>>>(
        static_cast<const float*>(ws), static_cast<float*>(dh), n_dh, used);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  // dW (H, D) = h^T (H, B) . dl (B, D): A = h stored (K, M), B = dl (K, N)
  const gm2::EpiStoreF32 epi_dw{static_cast<float*>(dw), H, D, D, 0, 1};
  return gm2::launch_gemm<true, true>(h, dlt, H, D, B, 1, grid, epi_dw, stream);
}

}  // namespace

extern "C" {

// float32 operands (the CUDA-core kernels). l, y, g_logits: (B, D), h:
// (B, H), w: (H, D), all float32; mask: (D,) float32; g: device pointer to
// one float32; g_logits may be null. Writes dw (H, D), db (D,), dh (B, H)
// float32. Returns the cudaError_t of the launches; launches on `stream`,
// does not synchronise and allocates nothing.
int gm2_output_layer_bwd(const void* l, const void* y, const void* mask,
                         const void* h, const void* w, const void* g,
                         const void* g_logits, void* dw, void* db, void* dh,
                         int B, int H, int D, void* stream) {
  if (B <= 0 || H <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch<float, float>(l, y, mask, h, w, g, g_logits, dw, db, dh, B, H,
                              D, static_cast<cudaStream_t>(stream));
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
