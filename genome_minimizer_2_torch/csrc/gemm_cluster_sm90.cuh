// The clustered variant of the bf16 GEMM core (gemm_sm90.cuh), for Hopper
// (sm_90a): C (M, N) = A (M, K) B (K, N), bf16 operands, A K-major and B
// MN-major (N contiguous), float32 accumulators, whole K a tile, with an
// epilogue that may stage work in shared memory. Used by
// decode_threshold_pack.cu ((h W + b) > 0); it takes the tiles, the ring,
// the wgmma and TMA wrappers and the descriptors of gemm_sm90.cuh, whose
// own kernel runs the output layer's backward.
//
// What it adds to that core:
// - Clusters along M: the CTAs of a cluster (cm of them, 1, 2 or 4) own
//   consecutive 128-row tiles of one 256-column strip, a "unit", so they
//   need the same B stage at the same time. Each CTA loads 4 / cm of its
//   64-column boxes by TMA multicast into the stage of every CTA of the
//   cluster: B crosses from L2 once a cluster, not once a CTA. A stage is
//   refilled only when the consumers of every CTA in the cluster have
//   released it (each consumer warp arrives on the empty barrier of every
//   CTA of the cluster, its own by a local arrive), and no CTA exits while
//   a peer may still signal it.
// - Units are dealt to clusters in turn: cluster c takes units c, c + C, ...
//   (C clusters, at most as many as the card holds at once; a cluster's
//   CTAs share a GPC, so an H100 holds 66 clusters of 2 but 30 of 4), the
//   row groups fastest. The plan (ops/kernels.py::decode_plan) picks cm by
//   the rounds of units the busiest cluster runs; the CPU tests cover it.
// - An epilogue may use shared memory of its own (Epi::SMEM bytes): it is
//   called once as a unit starts, by every consumer thread, before the main
//   loop (epi.begin: work whose latency then hides under the products) and
//   once with the accumulators.
// - The release of a stage arrives with CTA scope: the wgmma that read it
//   are complete (wgmma.wait_group), and a cluster-scope release costs a
//   fence on every k block.
// Boxes beyond the matrix are zero-filled by TMA, so a cluster's row tiles
// past M compute zeros, which the epilogue does not store.

#pragma once

#include "gemm_sm90.cuh"

namespace gm2 {
namespace cl {

struct GemmShape {
  int M, N, K;
  int cm;  // CTAs of a cluster
  int m_tiles, m_groups, n_tiles, k_blocks, units;
};

inline GemmShape gemm_shape(int M, int N, int K, int cm) {
  GemmShape s;
  s.M = M; s.N = N; s.K = K; s.cm = cm;
  s.m_tiles = (M + BM - 1) / BM;
  s.m_groups = (s.m_tiles + cm - 1) / cm;
  s.n_tiles = (N + BN - 1) / BN;
  s.k_blocks = (K + BK - 1) / BK;
  s.units = s.m_groups * s.n_tiles;
  return s;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// All threads of every CTA of the cluster.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::
          : "memory");
}

// Arrive on the barrier at the same shared offset in CTA `cta` of the
// cluster (a local arrive on the CTA's own).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar, uint32_t cta,
                                                    uint32_t rank) {
  if (cta == rank) {
    mbar_arrive(bar);
    return;
  }
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(bar), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote)
               : "memory");
}

// A box into this CTA, or into the same shared offset of all `cm` CTAs of
// the cluster, each CTA's barrier at `bar`'s offset counting its bytes.
__device__ __forceinline__ void tma_load_to(uint32_t dst, const CUtensorMap* map,
                                            int c0, int c1, uint32_t bar, int cm) {
  if (cm == 1) {
    tma_load(dst, map, c0, c1, bar);
    return;
  }
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar),
      "h"(static_cast<uint16_t>((1u << cm) - 1u))
      : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <class Epi>
constexpr int smem_bytes() {
  return 1024 + STAGES * STAGE_BYTES + Epi::SMEM + 2 * STAGES * 8;
}

// The accumulator fragment and the operand layouts are gemm_sm90.cuh's (A
// K-major in one box of 64 x 128 rows, B MN-major in 4 boxes). An
// epilogue is called once per tile and consumer warpgroup with the row of
// d[0] (rows + 0 and + 8 follow from it), the tile's first column, q, its
// shared memory and the CTA's unit count so far (its turn).
template <class Epi>
__global__ void __launch_bounds__(THREADS, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
            const __grid_constant__ CUtensorMap tma_b, const GemmShape s,
            const Epi epi) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms
  const uint32_t epi_smem = ring + STAGES * STAGE_BYTES;        // the epilogue's
  const uint32_t full = epi_smem + Epi::SMEM;  // STAGES barriers each
  const uint32_t empty = full + STAGES * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = blockIdx.x / s.cm, clusters = gridDim.x / s.cm;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, CONSUMERS * 4 * s.cm);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers exist before a peer signals them

  if (threadIdx.x == CONSUMERS * 128) {
    // ---- producer: one thread issues every load; once every CTA of the
    // cluster has released a stage, its A tile and the CTA's share of B ----
    int stage = 0;
    uint32_t phase = 0;
    for (int u = cluster; u < s.units; u += clusters) {
      const int m0 = (u % s.m_groups * s.cm + rank) * BM, n0 = u / s.m_groups * BN;
      for (int kb = 0; kb < s.k_blocks; ++kb) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, STAGE_BYTES);
        const uint32_t a = ring + stage * STAGE_BYTES, b = a + A_BYTES;
        const int k0 = kb * BK;
        tma_load(a, &tma_a, k0, m0, bar);
        const int boxes = BN / 64 / s.cm;  // of B: boxes rank * 4 / cm ..
        for (int j = rank * boxes; j < (rank + 1) * boxes; ++j)
          tma_load_to(b + j * BOX_BYTES, &tma_b, n0 + 64 * j, k0, bar, s.cm);
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
    }
  } else if (threadIdx.x < CONSUMERS * 128) {
    // ---- consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 ----
    const int wg = warp / 4, t128 = threadIdx.x % 128;
    const int row_in_tile = 64 * wg + 16 * (t128 / 32) + (t128 % 32) / 4;
    const int q = t128 % 4;
    // the warpgroup's 64 rows of A start 64 x 128 bytes into the tile; a
    // k16 step moves 32 bytes along A's rows and 16 rows down B's
    const uint32_t a_off = wg * BOX_BYTES;
    // a released stage: every warp arrives on its empty barrier in each CTA
    // of the cluster (lane c signals CTA c)
    auto release = [&](int st) {
      if (lane < s.cm) mbar_arrive_cluster(empty + 8 * st, lane, rank);
    };
    int stage = 0, turn = 0;
    uint32_t phase = 0;
    float d[BN / 2];
    for (int u = cluster; u < s.units; u += clusters, ++turn) {
      const int m0 = (u % s.m_groups * s.cm + rank) * BM, n0 = u / s.m_groups * BN;
      epi.begin(n0, epi_smem, turn);
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) d[j] = 0.0f;
      fence_acc(d);
      int prev = -1;
      for (int kb = 0; kb < s.k_blocks; ++kb) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * STAGE_BYTES + a_off;
        const uint32_t b = ring + stage * STAGE_BYTES + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_k16<0, 1>(d, smem_desc(a + kk * 32, 16, SW_ATOM),
                          smem_desc(b + kk * 16 * 128, BOX_BYTES, SW_ATOM));
        wgmma_commit();
        wgmma_wait<1>();  // the previous k block's products are done
        if (prev >= 0) release(prev);
        prev = stage;
        if (++stage == STAGES) { stage = 0; phase ^= 1; }
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (prev >= 0) release(prev);
      epi(d, m0 + row_in_tile, n0, q, epi_smem, turn);
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still signal its barriers
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

inline cudaLaunchConfig_t cluster_config(int grid, int smem, int cm, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cm;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <class Epi>
int prepare_kernel() {
  static const int err = static_cast<int>(
      cudaFuncSetAttribute(gemm_kernel<Epi>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<Epi>()));
  return err;
}

// Clusters of `cm` CTAs of this kernel that the card holds at once.
template <class Epi>
int max_clusters(int cm, int* n) {
  const int err = prepare_kernel<Epi>();
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(cm, smem_bytes<Epi>(), cm, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(gemm_kernel<Epi>), &cfg));
}

// C = A B with A (M, K) and B (K, N) bf16, row-major. One launch of
// `clusters` clusters of cm CTAs (at most as many as there are units); cm
// 1, 2 or 4.
template <class Epi>
int launch_gemm(const void* a, const void* b, int M, int N, int K, int cm, int clusters,
                const Epi& epi, cudaStream_t stream) {
  if ((cm != 1 && cm != 2 && cm != 4) || clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const GemmShape s = gemm_shape(M, N, K, cm);
  CUtensorMap ta, tb;
  int err = tensor_map(&ta, a, M, K, BM);
  if (err == 0) err = tensor_map(&tb, b, K, N, 64);
  if (err == 0) err = prepare_kernel<Epi>();
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(
      (clusters < s.units ? clusters : s.units) * cm, smem_bytes<Epi>(), cm, stream, attr);
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, gemm_kernel<Epi>, ta, tb, s, epi));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cl
}  // namespace gm2
