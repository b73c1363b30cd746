// Power iteration for the spectral-matching eigenvector, for a batch of
// pairs, all iterations in one launch.
//
// Replaces the Pallas TPU kernel `_power_kernel` /
// `_power_iteration_pallas` (relativepose_tpu/ops/pallas_kernels.py),
// reached through `power_iteration_vmem`.  It computes the dominant
// eigenvector of A = W o (h (+) h) after `iters` steps from the all-ones
// vector: y = W [v, h v], v <- h y0 + y1, v <- v / |v| unless |v| <= 1e-12,
// in which case v is kept.
//
// W is read as f32 (the TPU kernel stored it in bf16); every product is
// accumulated in f32.  W is not assumed symmetric: every row is read whole.
//
// Bound on an NVIDIA H100 80GB HBM3 (700 W) at B=16, C=1720, 30
// iterations: 4 C^2 operations per iteration, 0.085 ms in all at
// 67 TFLOP/s, against 0.057 ms to read W once.  But W of 16 pairs is
// 189 MB, more than the 50 MB L2 and all shared memory together, so every
// iteration streams it from device memory: 30 x 189 MB at 3.35 TB/s is a
// floor of 1.70 ms, at 1 operation per byte.  What held the first version
// back (8.315 ms through its wrapper, chip_smoke.py on the same card
// model): one 1024-thread block per pair, so only 16 of 132 SMs pulled W,
// at 43 GB/s each.  This design: 2.054 ms for the launch alone (2.056 ms
// through the wrapper), 2.77 TB/s or 83 % of the peak, 1.21x the
// streaming floor, against 4.143 ms for a torch.bmm loop in the same run
// (chip_smoke.py, the same card and power limit).

// Design: one thread-block cluster of CLUSTER = 8 blocks per pair (the
// portable size; 128 blocks at B = 16), launched with cudaLaunchKernelEx.
// Blocks have 512 threads and at most 64 registers, so two fit on an SM:
// the card then holds 30 such clusters at once and all 16 pairs run in one
// wave (with one 1024-thread block per SM it holds 15, and the 16th pair
// ran alone afterwards). Block r owns the contiguous band of rows [r C / 8,
// (r + 1) C / 8) and keeps the whole v and h v of its pair in shared
// memory. Each iteration its warps stream the band's rows (16-byte loads
// where C % 4 == 0 and W is 16-byte aligned, ROWS = 2 rows in flight per
// warp, unrolled over the row), and each row's result goes straight into
// every block's copy of the new v through distributed shared memory (lane q
// of the warp stores to block q). The block's partial sum of squares goes
// to every block the same way; one cluster.sync() makes it all visible, and
// every block sums the 8 partials in the same order, so all see the same
// norm and apply the keep rule alike. The new-v and partial buffers are
// double-buffered, so a block that runs ahead into the next iteration never
// overwrites what a slower one still reads. No atomics: repeated launches
// give bitwise equal results. Odd iterations walk each warp's rows
// backwards (zig-zag), so an iteration starts on the rows the previous one
// read last, which may still be in the L2. Rows and blocks past the ragged
// edge (C % 4 != 0, C < 8, C = 1) are masked; W is not padded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define CLUSTER 8        // blocks per pair, the portable cluster size
#define THREADS 512
#define BLOCKS_PER_SM 2  // in __launch_bounds__: at most 64 registers
#define WARPS (THREADS / 32)
#define ROWS 2

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// y0 = W[r, :] . v and y1 = W[r, :] . hv for ROWS rows of one warp; the
// sums are complete in every lane
__device__ __forceinline__ void rows_dot(const float* __restrict__ Wb,
                                         const float* v, const float* hv,
                                         int C, bool vec,
                                         const int (&r)[ROWS], int lane,
                                         float (&y0)[ROWS],
                                         float (&y1)[ROWS]) {
#pragma unroll
  for (int k = 0; k < ROWS; ++k) y0[k] = y1[k] = 0.0f;
  if (vec) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
    const float4* hv4 = reinterpret_cast<const float4*>(hv);
    const int C4 = C >> 2;
#pragma unroll 2
    for (int c = lane; c < C4; c += 32) {
      const float4 a = v4[c];
      const float4 g = hv4[c];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (r[k] < 0) continue;
        const float4 w = __ldg(
            reinterpret_cast<const float4*>(Wb + (size_t)r[k] * C) + c);
        y0[k] += w.x * a.x + w.y * a.y + w.z * a.z + w.w * a.w;
        y1[k] += w.x * g.x + w.y * g.y + w.z * g.z + w.w * g.w;
      }
    }
  } else {
#pragma unroll 4
    for (int c = lane; c < C; c += 32) {
      const float a = v[c];
      const float g = hv[c];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (r[k] < 0) continue;
        const float w = __ldg(Wb + (size_t)r[k] * C + c);
        y0[k] += w * a;
        y1[k] += w * g;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    y0[k] = warp_sum(y0[k]);
    y1[k] = warp_sum(y1[k]);
  }
}

__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
power_iteration_kernel(const float* __restrict__ W,
                       const float* __restrict__ h, int C, int iters,
                       float* __restrict__ u) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int c4 = (C + 3) & ~3;  // keep each array 16-byte aligned
  float* v = sm;
  float* hv = sm + c4;
  float* vn = sm + 2 * c4;             // [2][c4], written by every block
  float* part = sm + 4 * c4;           // [2][CLUSTER], written by every block
  float* red = part + 2 * CLUSTER;     // [WARPS]

  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r0 = (int)((long long)C * rank / CLUSTER);
  const int r1 = (int)((long long)C * (rank + 1) / CLUSTER);
  // rows r0 + warp + WARPS * m, m < nrows, in groups of ROWS
  const int nrows = r1 - r0 > warp ? (r1 - r0 - warp + WARPS - 1) / WARPS : 0;
  const int ngroups = (nrows + ROWS - 1) / ROWS;
  const float* Wb = W + (size_t)b * C * C;
  const float* hb = h + (size_t)b * C;
  // 16-byte loads need every row 16-byte aligned
  const bool vec =
      (C & 3) == 0 && (reinterpret_cast<uintptr_t>(W) & 15) == 0;

  for (int i = tid; i < C; i += THREADS) {
    v[i] = 1.0f;
    hv[i] = hb[i];
  }
  // lane q < CLUSTER of every warp stores into block q's buffers
  float* vn_q = cluster.map_shared_rank(vn, lane < CLUSTER ? lane : 0);
  float* part_q = cluster.map_shared_rank(part, lane < CLUSTER ? lane : 0);
  cluster.sync();  // every block of the cluster runs before any remote store

  for (int it = 0; it < iters; ++it) {
    const int buf = it & 1;
    float sq = 0.0f;  // this warp's rows, in its order
    for (int g = 0; g < ngroups; ++g) {
      const int gg = (it & 1) ? ngroups - 1 - g : g;  // zig-zag
      int r[ROWS];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int m = gg * ROWS + k;
        r[k] = m < nrows ? r0 + warp + WARPS * m : -1;
      }
      float y0[ROWS], y1[ROWS];
      rows_dot(Wb, v, hv, C, vec, r, lane, y0, y1);
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        if (r[k] < 0) continue;
        const float y = __ldg(hb + r[k]) * y0[k] + y1[k];
        sq += y * y;
        if (lane < CLUSTER) vn_q[buf * c4 + r[k]] = y;
      }
    }
    if (lane == 0) red[warp] = sq;
    __syncthreads();
    if (warp == 0) {
      const float s = warp_sum(lane < WARPS ? red[lane] : 0.0f);
      if (lane < CLUSTER) part_q[buf * CLUSTER + rank] = s;
    }
    cluster.sync();  // all of the new v and all partials are in place

    const float* pb = part + buf * CLUSTER;
    float ss = 0.0f;
#pragma unroll
    for (int q = 0; q < CLUSTER; ++q) ss += pb[q];
    const float nrm = sqrtf(ss);
    if (nrm > 1e-12f) {
      const float* vb = vn + buf * c4;
      for (int i = tid; i < C; i += THREADS) {
        const float x = vb[i] / nrm;
        v[i] = x;
        hv[i] = hb[i] * x;
      }
    }
    __syncthreads();
  }
  for (int i = r0 + tid; i < r1; i += THREADS) u[(size_t)b * C + i] = v[i];
}

static int power_iteration_smem_bytes(int C) {
  return (4 * ((C + 3) & ~3) + 2 * CLUSTER + WARPS) * (int)sizeof(float);
}

// Raises the kernel's shared-memory limit where it needs more than 48 KB
// (C above 3,064).
static int set_attributes(int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      power_iteration_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
}

static cudaLaunchConfig_t launch_config(int B, int smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = CLUSTER;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// W: [B, C, C] f32; h: [B, C] f32; u: [B, C] f32.  Returns the error of
// the launch (a cluster the card cannot schedule is one) or of setting the
// kernel's attributes, else cudaGetLastError().
extern "C" int rp_power_iteration(const float* W, const float* h, int B,
                                  int C, int iters, float* u, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const int smem = power_iteration_smem_bytes(C);
  int e = set_attributes(smem);
  if (e) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(B, smem, (cudaStream_t)stream,
                                         &attr);
  e = (int)cudaLaunchKernelEx(&cfg, power_iteration_kernel, W, h, C, iters,
                              u);
  if (e) return e;
  return (int)cudaGetLastError();
}

// The cluster size, the threads per block, and how many clusters the card
// can run at once for one pair of size C (cudaOccupancyMaxActiveClusters).
extern "C" int rp_power_iteration_info(int C, int* cluster, int* threads,
                                       int* max_active_clusters) {
  const int smem = power_iteration_smem_bytes(C);
  int e = set_attributes(smem);
  if (e) return e;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(1, smem, 0, &attr);
  *cluster = CLUSTER;
  *threads = THREADS;
  return (int)cudaOccupancyMaxActiveClusters(max_active_clusters,
                                             power_iteration_kernel, &cfg);
}
