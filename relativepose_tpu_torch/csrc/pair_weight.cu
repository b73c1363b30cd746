// Pair-consistency weight matrix W of the pose solver, for a batch of pairs.
//
// Replaces the Pallas TPU kernel `_wbuild_kernel` /
// `_pair_weight_matrix_pallas` (relativepose_tpu/ops/pallas_kernels.py),
// reached through `pair_weight_matrix_vmem`.  For every pair (i, j) of the
// C correspondences of one pano pair it computes the edge-length
// consistency d2 and the separation test, the normal angle alpha and the
// two edge-normal angles beta and gamma, and the weight
//   f_i f_j exp(-d2 / 2sd^2 - alpha / 2sa1^2 - (beta + gamma) / 2sa2^2),
// times 0.6 unless both ends are observed, masked by the tests, by the
// validity of both ends and off the diagonal.  It also counts, over the
// upper triangle, the pairs that pass the distance test, the distance and
// angle tests, and the nonzero weights (the solver's early-outs).
//
// Bound on an NVIDIA H100 80GB HBM3 (700 W) at B=16, C=1720: writing W
// once (189 MB) takes 0.057 ms at 3.35 TB/s; one triangle's arithmetic
// (137 f32 operations per entry, counted in chip_smoke.py) takes 0.048 ms
// at 67 TFLOP/s, so the bound is bytes.  What held the first version back
// (0.652 ms through its wrapper, chip_smoke.py on the same card model): it
// computed every entry of both triangles, with IEEE divisions by
// constants, three acosf and one expf per entry, and without fused
// multiply-adds (--fmad=false, to keep W bitwise symmetric), so it was
// bound by instruction issue at 11x the bound.  This design: 0.2796 ms for
// the launch alone, 0.3033 ms through the wrapper (chip_smoke.py, the same
// card and power limit), still bound by instruction issue: about 300
// instructions per entry (the loop body is 337 machine instructions, as
// chip_smoke.py counts them, with the out-of-line slow paths of the eight
// IEEE square roots and two reciprocals), 4.9x the bound.

// Design: one block of 32x8 threads per 64x64 tile pair (I <= J) of the
// upper triangle, T(T+1)/2 blocks per pair with T = ceil(C / 64) (378 at
// C = 1720); the block maps its linear index to (I, J).  The 16
// per-correspondence components of the tile's 64 rows and 64 columns are
// staged in shared memory.  Each entry (i, j) with i < j is computed once
// into a padded 64x65 shared tile, which is then stored twice, both stores
// coalesced: row-wise to W[i, j] and, read down its columns (no bank
// conflicts thanks to the padding), to W[j, i].  On a diagonal tile only
// i < j is computed and the tile is mirrored; the diagonal is zero.  W is
// bitwise symmetric by construction, so the compiler may fuse
// multiply-adds.  The three constant denominators come in as reciprocals
// folded with log2(e) (the exponential is exp2f), the thresholds come in
// squared as the host computes them, and arccos is the Abramowitz & Stegun
// 4.4.46 polynomial the Pallas kernel uses (|err| <= 2e-8 rad).  The
// quantities that decide a threshold test (edge lengths, d2, inverse
// lengths, the cosines fed to the arccos) keep IEEE square roots and
// divisions and are rounded as the plain PyTorch version rounds them
// (__fmul_rn / __fadd_rn are never contracted), so the counts stay within
// 2 of it.  The ragged edge is masked, nothing is padded.  Counts are
// integer per-block partials that the caller sums, which is exact and
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 64
#define LDT (TILE + 1)
#define TX 32
#define TY 8
#define NCOMP 16

// packed component rows: ps(0:3) pt(3:6) ns(6:9) nt(9:12) f(12) obs(13)
// valid(14) pad(15), each a [C] row of a [B, 16, C] array

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// arccos on [-1, 1], Abramowitz & Stegun 4.4.46 as in the Pallas kernel:
// sqrt(1 - |x|) P(|x|), reflected through pi for x < 0
__device__ __forceinline__ float acos_poly(float x) {
  const float ax = fabsf(x);
  float p = -0.0012624911f;
  p = fmaf(p, ax, 0.0066700901f);
  p = fmaf(p, ax, -0.0170881256f);
  p = fmaf(p, ax, 0.0308918810f);
  p = fmaf(p, ax, -0.0501743046f);
  p = fmaf(p, ax, 0.0889789874f);
  p = fmaf(p, ax, -0.2145988016f);
  p = fmaf(p, ax, 1.5707963050f);
  const float y = sqrtf(fmaxf(1.0f - ax, 0.0f)) * p;
  return x < 0.0f ? 3.14159265358979f - y : y;
}

// (arccos a - arccos b)^2 via cos(alpha - beta) = ab + sin(alpha)sin(beta);
// the cosine is rounded as the plain version rounds it
__device__ __forceinline__ float ang_diff_sq(float a, float b) {
  const float lim = 0.99999988079071044921875f;  // float32(1 - 1e-7)
  a = clampf(a, -lim, lim);
  b = clampf(b, -lim, lim);
  const float s = __fmul_rn(__fsub_rn(1.0f, __fmul_rn(a, a)),
                            __fsub_rn(1.0f, __fmul_rn(b, b)));
  const float c = __fadd_rn(__fmul_rn(a, b), sqrtf(__fadd_rn(s, 1e-20f)));
  const float y = acos_poly(clampf(c, -lim, lim));
  return y * y;
}

__device__ __forceinline__ float dot3_rn(float a0, float a1, float a2,
                                         float b0, float b1, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)),
                   __fmul_rn(a2, b2));
}

struct Consts {
  float k_d, k_a1, k_a2;  // -log2(e) / (2 sigma^2)
  float dist_thre2, sep, angle_thre2;
};

__global__ void __launch_bounds__(TX * TY, 1)
pair_weight_kernel(const float* __restrict__ comps, int C, int T,
                   Consts k, float* __restrict__ W,
                   int* __restrict__ partials) {
  __shared__ float4 rs4[TILE][NCOMP / 4];  // row ii's components together
  __shared__ float cs[NCOMP][TILE];
  __shared__ float tw[TILE][LDT];
  __shared__ int red[TY][3];

  // linear block index -> tile pair (I, J), I <= J, row-major
  int I = 0, rem = blockIdx.x;
  while (rem >= T - I) {
    rem -= T - I;
    ++I;
  }
  const int J = I + rem;
  const bool diag = I == J;
  const int b = blockIdx.y;
  const int row0 = I * TILE;
  const int col0 = J * TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const float* cb = comps + (size_t)b * NCOMP * C;

  float* rs = reinterpret_cast<float*>(rs4);
  for (int e = tid; e < NCOMP * TILE; e += TX * TY) {
    const int comp = e / TILE, o = e % TILE;
    rs[o * NCOMP + comp] =
        (row0 + o < C) ? cb[(size_t)comp * C + row0 + o] : 0.0f;
    cs[comp][o] = (col0 + o < C) ? cb[(size_t)comp * C + col0 + o] : 0.0f;
  }
  __syncthreads();

  int n_dist = 0, n_dist_angle = 0, n_nonzero = 0;
#pragma unroll
  for (int q = 0; q < TILE / TX; ++q) {
    const int jj = tx + q * TX;
    const int j = col0 + jj;
    float cj[15];
#pragma unroll
    for (int m = 0; m < 15; ++m) cj[m] = cs[m][jj];
    for (int ii = ty; ii < TILE; ii += TY) {
      const int i = row0 + ii;
      float w_out = 0.0f;
      if (i < C && j < C && (!diag || ii < jj)) {
        float ri[16];  // 4 broadcast 16-byte loads
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float4 x = rs4[ii][m];
          ri[4 * m] = x.x;
          ri[4 * m + 1] = x.y;
          ri[4 * m + 2] = x.z;
          ri[4 * m + 3] = x.w;
        }
        const float dxs = ri[0] - cj[0];
        const float dys = ri[1] - cj[1];
        const float dzs = ri[2] - cj[2];
        const float dxt = ri[3] - cj[3];
        const float dyt = ri[4] - cj[4];
        const float dzt = ri[5] - cj[5];
        const float dis_s =
            sqrtf(__fadd_rn(dot3_rn(dxs, dys, dzs, dxs, dys, dzs), 1e-20f));
        const float dis_t =
            sqrtf(__fadd_rn(dot3_rn(dxt, dyt, dzt, dxt, dyt, dzt), 1e-20f));
        const float dd = dis_s - dis_t;
        const float d2 = __fmul_rn(dd, dd);
        const bool dist_ok =
            (d2 < k.dist_thre2) && (fminf(dis_s, dis_t) > k.sep);
        const float inv_s = 1.0f / fmaxf(dis_s, 1e-12f);
        const float inv_t = 1.0f / fmaxf(dis_t, 1e-12f);

        const float nn_s = dot3_rn(ri[6], ri[7], ri[8],
                                   cj[6], cj[7], cj[8]);
        const float nn_t = dot3_rn(ri[9], ri[10], ri[11],
                                   cj[9], cj[10], cj[11]);
        const float alpha = ang_diff_sq(nn_s, nn_t);
        // beta: the row correspondence's normals against the edge
        const float beta = ang_diff_sq(
            __fmul_rn(dot3_rn(ri[6], ri[7], ri[8], dxs, dys, dzs),
                      inv_s),
            __fmul_rn(dot3_rn(ri[9], ri[10], ri[11], dxt, dyt,
                              dzt), inv_t));
        // gamma: the column correspondence's normals against the edge
        const float gamma = ang_diff_sq(
            __fmul_rn(dot3_rn(cj[6], cj[7], cj[8], dxs, dys, dzs), inv_s),
            __fmul_rn(dot3_rn(cj[9], cj[10], cj[11], dxt, dyt, dzt), inv_t));
        const bool angle_ok = (alpha < k.angle_thre2) &&
                              (beta < k.angle_thre2) &&
                              (gamma < k.angle_thre2);

        float w = ri[12] * cj[12] *
                  exp2f(d2 * k.k_d + alpha * k.k_a1 + (beta + gamma) * k.k_a2);
        if (!(ri[13] * cj[13] == 1.0f)) w = w * 0.6f;
        const bool pair_valid = (ri[14] * cj[14]) > 0.5f;
        w_out = (dist_ok && angle_ok && pair_valid) ? w : 0.0f;
        n_dist += (dist_ok && pair_valid);
        n_dist_angle += (dist_ok && angle_ok && pair_valid);
        n_nonzero += (w_out != 0.0f);
      }
      tw[ii][jj] = w_out;
    }
  }
  __syncthreads();

  // W[i, j] for the upper entries (and the zero diagonal), row by row
  float* Wb = W + (size_t)b * C * C;
  for (int ii = ty; ii < TILE; ii += TY) {
    const int i = row0 + ii;
    if (i >= C) break;
#pragma unroll
    for (int q = 0; q < TILE / TX; ++q) {
      const int jj = tx + q * TX;
      const int j = col0 + jj;
      if (j < C && (!diag || ii <= jj)) Wb[(size_t)i * C + j] = tw[ii][jj];
    }
  }
  // W[j, i] = W[i, j]: the tile read down its columns, stored row by row
  for (int a = ty; a < TILE; a += TY) {
    const int j = col0 + a;
    if (j >= C) break;
#pragma unroll
    for (int q = 0; q < TILE / TX; ++q) {
      const int x = tx + q * TX;
      const int i = row0 + x;
      if (i < C && (!diag || x < a)) Wb[(size_t)j * C + i] = tw[x][a];
    }
  }

  n_dist = __reduce_add_sync(0xffffffffu, n_dist);
  n_dist_angle = __reduce_add_sync(0xffffffffu, n_dist_angle);
  n_nonzero = __reduce_add_sync(0xffffffffu, n_nonzero);
  if (tx == 0) {
    red[ty][0] = n_dist;
    red[ty][1] = n_dist_angle;
    red[ty][2] = n_nonzero;
  }
  __syncthreads();
  if (tid < 3) {
    int s = 0;
    for (int y = 0; y < TY; ++y) s += red[y][tid];
    partials[((size_t)b * gridDim.x + blockIdx.x) * 3 + tid] = s;
  }
}

// comps: [B, 16, C] f32; W: [B, C, C] f32; partials: [B, T(T+1)/2, 3]
// int32 with T = ceil(C / 64).  k_d, k_a1, k_a2 are -log2(e) / (2 sigma^2)
// for sigma_dist, sigma_angle1, sigma_angle2; dist_thre2 = dist_thre^2,
// sep = 1.5 dist_sep_thre^2, angle_thre2 = angle_thre^2.  Returns
// cudaGetLastError().
extern "C" int rp_pair_weight_matrix(const float* comps, int B, int C,
                                     float k_d, float k_a1, float k_a2,
                                     float dist_thre2, float sep,
                                     float angle_thre2, float* W,
                                     int* partials, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  const int T = (C + TILE - 1) / TILE;
  const Consts k = {k_d, k_a1, k_a2, dist_thre2, sep, angle_thre2};
  dim3 grid(T * (T + 1) / 2, B);
  dim3 block(TX, TY);
  pair_weight_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      comps, C, T, k, W, partials);
  return (int)cudaGetLastError();
}
