// GroupNorm (+ optional SiLU) over channels-last bf16 activations viewed as
// (N, S, C): statistics per (n, group) over S x C/G in f32, then
// y = x * a + b (+ silu) with a = rstd * gamma, b = beta - mean * rstd * gamma.
//
// Replaces the TPU kernels of geo4d_tpu/ops/group_norm.py: `_gn_kernel`
// (launched by `_gn_single`) and `_gn_stats_kernel` + `_gn_apply_kernel`
// (launched by `_gn_tiled`). On Hopper one design covers both row regimes.
//
// Bound: device-memory bandwidth. The op reads x twice and writes y once
// (about 6 bytes per element in bf16) against a handful of flops per element.
// What the design does about it:
//   * x is cut into (n, S-tile) blocks so that even a per-clip norm with
//     N = 1 (only G (n, group) pairs) spreads over every SM;
//   * each thread owns 8 consecutive channels and moves them as one 16-byte
//     load or store, neighbouring threads on neighbouring addresses;
//   * pass 1 (gn_stats_kernel) writes per-(n, tile, group) f32 partial sums;
//     pass 2 (gn_apply_kernel) folds the partials of its n into mean/rstd,
//     then streams its tile once more applying the affine (+ silu).
//   The tile count per n is capped so that the fold in pass 2 reads far fewer
//   bytes than the tile it normalises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 4;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// grid (T, N); block V * R threads with V = C / 8 channel vectors and R rows
// in flight. Dynamic shared memory: R * 2 * C floats (at most 32 KB, since
// R * C = 8 * blockDim.x <= 4096).
__global__ void gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                float* __restrict__ part1,
                                float* __restrict__ part2, int S, int C, int G,
                                int T, int rows_per_tile) {
  extern __shared__ float red[];  // per row of threads r: s1[C] | s2[C]
  const int tile = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int V = C / 8, R = blockDim.x / V, v = tid % V, r = tid / V;

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  const __nv_bfloat16* xn = x + (size_t)n * S * C + v * 8;
  float a1[8] = {0.f}, a2[8] = {0.f};
  for (int row = row0 + r; row < row1; row += kUnroll * R) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rr = row + k * R;
      u[k] = rr < row1 ? *reinterpret_cast<const uint4*>(xn + (size_t)rr * C)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      float f[8];
      unpack8(u[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        a1[j] += f[j];
        a2[j] += f[j] * f[j];
      }
    }
  }
  // the R rows of threads are summed in a fixed order (not with atomics),
  // so a launch on the same input gives the same bits
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[r * 2 * C + v * 8 + j] = a1[j];
    red[r * 2 * C + C + v * 8 + j] = a2[j];
  }
  __syncthreads();
  for (int i = tid; i < 2 * C; i += blockDim.x) {
    // row 0 takes the totals: column i is read and written by this thread only
    float s = red[i];
    for (int k = 1; k < R; ++k) s += red[k * 2 * C + i];
    red[i] = s;
  }
  __syncthreads();

  const int cg = C / G;
  for (int g = tid; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      s1 += red[c];
      s2 += red[C + c];
    }
    const size_t o = ((size_t)n * T + tile) * G + g;
    part1[o] = s1;
    part2[o] = s2;
  }
}

// grid (T, N); block as in gn_stats_kernel. Dynamic shared memory: 2 * G floats.
__global__ void gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const float* __restrict__ part1,
                                const float* __restrict__ part2,
                                __nv_bfloat16* __restrict__ y, int S, int C,
                                int G, int T, int rows_per_tile, float eps,
                                int silu) {
  extern __shared__ float sm[];  // mean[G] | rstd[G]
  const int tile = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int V = C / 8, R = blockDim.x / V, v = tid % V, r = tid / V;
  const int cg = C / G;

  // fold the T partials of this n: one warp per group, lanes over tiles
  const int warp = tid / 32, lane = tid % 32, nwarps = blockDim.x / 32;
  const float inv_count = (float)(1.0 / ((double)S * cg));
  for (int g = warp; g < G; g += nwarps) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = lane; t < T; t += 32) {
      const size_t o = ((size_t)n * T + t) * G + g;
      s1 += part1[o];
      s2 += part2[o];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float mean = s1 * inv_count;
      const float var = fmaxf(s2 * inv_count - mean * mean, 0.f);
      sm[g] = mean;
      sm[G + g] = rsqrtf(var + eps);
    }
  }
  __syncthreads();

  float a[8], b[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = v * 8 + j, g = c / cg;
    const float rstd = sm[G + g];
    a[j] = rstd * gamma[c];
    b[j] = beta[c] - sm[g] * rstd * gamma[c];
  }

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  const size_t base = (size_t)n * S * C + v * 8;
  for (int row = row0 + r; row < row1; row += kUnroll * R) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rr = row + k * R;
      if (rr < row1) u[k] = *reinterpret_cast<const uint4*>(x + base + (size_t)rr * C);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rr = row + k * R;
      if (rr >= row1) continue;
      float f[8];
      unpack8(u[k], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float t = f[j] * a[j] + b[j];
        if (silu) t = t / (1.f + __expf(-t));
        f[j] = t;
      }
      *reinterpret_cast<uint4*>(y + base + (size_t)rr * C) = pack8(f);
    }
  }
}

// V = C / 8 channel vectors times as many rows as fit 512 threads (C <= 4096).
int block_threads(int C) { return (C / 8) * (512 / (C / 8)); }

}  // namespace

extern "C" int gn_stats(const void* x, void* part1, void* part2, int N, int S,
                        int C, int G, int T, int rows_per_tile, void* stream) {
  const int threads = block_threads(C);
  const int R = threads / (C / 8);
  dim3 grid(T, N);
  gn_stats_kernel<<<grid, threads, R * 2 * C * sizeof(float),
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (float*)part1, (float*)part2, S, C, G, T,
      rows_per_tile);
  return (int)cudaGetLastError();
}

extern "C" int gn_apply(const void* x, const void* gamma, const void* beta,
                        const void* part1, const void* part2, void* y, int N,
                        int S, int C, int G, int T, int rows_per_tile,
                        float eps, int silu, void* stream) {
  const int threads = block_threads(C);
  dim3 grid(T, N);
  gn_apply_kernel<<<grid, threads, 2 * G * sizeof(float),
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, (__nv_bfloat16*)y, S, C, G, T,
      rows_per_tile, eps, silu);
  return (int)cudaGetLastError();
}
