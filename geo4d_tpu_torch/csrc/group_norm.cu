// GroupNorm (+ optional SiLU) over channels-last bf16 activations viewed as
// (N, S, C): statistics per (n, group) over S x C/G in f32, then
// y = x * a + b (+ silu) with a = rstd * gamma, b = beta - mean * rstd * gamma.
//
// Replaces the TPU kernels of geo4d_tpu/ops/group_norm.py: `_gn_kernel`
// (launched by `_gn_single`) and `_gn_stats_kernel` + `_gn_apply_kernel`
// (launched by `_gn_tiled`).
//
// Bound: device-memory bandwidth. The op must read x once and write y once
// (4 bytes per element in bf16) against a handful of flops per element. Two
// paths, chosen statically from (N, S, C) in ops/group_norm.py (`plan`):
//   * resident (gn_resident_kernel): one launch, x read once. Each block
//     (one per SM, launched cooperatively so that all are resident) copies
//     its contiguous (n, rows) slice into shared memory (cp.async, every
//     copy in flight at once) and sums it there,
//     writes per-(n, tile, group) partial sums, meets the other blocks at a
//     grid-wide barrier, folds the partials of its n in a fixed order and
//     writes y from shared memory. It covers every tensor whose slices fit
//     the 227 KB of shared memory a block may use: the UNet's per-frame and
//     per-clip norms.
//   * two-pass (gn_stats_kernel, then gn_apply_kernel): for the larger
//     tensors (the VAE's full-resolution rows, the per-clip 960-channel
//     norms). Pass 1 writes the partial sums of (n, S-tile) blocks, pass 2
//     folds them and streams its tile once more, applying the affine.
// In both, each thread owns 8 consecutive channels and moves them as one
// 16-byte load or store, neighbouring threads on neighbouring addresses, and
// x is cut into (n, S-tile) blocks so that a per-clip norm with N = 1 (only
// G (n, group) pairs) spreads over every SM. Every sum is taken in a fixed
// order (no atomics): a launch on the same input gives the same bits.
//
// Backward (K1b, `gn_backward`): dx, dgamma and dbeta from x, dy and the
// forward's per-(n, tile, group) partial sums, which it folds with the
// forward's own `fold_stats` (the same mean and rstd bits). No TPU kernel
// had a backward (the JAX package differentiates its XLA path); the
// algebra is GroupNorm's: with xhat = (x - mean) * rstd and z = xhat * gamma
// + beta recomputed, dz = dy (times sigma(z) (1 + z (1 - sigma(z))) with the
// SiLU), dbeta = sum dz, dgamma = sum dz * xhat, and per (n, group) the means
// c1 of dz * gamma * xhat and c2 of dz * gamma give dx = rstd (dz gamma - c2
// - xhat c1). Bound: memory, like the forward (read x and dy, write dx: 6
// bytes per element, and x and dy are read twice). Four launches on the
// forward's two-pass tiling: pass 1 writes per-(n, tile, channel) sums of dz
// and dz * xhat, a fold adds the tiles per (n, channel) in order, a third
// adds the images per channel (dgamma, dbeta), pass 2 writes dx. Every sum
// is taken in a fixed order: the backward repeats bit for bit too.

#include <cooperative_groups.h>
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

__device__ __forceinline__ void accumulate8(const uint4& u, float* a1, float* a2) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    a1[j] += f[j];
    a2[j] += f[j] * f[j];
  }
}

// Per-group sums of the block: thread (v, r) holds the sums of channels
// v*8..v*8+7 over its rows; the R rows of threads are added in a fixed order
// (not with atomics) in `red` (R * 2 * C floats), then channels per group.
// Writes the G sums to out1[g], out2[g].
__device__ void block_group_sums(const float* a1, const float* a2, float* red, int C, int G,
                                 float* out1, float* out2) {
  const int tid = threadIdx.x, V = C / 8, R = blockDim.x / V, v = tid % V, r = tid / V;
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
    out1[g] = s1;
    out2[g] = s2;
  }
}

// Folds the T partial sums of image n into mean[G] | rstd[G] in `stat`.
// Thread (g, k) = (tid % G, tid / G), k < K = blockDim.x / G, adds tiles
// k, k + K, ... of group g (neighbouring threads read neighbouring groups:
// coalesced), then thread g adds its K sums in order k = 0..K-1. `scratch`
// holds 2 * K * G floats. Ends synchronised.
__device__ void fold_stats(const float* part1, const float* part2, int n, int S, int C, int G,
                           int T, float eps, float* scratch, float* stat) {
  const int tid = threadIdx.x, K = blockDim.x / G;
  if (tid < K * G) {
    const int g = tid % G, k = tid / G;
    const float* p1 = part1 + (size_t)n * T * G + g;
    const float* p2 = part2 + (size_t)n * T * G + g;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
    for (int t = k; t < T; t += K) {
      s1 += __ldcg(p1 + (size_t)t * G);  // L2: written by other blocks
      s2 += __ldcg(p2 + (size_t)t * G);
    }
    scratch[k * G + g] = s1;
    scratch[(K + k) * G + g] = s2;
  }
  __syncthreads();
  if (tid < G) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < K; ++k) {
      s1 += scratch[k * G + tid];
      s2 += scratch[(K + k) * G + tid];
    }
    const float inv_count = (float)(1.0 / ((double)S * (C / G)));
    const float mean = s1 * inv_count;
    const float var = fmaxf(s2 * inv_count - mean * mean, 0.f);
    stat[tid] = mean;
    stat[G + tid] = rsqrtf(var + eps);
  }
  __syncthreads();
}

// the per-channel affine of thread vector v
__device__ __forceinline__ void affine8(const float* gamma, const float* beta, const float* stat,
                                        int v, int C, int G, float* a, float* b) {
  const int cg = C / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = v * 8 + j, g = c / cg;
    const float rstd = stat[G + g];
    a[j] = rstd * gamma[c];
    b[j] = beta[c] - stat[g] * rstd * gamma[c];
  }
}

__device__ __forceinline__ uint4 apply8(const uint4& u, const float* a, const float* b, int silu) {
  float f[8];
  unpack8(u, f);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float t = f[j] * a[j] + b[j];
    if (silu) t = t / (1.f + __expf(-t));
    f[j] = t;
  }
  return pack8(f);
}

// grid (T, N); block V * R threads with V = C / 8 channel vectors and R rows
// in flight. Dynamic shared memory: R * 2 * C floats (at most 32 KB, since
// R * C = 8 * blockDim.x <= 4096).
__global__ void gn_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                float* __restrict__ part1,
                                float* __restrict__ part2, int S, int C, int G,
                                int T, int rows_per_tile) {
  extern __shared__ float red[];  // per row of threads r: s1[C] | s2[C]
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;

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
    for (int k = 0; k < kUnroll; ++k) accumulate8(u[k], a1, a2);
  }
  const size_t o = ((size_t)n * T + tile) * G;
  block_group_sums(a1, a2, red, C, G, part1 + o, part2 + o);
}

// grid (T, N); block as in gn_stats_kernel. Dynamic shared memory:
// mean[G] | rstd[G], then the fold's 2 * blockDim.x floats.
__global__ void gn_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const float* __restrict__ part1,
                                const float* __restrict__ part2,
                                __nv_bfloat16* __restrict__ y, int S, int C,
                                int G, int T, int rows_per_tile, float eps,
                                int silu) {
  extern __shared__ float stat[];  // mean[G] | rstd[G]
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  fold_stats(part1, part2, n, S, C, G, T, eps, stat + 2 * G, stat);
  float a[8], b[8];
  affine8(gamma, beta, stat, v, C, G, a, b);

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
      if (rr < row1) *reinterpret_cast<uint4*>(y + base + (size_t)rr * C) = apply8(u[k], a, b, silu);
    }
  }
}

// grid (T, N), all blocks resident (cooperative launch); block as in
// gn_stats_kernel. Dynamic shared memory: the slice, rows_per_tile * C bf16,
// then R * 2 * C floats for the row reduction, then mean[G] | rstd[G].
__global__ void __launch_bounds__(512, 1)
gn_resident_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ part1,
                   float* __restrict__ part2, __nv_bfloat16* __restrict__ y, int S, int C,
                   int G, int T, int rows_per_tile, float eps, int silu) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  uint4* sx = reinterpret_cast<uint4*>(smem);  // row i of the slice at sx[i * V]
  float* red = reinterpret_cast<float*>(smem + (size_t)rows_per_tile * C * 2);
  float* stat = red + R * 2 * C;

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  const __nv_bfloat16* xn = x + (size_t)n * S * C + v * 8;
  // every 16-byte copy of the slice in flight at once; each thread then sums
  // the vectors it copied itself
  for (int row = row0 + r; row < row1; row += R)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(sx + (row - row0) * V + v))),
                 "l"(xn + (size_t)row * C)
                 : "memory");
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  float a1[8] = {0.f}, a2[8] = {0.f};
  for (int row = row0 + r; row < row1; row += R) accumulate8(sx[(row - row0) * V + v], a1, a2);
  const size_t o = ((size_t)n * T + tile) * G;
  block_group_sums(a1, a2, red, C, G, part1 + o, part2 + o);

  cooperative_groups::this_grid().sync();  // every block's partial sums are written

  fold_stats(part1, part2, n, S, C, G, T, eps, red, stat);  // red is free again
  float a[8], b[8];
  affine8(gamma, beta, stat, v, C, G, a, b);
  __nv_bfloat16* yn = y + (size_t)n * S * C + v * 8;
  for (int row = row0 + r; row < row1; row += R)
    *reinterpret_cast<uint4*>(yn + (size_t)row * C) = apply8(sx[(row - row0) * V + v], a, b, silu);
}

// thread vector v's 8 channels: gamma, beta, and their group's mean and rstd
__device__ __forceinline__ void channel_params(const float* gamma, const float* beta,
                                               const float* stat, int v, int C, int G, float* g8,
                                               float* b8, float* mu8, float* rs8) {
  const int cg = C / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = v * 8 + j, g = c / cg;
    g8[j] = gamma[c];
    b8[j] = beta[c];
    mu8[j] = stat[g];
    rs8[j] = stat[G + g];
  }
}

// xhat and dz of 8 channels from x and dy
__device__ __forceinline__ void backward8(const uint4& ux, const uint4& udy, const float* g8,
                                          const float* b8, const float* mu8, const float* rs8,
                                          int silu, float* xhat, float* dz) {
  float dy[8];
  unpack8(ux, xhat);
  unpack8(udy, dy);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    xhat[j] = (xhat[j] - mu8[j]) * rs8[j];
    float d = dy[j];
    if (silu) {
      const float z = xhat[j] * g8[j] + b8[j];
      const float sig = 1.f / (1.f + __expf(-z));
      d = d * sig * (1.f + z * (1.f - sig));
    }
    dz[j] = d;
  }
}

// grid (T, N); block as in gn_stats_kernel. Folds the forward's partial sums
// (T_fwd tiles) into mean | rstd, then writes the sums of dz and dz * xhat of
// its tile per channel: pdz[(n * T + tile) * C + c], pdzx likewise. Dynamic
// shared memory: mean[G] | rstd[G], the fold's 2 * blockDim.x floats, then
// R * 2 * C floats for the row reduction.
__global__ void gn_bwd_stats_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ dy,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ part1,
                                    const float* __restrict__ part2, float* __restrict__ pdz,
                                    float* __restrict__ pdzx, int S, int C, int G, int T_fwd,
                                    int T, int rows_per_tile, float eps, int silu) {
  extern __shared__ float sm[];
  float* stat = sm;
  float* red = sm + 2 * G + 2 * blockDim.x;
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  fold_stats(part1, part2, n, S, C, G, T_fwd, eps, stat + 2 * G, stat);
  float g8[8], b8[8], mu8[8], rs8[8];
  channel_params(gamma, beta, stat, v, C, G, g8, b8, mu8, rs8);

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  const size_t base = (size_t)n * S * C + v * 8;
  float a1[8] = {0.f}, a2[8] = {0.f};
  for (int row = row0 + r; row < row1; row += R) {
    const size_t o = base + (size_t)row * C;
    float xhat[8], dz[8];
    backward8(*reinterpret_cast<const uint4*>(x + o), *reinterpret_cast<const uint4*>(dy + o),
              g8, b8, mu8, rs8, silu, xhat, dz);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      a1[j] += dz[j];
      a2[j] += dz[j] * xhat[j];
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[r * 2 * C + v * 8 + j] = a1[j];
    red[r * 2 * C + C + v * 8 + j] = a2[j];
  }
  __syncthreads();
  const size_t out = ((size_t)n * T + tile) * C;
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
    float s = red[i];
    for (int k = 1; k < R; ++k) s += red[k * 2 * C + i];
    if (i < C) pdz[out + i] = s;
    else pdzx[out + i - C] = s;
  }
}

// grid (ceil(C / 128), N), 128 threads: sdz[n * C + c] = sum over the T
// tiles of pdz in order (neighbouring threads on neighbouring channels), and
// sdzx likewise
__global__ void gn_bwd_fold_kernel(const float* __restrict__ pdz, const float* __restrict__ pdzx,
                                   float* __restrict__ sdz, float* __restrict__ sdzx, int C,
                                   int T) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, n = blockIdx.y;
  if (c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  const size_t base = (size_t)n * T * C + c;
  for (int t = 0; t < T; ++t) {
    s1 += pdz[base + (size_t)t * C];
    s2 += pdzx[base + (size_t)t * C];
  }
  sdz[(size_t)n * C + c] = s1;
  sdzx[(size_t)n * C + c] = s2;
}

// grid ceil(C / 128), 128 threads: dbeta[c] = sum over n of sdz, dgamma of
// sdzx, in order
__global__ void gn_bwd_params_kernel(const float* __restrict__ sdz,
                                     const float* __restrict__ sdzx, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int N, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float s1 = 0.f, s2 = 0.f;
  for (int n = 0; n < N; ++n) {
    s1 += sdz[(size_t)n * C + c];
    s2 += sdzx[(size_t)n * C + c];
  }
  dbeta[c] = s1;
  dgamma[c] = s2;
}

// grid (T, N); block as in gn_stats_kernel. Dynamic shared memory: mean[G] |
// rstd[G] | c1[G] | c2[G], then the fold's 2 * blockDim.x floats.
__global__ void gn_bwd_apply_kernel(const __nv_bfloat16* __restrict__ x,
                                    const __nv_bfloat16* __restrict__ dy,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ part1,
                                    const float* __restrict__ part2,
                                    const float* __restrict__ sdz,
                                    const float* __restrict__ sdzx, __nv_bfloat16* __restrict__ dx,
                                    int S, int C, int G, int T_fwd, int rows_per_tile, float eps,
                                    int silu) {
  extern __shared__ float sm[];
  float* stat = sm;       // mean[G] | rstd[G]
  float* cc = sm + 2 * G;  // c1[G] | c2[G]
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  fold_stats(part1, part2, n, S, C, G, T_fwd, eps, sm + 4 * G, stat);
  const int cg = C / G;
  const float inv_count = (float)(1.0 / ((double)S * cg));
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cg; c < (g + 1) * cg; ++c) {
      s1 += sdzx[(size_t)n * C + c] * gamma[c];
      s2 += sdz[(size_t)n * C + c] * gamma[c];
    }
    cc[g] = s1 * inv_count;
    cc[G + g] = s2 * inv_count;
  }
  __syncthreads();
  float g8[8], b8[8], mu8[8], rs8[8], c1[8], c2[8];
  channel_params(gamma, beta, stat, v, C, G, g8, b8, mu8, rs8);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = (v * 8 + j) / cg;
    c1[j] = cc[g];
    c2[j] = cc[G + g];
  }

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  const size_t base = (size_t)n * S * C + v * 8;
  for (int row = row0 + r; row < row1; row += R) {
    const size_t o = base + (size_t)row * C;
    float xhat[8], dz[8];
    backward8(*reinterpret_cast<const uint4*>(x + o), *reinterpret_cast<const uint4*>(dy + o),
              g8, b8, mu8, rs8, silu, xhat, dz);
#pragma unroll
    for (int j = 0; j < 8; ++j) dz[j] = rs8[j] * (dz[j] * g8[j] - c2[j] - xhat[j] * c1[j]);
    *reinterpret_cast<uint4*>(dx + o) = pack8(dz);
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
  gn_apply_kernel<<<grid, threads, (2 * G + 2 * threads) * sizeof(float),
                    (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, (__nv_bfloat16*)y, S, C, G, T,
      rows_per_tile, eps, silu);
  return (int)cudaGetLastError();
}

// One launch of gn_resident_kernel; refused (cudaErrorCooperativeLaunchTooLarge)
// when the T * N blocks cannot all be resident at once.
extern "C" int gn_resident(const void* x, const void* gamma, const void* beta, void* part1,
                           void* part2, void* y, int N, int S, int C, int G, int T,
                           int rows_per_tile, float eps, int silu, void* stream) {
  const int threads = block_threads(C);
  const int R = threads / (C / 8);
  const size_t smem = (size_t)rows_per_tile * C * 2 + (size_t)R * 2 * C * sizeof(float) +
                      2 * G * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(gn_resident_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x, (void*)&gamma, (void*)&beta, &part1, &part2, &y, &S, &C,
                  &G, &T, &rows_per_tile, &eps, &silu};
  return (int)cudaLaunchCooperativeKernel((const void*)gn_resident_kernel, dim3(T, N),
                                          dim3(threads), args, smem, (cudaStream_t)stream);
}

// K1b: the four launches of the backward on `T` tiles of `rows_per_tile`
// rows (ops/group_norm.py `tiling`), reading the forward's partial sums
// (T_fwd tiles). `scratch` holds 2 * N * T * C + 2 * N * C floats.
extern "C" int gn_backward(const void* x, const void* dy, const void* gamma, const void* beta,
                           const void* part1, const void* part2, void* scratch, void* dx,
                           void* dgamma, void* dbeta, int N, int S, int C, int G, int T_fwd,
                           int T, int rows_per_tile, float eps, int silu, void* stream) {
  const int threads = block_threads(C);
  const int R = threads / (C / 8);
  cudaStream_t st = (cudaStream_t)stream;
  float* pdz = (float*)scratch;
  float* pdzx = pdz + (size_t)N * T * C;
  float* sdz = pdzx + (size_t)N * T * C;
  float* sdzx = sdz + (size_t)N * C;
  const dim3 grid(T, N);
  gn_bwd_stats_kernel<<<grid, threads, (2 * G + 2 * threads + R * 2 * C) * sizeof(float), st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, pdz, pdzx, S, C, G, T_fwd, T, rows_per_tile, eps,
      silu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_fold_kernel<<<dim3((C + 127) / 128, N), 128, 0, st>>>(pdz, pdzx, sdz, sdzx, C, T);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_params_kernel<<<(C + 127) / 128, 128, 0, st>>>(sdz, sdzx, (float*)dgamma,
                                                         (float*)dbeta, N, C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_apply_kernel<<<grid, threads, (4 * G + 2 * threads) * sizeof(float), st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, sdz, sdzx, (__nv_bfloat16*)dx, S, C, G, T_fwd,
      rows_per_tile, eps, silu);
  return (int)cudaGetLastError();
}
