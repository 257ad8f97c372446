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
// bytes per element). Each (n, tile) block writes its partial sums, per
// channel of dz and dz * xhat (for dgamma, dbeta) and per group of dz gamma
// xhat and dz gamma (for c1, c2); after them, each block folds its image's
// group partials over the tiles and writes dx, and the grid's blocks share
// the dgamma / dbeta folds (32 channels each, every warp's loads coalesced).
// Two paths, chosen statically in ops/group_norm.py (`backward_plan`):
//   * coop (gn_bwd_coop_kernel): one cooperative launch on the forward's
//     resident tiling. The block copies its slice of x into shared memory
//     (in two halves, so that the first half's sums overlap the second's
//     copies), streams dy one batch of rows ahead, meets the other blocks at
//     a grid-wide barrier, then writes dx from the slice and a second read
//     of dy, which the L2 holds (dx is stored streaming): x read once, dy
//     twice, dx written once;
//   * two-pass (gn_bwd_partials_kernel, then gn_bwd_dx_kernel) for the
//     tensors whose slices do not fit: x and dy are read in both passes.
//     With ~128 registers a thread an SM holds one backward block, so the
//     grid is one wave of about a block per SM, each streaming its rows.
// Every sum is taken in a fixed order: the backward repeats bit for bit too.

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
      const float sig = __fdividef(1.f, 1.f + __expf(-z));  // 0 where exp(-z) overflows
      d = d * sig * (1.f + z * (1.f - sig));
    }
    dz[j] = d;
  }
}

// Calls f(x vector, dy vector, row) for each of this thread's rows in [row0,
// row1) (rows row0 + r, + R, ...), kUnroll rows at a time, dy from device
// memory. With kSmemX, x comes from the block's slice in shared memory (which
// starts at row `slice0`, row i at sx[i * V]) and the next kUnroll rows of dy
// are requested before the current ones are used; else x comes from device
// memory together with dy.
template <bool kSmemX, class F>
__device__ __forceinline__ void for_each_row(const __nv_bfloat16* x, const uint4* sx,
                                             const __nv_bfloat16* dy, size_t base, int slice0,
                                             int row0, int row1, int C, int R, int r, int V,
                                             int v, F&& f) {
  auto load = [&](const __nv_bfloat16* src, uint4* u, int row) {
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int rr = row + k * R;
      if (rr < row1) u[k] = *reinterpret_cast<const uint4*>(src + base + (size_t)rr * C);
    }
  };
  if constexpr (kSmemX) {
    uint4 cur[kUnroll], nxt[kUnroll];
    load(dy, cur, row0 + r);
    for (int row = row0 + r; row < row1; row += kUnroll * R) {
      load(dy, nxt, row + kUnroll * R);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int rr = row + k * R;
        if (rr < row1) f(sx[(rr - slice0) * V + v], cur[k], rr);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) cur[k] = nxt[k];
    }
  } else {
    for (int row = row0 + r; row < row1; row += kUnroll * R) {
      uint4 ud[kUnroll], ux[kUnroll];
      load(dy, ud, row);
      load(x, ux, row);
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int rr = row + k * R;
        if (rr < row1) f(ux[k], ud[k], rr);
      }
    }
  }
}

// Sums of dz (a1) and dz * xhat (a2) per channel over this thread's rows in
// [row0, row1) (x and dy as for_each_row gives them)
template <bool kSmemX>
__device__ __forceinline__ void bwd_tile_sums(const __nv_bfloat16* x, const uint4* sx,
                                              const __nv_bfloat16* dy, size_t base, int slice0,
                                              int row0, int row1, int C, int R, int r, int V,
                                              int v, const float* g8, const float* b8,
                                              const float* mu8, const float* rs8, int silu,
                                              float* a1, float* a2) {
  for_each_row<kSmemX>(x, sx, dy, base, slice0, row0, row1, C, R, r, V, v,
                       [&](const uint4& ux, const uint4& ud, int) {
                         float xhat[8], dz[8];
                         backward8(ux, ud, g8, b8, mu8, rs8, silu, xhat, dz);
#pragma unroll
                         for (int j = 0; j < 8; ++j) {
                           a1[j] += dz[j];
                           a2[j] += dz[j] * xhat[j];
                         }
                       });
}

// dx of this thread's rows in [row0, row1) (x and dy as for_each_row gives
// them), with the group means c1 (of dz gamma xhat) and c2 (of dz gamma) of
// its 8 channels
template <bool kSmemX>
__device__ __forceinline__ void bwd_tile_dx(const __nv_bfloat16* x, const uint4* sx,
                                            const __nv_bfloat16* dy, __nv_bfloat16* dx,
                                            size_t base, int slice0, int row0, int row1, int C,
                                            int R, int r, int V, int v, const float* g8,
                                            const float* b8, const float* mu8, const float* rs8,
                                            const float* c1, const float* c2, int silu) {
  // rs (dz gamma - c2 - xhat c1) = (rs gamma) dz + ((-rs c1) xhat + (-rs c2))
  float rg[8], rc1[8], rc2[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    rg[j] = rs8[j] * g8[j];
    rc1[j] = -rs8[j] * c1[j];
    rc2[j] = -rs8[j] * c2[j];
  }
  for_each_row<kSmemX>(x, sx, dy, base, slice0, row0, row1, C, R, r, V, v,
                       [&](const uint4& ux, const uint4& ud, int rr) {
                         float xhat[8], dz[8];
                         backward8(ux, ud, g8, b8, mu8, rs8, silu, xhat, dz);
#pragma unroll
                         for (int j = 0; j < 8; ++j)
                           dz[j] = fmaf(rg[j], dz[j], fmaf(rc1[j], xhat[j], rc2[j]));
                         // streaming store: dx is not read again, and should
                         // not push dy out of the L2 before its second read
                         __stcs(reinterpret_cast<uint4*>(dx + base + (size_t)rr * C), pack8(dz));
                       });
}

// The block's partial sums, from each thread's per-channel sums a1 (dz), a2
// (dz * xhat): the R rows of threads are added in a fixed order in `red` (R
// * 2 * C floats), then written per channel, pc[p * 2C + c] (dz) and pc[p *
// 2C + C + c] (dz * xhat), and per group, gp[p * G + g] (dz gamma xhat) and
// gp[(P + p) * G + g] (dz gamma), for block p = n * T + tile of P.
__device__ void bwd_block_partials(const float* a1, const float* a2, const float* gamma,
                                   float* red, int C, int G, int p, int P, float* pc,
                                   float* gp) {
  const int tid = threadIdx.x, V = C / 8, R = blockDim.x / V, v = tid % V, r = tid / V;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red[r * 2 * C + v * 8 + j] = a1[j];
    red[r * 2 * C + C + v * 8 + j] = a2[j];
  }
  __syncthreads();
  for (int i = tid; i < 2 * C; i += blockDim.x) {
    float s = red[i];
    for (int k = 1; k < R; ++k) s += red[k * 2 * C + i];
    pc[(size_t)p * 2 * C + i] = s;
    red[i] = s * gamma[i < C ? i : i - C];  // times gamma, for the group sums
  }
  __syncthreads();
  // a warp per group: lane l adds channels l, l + 32, ... of it, then the
  // lanes are added in a fixed tree (full warps only)
  const int cg = C / G, warp = tid / 32, lane = tid % 32, W = blockDim.x / 32;
  for (int g = warp; warp < W && g < G; g += W) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      s1 += red[C + c];
      s2 += red[c];
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      s2 += __shfl_xor_sync(0xffffffffu, s2, m);
    }
    if (lane == 0) {
      gp[(size_t)p * G + g] = s1;
      gp[((size_t)P + p) * G + g] = s2;
    }
  }
}

// c1[g] | c2[g] in `cc`: the T per-tile group partials of image n added in a
// fixed order (thread (g, k) adds tiles k, k + K, ..., then thread g its K
// sums in order, as fold_stats), over the count S * C / G. `scratch` holds
// 2 * blockDim.x floats. Ends synchronised.
__device__ void fold_group_partials(const float* gp, int n, int S, int C, int G, int T, int P,
                                    float* scratch, float* cc) {
  const int tid = threadIdx.x, K = blockDim.x / G;
  if (tid < K * G) {
    const int g = tid % G, k = tid / G;
    const float* p1 = gp + (size_t)n * T * G + g;
    const float* p2 = gp + ((size_t)P + (size_t)n * T) * G + g;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll 8
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
    cc[tid] = s1 * inv_count;
    cc[G + tid] = s2 * inv_count;
  }
  __syncthreads();
}

// dbeta[c] = sum over the P blocks of pc[p * 2C + c], dgamma[c] of pc[p * 2C
// + C + c]: the 2C columns in chunks of 32, chunk j taken by block j % blocks
// of the grid's `blocks`. Lane l of warp w adds column 32 j + l of blocks p =
// w, w + W, ... in order (each warp's loads coalesced), then warp 0 adds the
// W warps' sums in order through `scratch` (W * 32 floats).
__device__ void fold_param_partials(const float* pc, int C, int P, int bid, int blocks,
                                    float* scratch, float* dgamma, float* dbeta) {
  const int W = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ch = bid; ch * 32 < 2 * C; ch += blocks) {  // the same for every thread
    const int j = ch * 32 + lane;
    if (warp < W) {
      float s = 0.f;
      if (j < 2 * C) {
#pragma unroll 8
        for (int p = warp; p < P; p += W) s += __ldcg(pc + (size_t)p * 2 * C + j);
      }
      scratch[warp * 32 + lane] = s;
    }
    __syncthreads();
    if (warp == 0 && j < 2 * C) {
      float s = scratch[lane];
      for (int w = 1; w < W; ++w) s += scratch[w * 32 + lane];
      if (j < C) dbeta[j] = s;
      else dgamma[j - C] = s;
    }
    __syncthreads();
  }
}

// the c1 and c2 of thread vector v's 8 channels
__device__ __forceinline__ void channel_cc(const float* cc, int v, int C, int G, float* c1,
                                           float* c2) {
  const int cg = C / G;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int g = (v * 8 + j) / cg;
    c1[j] = cc[g];
    c2[j] = cc[G + g];
  }
}

// The cooperative backward, one launch: grid (T, N) with every block
// resident, block and shared memory as gn_resident_kernel (the slice in
// bf16, R * 2 * C floats of row reduction, mean[G] | rstd[G]). The block
// copies its slice of x into shared memory (cp.async) while it folds the
// forward's partial sums, streams dy for its partial sums, meets the other
// blocks at a grid-wide barrier, folds its image's group partials into c1,
// c2, writes dx from the slice and a second read of dy (the L2 holds it),
// then takes its share of the dgamma / dbeta folds.
__global__ void __launch_bounds__(512, 1)
gn_bwd_coop_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ dy,
                   const float* __restrict__ gamma, const float* __restrict__ beta,
                   const float* __restrict__ part1, const float* __restrict__ part2,
                   float* __restrict__ pc, float* __restrict__ gp, __nv_bfloat16* __restrict__ dx,
                   float* __restrict__ dgamma, float* __restrict__ dbeta, int N, int S, int C,
                   int G, int T_fwd, int T, int rows_per_tile, float eps, int silu) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile = blockIdx.x, n = blockIdx.y, p = n * T + tile, P = N * T;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  uint4* sx = reinterpret_cast<uint4*>(smem);  // row i of the slice at sx[i * V]
  float* red = reinterpret_cast<float*>(smem + (size_t)rows_per_tile * C * 2);
  float* stat = red + R * 2 * C;

  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  // the slice is copied in two halves (rows below `mid`, then the rest), so
  // that the first half's sums overlap the second half's copies; each thread
  // reads back only the vectors it copied itself
  const int mid = min(row1, row0 + R * ((row1 - row0 + 2 * R - 1) / (2 * R)));
  const size_t base = (size_t)n * S * C + v * 8;
  for (int row = row0 + r; row < row1; row += R) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     static_cast<uint32_t>(__cvta_generic_to_shared(sx + (row - row0) * V + v))),
                 "l"(x + base + (size_t)row * C)
                 : "memory");
    if (row + R >= mid && row < mid) asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  fold_stats(part1, part2, n, S, C, G, T_fwd, eps, red, stat);
  float g8[8], b8[8], mu8[8], rs8[8];
  channel_params(gamma, beta, stat, v, C, G, g8, b8, mu8, rs8);
  float a1[8] = {0.f}, a2[8] = {0.f};
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  bwd_tile_sums<true>(x, sx, dy, base, row0, row0, mid, C, R, r, V, v, g8, b8, mu8, rs8, silu, a1,
                      a2);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  bwd_tile_sums<true>(x, sx, dy, base, row0, mid, row1, C, R, r, V, v, g8, b8, mu8, rs8, silu, a1,
                      a2);
  bwd_block_partials(a1, a2, gamma, red, C, G, p, P, pc, gp);

  cooperative_groups::this_grid().sync();  // every block's partials are written

  float* cc = red + 2 * blockDim.x;  // red is free again: the fold's scratch, then c1 | c2
  fold_group_partials(gp, n, S, C, G, T, P, red, cc);
  float c1[8], c2[8];
  channel_cc(cc, v, C, G, c1, c2);
  bwd_tile_dx<true>(x, sx, dy, dx, base, row0, row0, row1, C, R, r, V, v, g8, b8, mu8, rs8, c1, c2,
                    silu);
  fold_param_partials(pc, C, P, p, P, red, dgamma, dbeta);  // c1, c2 are in registers now
}

// Two-pass backward, pass 1: grid (T, N); block as in gn_stats_kernel.
// Folds the forward's partial sums (T_fwd tiles) into mean | rstd, streams x
// and dy of its tile and writes its partials (bwd_block_partials). Dynamic
// shared memory: R * 2 * C floats (the fold's scratch, then the row
// reduction), then mean[G] | rstd[G].
__global__ void gn_bwd_partials_kernel(const __nv_bfloat16* __restrict__ x,
                                       const __nv_bfloat16* __restrict__ dy,
                                       const float* __restrict__ gamma,
                                       const float* __restrict__ beta,
                                       const float* __restrict__ part1,
                                       const float* __restrict__ part2, float* __restrict__ pc,
                                       float* __restrict__ gp, int S, int C, int G, int T_fwd,
                                       int T, int rows_per_tile, float eps, int silu) {
  extern __shared__ float sm[];
  const int tile = blockIdx.x, n = blockIdx.y;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  float* red = sm;
  float* stat = sm + R * 2 * C;
  fold_stats(part1, part2, n, S, C, G, T_fwd, eps, red, stat);
  float g8[8], b8[8], mu8[8], rs8[8];
  channel_params(gamma, beta, stat, v, C, G, g8, b8, mu8, rs8);
  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  float a1[8] = {0.f}, a2[8] = {0.f};
  bwd_tile_sums<false>(x, nullptr, dy, (size_t)n * S * C + v * 8, row0, row0, row1, C, R, r, V,
                       v, g8, b8, mu8, rs8, silu, a1, a2);
  bwd_block_partials(a1, a2, gamma, red, C, G, n * T + tile, gridDim.y * T, pc, gp);
}

// Two-pass backward, pass 2: grid (T, N); block as in gn_stats_kernel.
// Folds the forward's partial sums and its image's group partials (c1, c2),
// writes dx of its tile, then takes its share of the dgamma / dbeta folds.
// Dynamic shared memory: mean[G] | rstd[G] | c1[G] | c2[G], then the folds'
// 2 * blockDim.x floats.
__global__ void gn_bwd_dx_kernel(const __nv_bfloat16* __restrict__ x,
                                 const __nv_bfloat16* __restrict__ dy,
                                 const float* __restrict__ gamma, const float* __restrict__ beta,
                                 const float* __restrict__ part1,
                                 const float* __restrict__ part2, const float* __restrict__ pc,
                                 const float* __restrict__ gp, __nv_bfloat16* __restrict__ dx,
                                 float* __restrict__ dgamma, float* __restrict__ dbeta, int S,
                                 int C, int G, int T_fwd, int T, int rows_per_tile, float eps,
                                 int silu) {
  extern __shared__ float sm[];
  float* stat = sm;        // mean[G] | rstd[G]
  float* cc = sm + 2 * G;  // c1[G] | c2[G]
  float* scratch = sm + 4 * G;
  const int tile = blockIdx.x, n = blockIdx.y, P = gridDim.y * T;
  const int V = C / 8, R = blockDim.x / V, v = threadIdx.x % V, r = threadIdx.x / V;
  fold_stats(part1, part2, n, S, C, G, T_fwd, eps, scratch, stat);
  fold_group_partials(gp, n, S, C, G, T, P, scratch, cc);
  float g8[8], b8[8], mu8[8], rs8[8], c1[8], c2[8];
  channel_params(gamma, beta, stat, v, C, G, g8, b8, mu8, rs8);
  channel_cc(cc, v, C, G, c1, c2);
  const int row0 = tile * rows_per_tile;
  const int row1 = min(S, row0 + rows_per_tile);
  bwd_tile_dx<false>(x, nullptr, dy, dx, (size_t)n * S * C + v * 8, row0, row0, row1, C, R, r, V,
                     v, g8, b8, mu8, rs8, c1, c2, silu);
  fold_param_partials(pc, C, P, n * T + tile, P, scratch, dgamma, dbeta);
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

// K1b on `T` tiles of `rows_per_tile` rows, reading the forward's partial
// sums (T_fwd tiles): with `coop`, one cooperative launch of
// gn_bwd_coop_kernel (the forward's resident tiling; refused with
// cudaErrorCooperativeLaunchTooLarge when the T * N blocks cannot all be
// resident), else gn_bwd_partials_kernel then gn_bwd_dx_kernel (ops/
// group_norm.py `backward_plan`). `scratch` holds 2 * C * P + 2 * P * G
// floats, P = N * T.
extern "C" int gn_backward(const void* x, const void* dy, const void* gamma, const void* beta,
                           const void* part1, const void* part2, void* scratch, void* dx,
                           void* dgamma, void* dbeta, int N, int S, int C, int G, int T_fwd,
                           int T, int rows_per_tile, float eps, int silu, int coop,
                           void* stream) {
  const int threads = block_threads(C);
  const int R = threads / (C / 8);
  cudaStream_t st = (cudaStream_t)stream;
  float* pc = (float*)scratch;
  float* gp = pc + (size_t)2 * C * N * T;
  if (coop) {
    const size_t smem = (size_t)rows_per_tile * C * 2 + (size_t)R * 2 * C * sizeof(float) +
                        2 * G * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(gn_bwd_coop_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    void* args[] = {(void*)&x, (void*)&dy, (void*)&gamma, (void*)&beta, (void*)&part1,
                    (void*)&part2, &pc, &gp, &dx, &dgamma, &dbeta, &N, &S, &C, &G, &T_fwd, &T,
                    &rows_per_tile, &eps, &silu};
    return (int)cudaLaunchCooperativeKernel((const void*)gn_bwd_coop_kernel, dim3(T, N),
                                            dim3(threads), args, smem, st);
  }
  const dim3 grid(T, N);
  gn_bwd_partials_kernel<<<grid, threads, (R * 2 * C + 2 * G) * sizeof(float), st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, pc, gp, S, C, G, T_fwd, T, rows_per_tile, eps,
      silu);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gn_bwd_dx_kernel<<<grid, threads, (4 * G + 2 * threads) * sizeof(float), st>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)dy, (const float*)gamma, (const float*)beta,
      (const float*)part1, (const float*)part2, pc, gp, (__nv_bfloat16*)dx, (float*)dgamma,
      (float*)dbeta, S, C, G, T_fwd, T, rows_per_tile, eps, silu);
  return (int)cudaGetLastError();
}
