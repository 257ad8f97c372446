// The group aligner's per-pixel objective and its gradient in one pass
// (alignment/optimizer.py `GroupAligner.loss_fn`, through
// ops/align_objective.py).
//
// Replaces no TPU kernel: the JAX package leaves the objective to XLA, which
// fuses it. Eager PyTorch ran it as ~80 pixel-sized ops, two gathers whose
// backward adds atomically, and two f32 GEMMs with K = 3 whose weight
// gradients (3x3 outputs reduced over every pixel) ran on one output tile.
//
// For frame n, pixel p = (u, v) and each (window g, slot) entry e of frame n:
//   z = exp(log_depth[n, p]),  rel = (z (u - cx) / f_n, z (v - cy) / f_n, z),
//   proj = R_n rel + t_n,  aligned = M_g pred[e, p] + b_g  (M_g | b_g: the
//   window's sim3 rows, scale included),  d = proj - aligned,
//   loss += w sqrt(|d|^2 + 1e-12) / A  with w = min(weights[e, p], clamp);
//   with the depth term, r = 1 / (z + 1e-6) - (invdepth[e, p] s_g + t_g),
//   m = (invdepth[e, p] > thr) valid_g,  loss += depth_weight |r| m / A.
// Gradients: d log_depth (N, P), written per pixel; per frame d(R_n | t_n)
// and d f_n; per window d(M_g | b_g), d s_g and d t_g. |r|'(0) = 0.
//
// Bound: device memory. Per (entry, pixel) it reads the window point (12 B),
// the weight (4 B) and, with the depth term, the inverse depth (4 B); per
// (frame, pixel) it reads log_depth and writes d log_depth (8 B): 227 MB
// without and 274 MB with the depth term at 32 frames of 256x576 in 5 windows
// of 16, 68 / 82 us at 3.35 TB/s, against ~60 flops per (entry, pixel).
//
// Design: a block of 256 threads owns 1024 pixels of one frame, 4 a thread,
// neighbouring threads on neighbouring pixels. Its warps walk the frame's
// entries in a fixed order (the CSR map: windows ascending), each loading all
// of an entry's pixels before any arithmetic and keeping each pixel's running
// sum of weighted unit residuals in registers, so that d log_depth needs no
// gather backward and no atomics. A warp sums an entry's window gradient (14
// values) by a shuffle tree into shared memory and goes on without waiting;
// the block folds its 8 warps' sums in order once per chunk of 32 entries (a
// barrier per entry left the memory idle while the block waited: 27-29% of
// the bound, against ~70% for the loss alone). After the last entry the
// frame's pose and focal gradient and the two loss sums are folded likewise.
// A second launch folds the blocks' partials in a fixed order. IEEE float32
// throughout (expf, sqrtf and division at full precision; built without
// fast-math): two launches on the same input give the same bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 4;                      // pixels a thread
constexpr int kBlockPix = kThreads * kPix;   // ops/align_objective.py BLOCK_PIXELS
constexpr int kFrameVals = 16;  // a frame partial: loss sums 2, d(R | t) 12, d f 1, unused 1
constexpr int kEntryVals = 14;  // an entry partial: d(M | b) 12, d s, d t
constexpr int kChunk = 32;      // entries whose warp sums shared memory holds at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums v[0..K) over the block's threads in a fixed order (a shuffle tree in
// each warp, then the warps in order) and writes the K sums to out.
template <int K>
__device__ __forceinline__ void block_sum(float (&v)[K], float* out, float (*red)[16]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) v[k] = warp_sum(v[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < K) {
    float s = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// grid (B, N): block b of frame n. fpart (N, B, kFrameVals), epart (E, B,
// kEntryVals), written once each; with kGrad also dlog_depth (N, P).
// Each warp goes through the frame's entries on its own: its sums of an
// entry's window gradient go to shared memory (a shuffle tree), and the
// block folds them over its warps once a chunk of kChunk entries is done.
template <bool kDepth, bool kGrad>
__global__ void __launch_bounds__(kThreads) align_objective_kernel(
    const float* __restrict__ log_depth, const float* __restrict__ focal, int focal_stride,
    const float* __restrict__ poses, int pose_stride, const float* __restrict__ sims,
    const float* __restrict__ s_depth, const float* __restrict__ t_depth,
    const float* __restrict__ valid, const float* __restrict__ pred,
    const float* __restrict__ weights, const float* __restrict__ invdepth,
    const int* __restrict__ frame_ptr, const int* __restrict__ entries, int P, int W, int S,
    float cx, float cy, float clamp, float thr, float inv_area, float depth_scale,
    float* __restrict__ fpart, float* __restrict__ epart, float* __restrict__ dlog_depth) {
  __shared__ float red[kWarps][16];
  __shared__ float chunk[kGrad ? kChunk : 1][kWarps][kEntryVals];
  const int n = blockIdx.y, b = blockIdx.x, B = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float f = focal[(size_t)n * focal_stride];
  float R[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) R[i][j] = poses[(size_t)n * pose_stride + i * 4 + j];

  const int p0 = b * kBlockPix + threadIdx.x;   // pixel i of the thread: p0 + i * kThreads
  float z[kPix], proj[kPix][3], G[kPix][3], sgn_sum[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = p0 + i * kThreads;
    G[i][0] = G[i][1] = G[i][2] = 0.f;
    sgn_sum[i] = 0.f;
    z[i] = p < P ? expf(log_depth[(size_t)n * P + p]) : 0.f;
    const float rx = z[i] * ((float)(p % W) - cx) / f;
    const float ry = z[i] * ((float)(p / W) - cy) / f;
#pragma unroll
    for (int r = 0; r < 3; ++r) proj[i][r] = R[r][0] * rx + R[r][1] * ry + R[r][2] * z[i] + R[r][3];
  }

  float loss[2] = {0.f, 0.f};
  const int j0 = frame_ptr[n], j1 = frame_ptr[n + 1];
  for (int c0 = j0; c0 < j1; c0 += kChunk) {
    const int c1 = min(j1, c0 + kChunk);
    for (int j = c0; j < c1; ++j) {
      const int e = entries[j], g = e / S;
      float M[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) M[k] = sims[(size_t)g * 12 + k];
      float sg = 0.f, tg = 0.f, vg = 0.f;
      if (kDepth) {
        sg = s_depth[g];
        tg = t_depth[g];
        vg = valid[g];
      }
      // every load of the entry first, then the arithmetic
      float x[kPix], y[kPix], w0[kPix], wt[kPix], id[kPix];
      const float* pe = pred + (size_t)e * P * 3;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const int p = p0 + i * kThreads;
        const bool in = p < P;
        x[i] = in ? pe[3 * (size_t)p] : 0.f;
        y[i] = in ? pe[3 * (size_t)p + 1] : 0.f;
        w0[i] = in ? pe[3 * (size_t)p + 2] : 0.f;
        wt[i] = in ? weights[(size_t)e * P + p] : 0.f;     // 0: an out-of-range pixel adds 0
        if (kDepth) id[i] = in ? invdepth[(size_t)e * P + p] : 0.f;
      }
      float acc[kEntryVals];
#pragma unroll
      for (int k = 0; k < kEntryVals; ++k) acc[k] = 0.f;
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        const float w = wt[i] > clamp ? clamp : wt[i];
        float d[3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
          d[r] = proj[i][r] -
                 (M[4 * r] * x[i] + M[4 * r + 1] * y[i] + M[4 * r + 2] * w0[i] + M[4 * r + 3]);
        const float nrm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + 1e-12f);
        loss[0] += w * nrm;
        if (kGrad) {
          const float c = w * inv_area / nrm;
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float q = c * d[r];
            G[i][r] += q;
            acc[4 * r] -= q * x[i];
            acc[4 * r + 1] -= q * y[i];
            acc[4 * r + 2] -= q * w0[i];
            acc[4 * r + 3] -= q;
          }
        }
        if (kDepth) {
          // the scaled disparity rounded after the product, as PyTorch's
          // separate ops round it (a contracted multiply-add flips the sign
          // of residuals that are exactly 0 in real arithmetic)
          const float m = (p0 + i * kThreads < P && id[i] > thr ? 1.f : 0.f) * vg;
          const float r = 1.f / (z[i] + 1e-6f) - __fadd_rn(__fmul_rn(id[i], sg), tg);
          loss[1] += fabsf(r) * m;
          if (kGrad) {
            const float sgn = r > 0.f ? m : (r < 0.f ? -m : 0.f);
            sgn_sum[i] += sgn;
            acc[12] -= sgn * depth_scale * id[i];
            acc[13] -= sgn * depth_scale;
          }
        }
      }
      if (kGrad) {
#pragma unroll
        for (int k = 0; k < kEntryVals; ++k) acc[k] = warp_sum(acc[k]);
        if (lane == 0) {
#pragma unroll
          for (int k = 0; k < kEntryVals; ++k) chunk[j - c0][warp][k] = acc[k];
        }
      }
    }
    if (kGrad) {
      __syncthreads();
      for (int t = threadIdx.x; t < (c1 - c0) * kEntryVals; t += kThreads) {
        const int slot = t / kEntryVals, k = t % kEntryVals;
        float s = chunk[slot][0][k];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += chunk[slot][w][k];
        epart[((size_t)entries[c0 + slot] * B + b) * kEntryVals + k] = s;
      }
      __syncthreads();
    }
  }

  float* fp = fpart + ((size_t)n * B + b) * kFrameVals;
  if (!kGrad) {
    block_sum<2>(loss, fp, red);
    return;
  }
  float fr[15];
  fr[0] = loss[0];
  fr[1] = loss[1];
#pragma unroll
  for (int k = 2; k < 15; ++k) fr[k] = 0.f;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const int p = p0 + i * kThreads;
    if (p >= P) continue;
    const float rel[3] = {z[i] * ((float)(p % W) - cx) / f, z[i] * ((float)(p / W) - cy) / f,
                          z[i]};
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      fr[2 + 4 * r] += G[i][r] * rel[0];
      fr[3 + 4 * r] += G[i][r] * rel[1];
      fr[4 + 4 * r] += G[i][r] * rel[2];
      fr[5 + 4 * r] += G[i][r];
    }
    // d loss / d rel = R^T G
    float a[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) a[c] = R[0][c] * G[i][0] + R[1][c] * G[i][1] + R[2][c] * G[i][2];
    fr[14] -= (a[0] * rel[0] + a[1] * rel[1]) / f;
    float dl = a[0] * rel[0] + a[1] * rel[1] + a[2] * rel[2];
    if (kDepth) {
      const float inv = 1.f / (z[i] + 1e-6f);
      dl += sgn_sum[i] * depth_scale * -(inv * inv) * z[i];
    }
    dlog_depth[(size_t)n * P + p] = dl;
  }
  block_sum<15>(fr, fp, red);
}

constexpr int kFoldThreads = 1024;

// Sums K values over `items` rows of `stride` floats at base, in a fixed
// order: each thread its strided rows, a shuffle tree in each warp, then the
// warps in order. Thread k < K returns sum k; the others return 0.
template <int K>
__device__ float fold(const float* __restrict__ base, int stride, int items, float (*red)[16]) {
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.f;
  for (int i = threadIdx.x; i < items; i += kFoldThreads)
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += base[(size_t)i * stride + k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < K) {
    s = red[0][threadIdx.x];
    for (int w = 1; w < kFoldThreads / 32; ++w) s += red[w][threadIdx.x];
  }
  return s;
}

// Block 0: the loss; with grad, blocks 1..N frame n's d(R | t) and d f,
// blocks N+1..N+G window g's d(M | b), d s and d t (its entries g S .. g S +
// S - 1, slots in order).
__global__ void __launch_bounds__(kFoldThreads) align_objective_fold_kernel(
    const float* __restrict__ fpart, const float* __restrict__ epart, int N, int G, int S, int B,
    float area, float depth_weight, float* __restrict__ loss, float* __restrict__ dposes,
    float* __restrict__ dfocal, float* __restrict__ dsims, float* __restrict__ ds,
    float* __restrict__ dt) {
  __shared__ float red[kFoldThreads / 32][16];
  __shared__ float l2;
  const int blk = blockIdx.x, k = threadIdx.x;
  if (blk == 0) {
    const float v = fold<2>(fpart, kFrameVals, N * B, red);
    if (k == 1) l2 = v;
    __syncthreads();
    if (k == 0) loss[0] = v / area + l2 / area * depth_weight;
  } else if (blk <= N) {
    const int n = blk - 1;
    const float v = fold<13>(fpart + (size_t)n * B * kFrameVals + 2, kFrameVals, B, red);
    if (k < 12) dposes[(size_t)n * 12 + k] = v;
    if (k == 12) dfocal[n] = v;
  } else {
    const int g = blk - 1 - N;
    const float v =
        fold<kEntryVals>(epart + (size_t)g * S * B * kEntryVals, kEntryVals, S * B, red);
    if (k < 12) dsims[(size_t)g * 12 + k] = v;
    if (k == 12) ds[g] = v;
    if (k == 13) dt[g] = v;
  }
}

template <bool kDepth, bool kGrad>
void launch(dim3 grid, cudaStream_t st, const float* log_depth, const float* focal,
            int focal_stride, const float* poses, int pose_stride, const float* sims,
            const float* s_depth, const float* t_depth, const float* valid, const float* pred,
            const float* weights, const float* invdepth, const int* frame_ptr,
            const int* entries, int P, int W, int S, float cx, float cy, float clamp, float thr,
            float inv_area, float depth_scale, float* fpart, float* epart, float* dlog_depth) {
  align_objective_kernel<kDepth, kGrad><<<grid, kThreads, 0, st>>>(
      log_depth, focal, focal_stride, poses, pose_stride, sims, s_depth, t_depth, valid, pred,
      weights, invdepth, frame_ptr, entries, P, W, S, cx, cy, clamp, thr, inv_area, depth_scale,
      fpart, epart, dlog_depth);
}

}  // namespace

// The objective at the given parameters, and with `grad` its gradient:
// `partials` holds N * B * 16 + G * S * B * 14 floats (B = ceil(P / 1024));
// `grad_out` (with grad) d log_depth (N * P), d(R | t) (N * 12), d f (N),
// d(M | b) (G * 12), d s (G), d t (G), in that order; `loss` one float.
// Entries are e = g * S + slot; frame n's are entries[frame_ptr[n] ..
// frame_ptr[n + 1]). Two launches.
extern "C" int align_objective(const void* log_depth, const void* focal, int focal_stride,
                               const void* poses, int pose_stride, const void* sims,
                               const void* s_depth, const void* t_depth, const void* valid,
                               const void* pred, const void* weights, const void* invdepth,
                               const void* frame_ptr, const void* entries, int N, int P, int W,
                               int G, int S, float cx, float cy, float clamp, float thr,
                               float area, float depth_weight, int depth, int grad,
                               void* partials, void* grad_out, void* loss, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int B = (P + kBlockPix - 1) / kBlockPix;
  float* fpart = (float*)partials;
  float* epart = fpart + (size_t)N * B * kFrameVals;
  float* dld = (float*)grad_out;
  const float inv_area = 1.f / area, depth_scale = depth_weight / area;
  const dim3 grid(B, N);
#define ALIGN_OBJECTIVE_ARGS                                                                   \
  grid, st, (const float*)log_depth, (const float*)focal, focal_stride, (const float*)poses,   \
      pose_stride, (const float*)sims, (const float*)s_depth, (const float*)t_depth,           \
      (const float*)valid, (const float*)pred, (const float*)weights, (const float*)invdepth,  \
      (const int*)frame_ptr, (const int*)entries, P, W, S, cx, cy, clamp, thr, inv_area,       \
      depth_scale, fpart, epart, dld
  if (depth && grad) launch<true, true>(ALIGN_OBJECTIVE_ARGS);
  else if (depth) launch<true, false>(ALIGN_OBJECTIVE_ARGS);
  else if (grad) launch<false, true>(ALIGN_OBJECTIVE_ARGS);
  else launch<false, false>(ALIGN_OBJECTIVE_ARGS);
#undef ALIGN_OBJECTIVE_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  float* dposes = grad ? dld + (size_t)N * P : nullptr;
  float* dfocal = grad ? dposes + (size_t)N * 12 : nullptr;
  float* dsims = grad ? dfocal + N : nullptr;
  float* ds = grad ? dsims + (size_t)G * 12 : nullptr;
  float* dt = grad ? ds + G : nullptr;
  align_objective_fold_kernel<<<grad ? 1 + N + G : 1, kFoldThreads, 0, st>>>(
      fpart, epart, N, G, S, B, area, depth ? depth_weight : 0.f, (float*)loss, dposes, dfocal,
      dsims, ds, dt);
  return (int)cudaGetLastError();
}
