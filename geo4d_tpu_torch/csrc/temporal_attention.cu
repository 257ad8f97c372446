// Per-pixel temporal self-attention on the heads-packed layout: q, k, v and
// o are (P, N, C) bf16 with C = heads * Dh, straight off the QKV
// projections. Each (pixel, head) is an independent N x N attention
// (N = 16 frames on the main path): f32 logits, f32 softmax, weights rounded
// to bf16 before the weighted sum (as the JAX path casts them), bf16 output.
//
// Replaces the TPU kernel geo4d_tpu/ops/temporal_attention.py `_kernel`
// (launched by `_packed`). The TPU kernel packed 8 pixels into a
// block-diagonal 128 x 128 tile to fill the MXU; that trick is not needed
// here and is not carried over.
//
// Bound: device-memory bandwidth. The op moves 4 * P * N * C * 2 bytes (read
// q, k, v, write o) against 4 * N * N * Dh flops per (pixel, head), far below
// the card's flop-per-byte balance, so it runs on the CUDA cores. One warp
// owns one (pixel, head): it copies the N x Dh slices of q, k, v into shared
// memory with 16-byte loads (each slice row is Dh contiguous bf16 at row
// stride C), computes the N x N logits, the row softmax and the N x Dh output
// from shared memory, and writes the output two channels per lane so that a
// warp stores whole 128-byte rows. K rows are padded by one 32-bit word so
// that lanes reading different keys hit different banks.
//
// Limits: N <= 32, Dh <= 128, Dh % 8 == 0, C % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;

__global__ void __launch_bounds__(kWarps * 32)
temporal_attn_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int P, int N, int C,
                     int Dh, float scale, int warp_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int heads = C / Dh;
  const long job = (long)blockIdx.x * kWarps + warp;
  if (job >= (long)P * heads) return;  // no block-wide barrier below
  const int p = (int)(job / heads), hd = (int)(job % heads);

  const int ld = Dh + 2;  // bf16 row stride in shared memory (odd word count)
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + warp * warp_bytes);
  __nv_bfloat16* sk = sq + N * ld;
  __nv_bfloat16* sv = sk + N * ld;
  float* sS = reinterpret_cast<float*>(sv + N * ld);  // N x N, 4-byte aligned

  const size_t base = (size_t)p * N * C + (size_t)hd * Dh;
  const int chunks = Dh / 8;  // 16-byte chunks per row
  for (int i = lane; i < N * chunks; i += 32) {
    const int row = i / chunks, c8 = i % chunks;
    const size_t g = base + (size_t)row * C + c8 * 8;
    const uint4 uq = *reinterpret_cast<const uint4*>(q + g);
    const uint4 uk = *reinterpret_cast<const uint4*>(k + g);
    const uint4 uv = *reinterpret_cast<const uint4*>(v + g);
    uint32_t* dq = reinterpret_cast<uint32_t*>(sq + row * ld + c8 * 8);
    uint32_t* dk = reinterpret_cast<uint32_t*>(sk + row * ld + c8 * 8);
    uint32_t* dv = reinterpret_cast<uint32_t*>(sv + row * ld + c8 * 8);
    dq[0] = uq.x; dq[1] = uq.y; dq[2] = uq.z; dq[3] = uq.w;
    dk[0] = uk.x; dk[1] = uk.y; dk[2] = uk.z; dk[3] = uk.w;
    dv[0] = uv.x; dv[1] = uv.y; dv[2] = uv.z; dv[3] = uv.w;
  }
  __syncwarp();

  // logits S[i][j] = q_i . k_j * scale
  const int half_d = Dh / 2;
  for (int idx = lane; idx < N * N; idx += 32) {
    const int i = idx / N, j = idx % N;
    const __nv_bfloat162* qi = reinterpret_cast<const __nv_bfloat162*>(sq + i * ld);
    const __nv_bfloat162* kj = reinterpret_cast<const __nv_bfloat162*>(sk + j * ld);
    float acc = 0.f;
    for (int c = 0; c < half_d; ++c) {
      const float2 a = __bfloat1622float2(qi[c]);
      const float2 b = __bfloat1622float2(kj[c]);
      acc = fmaf(a.x, b.x, acc);
      acc = fmaf(a.y, b.y, acc);
    }
    sS[idx] = acc * scale;
  }
  __syncwarp();

  // row softmax, one lane per query row
  if (lane < N) {
    float* row = sS + lane * N;
    float mx = -INFINITY;
    for (int j = 0; j < N; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < N; ++j) {
      const float e = expf(row[j] - mx);
      row[j] = e;
      sum += e;
    }
    const float inv = 1.f / sum;
    for (int j = 0; j < N; ++j)
      row[j] = __bfloat162float(__float2bfloat16(row[j] * inv));
  }
  __syncwarp();

  // out[i][2c:2c+2] = sum_j w[i][j] * v[j][2c:2c+2]
  for (int idx = lane; idx < N * half_d; idx += 32) {
    const int i = idx / half_d, c = idx % half_d;
    const float* w = sS + i * N;
    float ax = 0.f, ay = 0.f;
    for (int j = 0; j < N; ++j) {
      const float2 b = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(sv + j * ld)[c]);
      ax = fmaf(w[j], b.x, ax);
      ay = fmaf(w[j], b.y, ay);
    }
    reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)i * C)[c] =
        __floats2bfloat162_rn(ax, ay);
  }
}

}  // namespace

extern "C" int temporal_attention(const void* q, const void* k, const void* v,
                                  void* o, int P, int N, int C, int Dh,
                                  float scale, void* stream) {
  const int ld = Dh + 2;
  int warp_bytes = 3 * N * ld * 2 + N * N * 4;
  warp_bytes = (warp_bytes + 15) / 16 * 16;
  const int smem = kWarps * warp_bytes;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        temporal_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int heads = C / Dh;
  const long jobs = (long)P * heads;
  const int blocks = (int)((jobs + kWarps - 1) / kWarps);
  temporal_attn_kernel<<<blocks, kWarps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, P, N, C, Dh, scale,
      warp_bytes);
  return (int)cudaGetLastError();
}
