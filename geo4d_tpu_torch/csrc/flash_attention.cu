// Unmasked multi-head attention softmax(q k^T / sqrt(D)) v over (B, N, H, D)
// bf16 tensors, D = 64: f32 logits and softmax statistics, bf16 P for the
// P.V product, bf16 output.
//
// Replaces the TPU kernel geo4d_tpu/ops/flash_attention.py `_attn_kernel`
// (launched by `_flash_bhnd`). That kernel held all of K and V for one
// (batch, head) in VMEM and took one exact softmax per q-block. On Hopper a
// block has at most 227 KB of shared memory, and K+V at N = 2304, D = 64 is
// 590 KB, so this kernel streams 64-key K/V tiles through shared memory with
// an online softmax (running max and sum, rescaling the accumulator). Its
// rounding therefore differs slightly from one exact softmax: P is rounded
// to bf16 before it is normalised, not after.
//
// Bound: at the UNet's spatial shapes (Nq = Nk = 2304 or 576) the two
// products dominate (4 * Nq * Nk * D flops per (b, h)); K/V tiles are re-read
// once per 64-query tile, mostly from L2. The products run on the tensor
// cores through WMMA bf16 fragments (mma.sync underneath), one 16-row strip
// of the q tile per warp. Later work: wgmma, TMA and a deeper K/V pipeline.
//
// Layout: q/o (B, Nq, H, D), k/v (B, Nk, H, D), contiguous, read in place at
// row stride H * D (no head transpose). One block per (q tile, h, b).
// Requires Nq % 64 == 0; any Nk >= 1 (the last K tile is masked), which
// covers the 16-token image stream as a single tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int kD = 64;       // head dim
constexpr int kBQ = 64;      // q rows per block (16 per warp)
constexpr int kBK = 64;      // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kLdKV = kD + 8;   // bf16 row stride of the K/V tiles
constexpr int kLdS = kBK + 4;   // f32 row stride of a warp's logits strip
constexpr int kLdP = kBK + 8;   // bf16 row stride of a warp's P strip

__global__ void __launch_bounds__(kWarps * 32)
flash_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int Nq, int Nk, int H,
                  float scale_log2) {
  __shared__ __align__(128) __nv_bfloat16 sK[kBK * kLdKV];
  __shared__ __align__(128) __nv_bfloat16 sV[kBK * kLdKV];
  __shared__ __align__(128) float sS[kWarps * 16 * kLdS];
  __shared__ __align__(128) __nv_bfloat16 sP[kWarps * 16 * kLdP];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ld = H * kD;  // row stride of q/k/v/o in elements
  const __nv_bfloat16* qb = q + ((size_t)b * Nq * H + h) * kD;
  const __nv_bfloat16* kb = k + ((size_t)b * Nk * H + h) * kD;
  const __nv_bfloat16* vb = v + ((size_t)b * Nk * H + h) * kD;
  const int qrow0 = qt * kBQ + warp * 16;

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[kD / 16];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], qb + (size_t)qrow0 * ld + kk * 16, ld);

  float* sSw = sS + warp * 16 * kLdS;
  __nv_bfloat16* sPw = sP + warp * 16 * kLdP;
  // softmax / output ownership: lane -> row r of the warp's strip, half of
  // the 64 columns
  const int r = lane >> 1, half = lane & 1;
  float m = -INFINITY, l = 0.f;
  float acc[32];
#pragma unroll
  for (int c = 0; c < 32; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < Nk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = tid; i < kBK * (kD / 8); i += kWarps * 32) {
      const int row = i / (kD / 8), c8 = i % (kD / 8);
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + row < Nk) {
        kv = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + row) * ld + c8 * 8);
        vv = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + row) * ld + c8 * 8);
      }
      *reinterpret_cast<uint4*>(sK + row * kLdKV + c8 * 8) = kv;
      *reinterpret_cast<uint4*>(sV + row * kLdKV + c8 * 8) = vv;
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows: 16 x 64 f32
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + (j * 16) * kLdKV + kk * 16, kLdKV);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sSw + j * 16, sf, kLdS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this tile, in the log2 domain
    float s[32];
    float mx = -INFINITY;
    const float* srow = sSw + r * kLdS + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      float val = srow[c] * scale_log2;
      if (k0 + half * 32 + c >= Nk) val = -INFINITY;
      s[c] = val;
      mx = fmaxf(mx, val);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);  // finite: the tile has a valid key
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = sPw + r * kLdP + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(s[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();

    // PV = P V: 16 x 64 f32, staged through the logits strip
#pragma unroll
    for (int j = 0; j < kD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sPw + kk * 16, kLdP);
        wmma::load_matrix_sync(vf, sV + (kk * 16) * kLdKV + j * 16, kLdKV);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(sSw + j * 16, of, kLdS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* pv = sSw + r * kLdS + half * 32;
#pragma unroll
    for (int c = 0; c < 32; ++c) acc[c] = acc[c] * alpha + pv[c];
  }

  const float inv = 1.f / l;
  __nv_bfloat16* orow = o + ((size_t)(b * Nq + qrow0 + r) * H + h) * kD + half * 32;
#pragma unroll
  for (int c8 = 0; c8 < 4; ++c8) {
    uint4 u;
    __nv_bfloat162* hp = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hp[j] = __floats2bfloat162_rn(acc[c8 * 8 + 2 * j] * inv, acc[c8 * 8 + 2 * j + 1] * inv);
    *reinterpret_cast<uint4*>(orow + c8 * 8) = u;
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int Nq, int Nk, int H,
                               float scale, void* stream) {
  dim3 grid(Nq / kBQ, H, B);
  flash_attn_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, Nq, Nk, H,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
