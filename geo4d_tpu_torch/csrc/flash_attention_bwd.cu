// Backward of the unmasked multi-head attention of csrc/flash_attention.cu
// (K2b): dq, dk and dv of o = softmax(q k^T s) v over (B, N, H, 64) bf16
// tensors, for the cotangent dO, from q, k, v, o and the forward's f32
// log-sum-exp per (b, h, query).
//
// No TPU kernel had a backward: the JAX package differentiates its XLA path
// (geo4d_tpu/nn/attention.py::dot_product_attention, whose forward the TPU
// kernel geo4d_tpu/ops/flash_attention.py `_attn_kernel` computes). The
// algebra follows that forward's semantics: the weights P = exp(q k^T s -
// lse) are rounded to bf16 before they multiply v, so dV = bf16(P)^T dO,
// and the gradient passes through the cast unchanged: dP = dO v^T,
// dS = P (dP - delta) with delta = rowsum(dO o), dq = dS k s, dk = dS^T q s.
//
// Bound: the products, 2.5x the forward's operations (8 * Nq * Nk * 64 per
// (b, h) across the two key-side and three query-side products, plus
// recomputing P twice). This first version is after FlashAttention-2 and
// keeps to mma.sync on register fragments (the operand layouts of
// csrc/temporal_attention.cu):
//   * `delta_kernel`: delta per row, one thread per (b, query, h);
//   * `dkdv_kernel`: one block of 4 warps per (64-key tile, h, b); warp w
//     owns 16 keys, keeps their K and V fragments in registers and dK, dV in
//     f32 accumulators, and streams the 64-query tiles of q and dO through
//     two shared-memory stages (cp.async). It computes S^T = K q^T and
//     dP^T = V dO^T directly, so P^T and dS^T come out of the accumulators
//     in the A-operand layout of dV += P^T dO and dK += dS^T q;
//   * `dq_kernel`: one block per (64-query tile, h, b); warp w owns 16
//     queries, keeps their q and dO fragments, streams 64-key tiles of k and
//     v, and accumulates dq += dS k.
// Splitting dK/dV from dQ avoids atomics: every sum runs in one fixed
// order, and a launch on the same inputs gives the same bits. Products take
// bf16 operands (P, dS rounded) with f32 sums. Tile rows in shared memory
// are 72 bf16 (nine 16-byte chunks), so the 8 rows of an ldmatrix phase
// fall in 8 bank groups. Keys past Nk in the last tile are read as zeros
// and get P = 0. Limits (the forward's gate): D = 64, Nq % 64 == 0,
// Nk % 16 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kRS = 72;       // bf16 per tile row in shared memory
constexpr int kTile = 64;     // rows per tile
constexpr int kWarps = 4;     // 16 rows of the block's own tile each
constexpr int kThreads = kWarps * 32;
constexpr int kTileElems = kTile * kRS;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 sum
__device__ __forceinline__ void mma_16816(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// the A fragment of k-step ks from two n8 accumulator tiles (2 ks, 2 ks + 1)
__device__ __forceinline__ void acc_to_a(float (*acc)[4], int ks, uint32_t* a) {
  a[0] = pack_bf16(acc[2 * ks][0], acc[2 * ks][1]);
  a[1] = pack_bf16(acc[2 * ks][2], acc[2 * ks][3]);
  a[2] = pack_bf16(acc[2 * ks + 1][0], acc[2 * ks + 1][1]);
  a[3] = pack_bf16(acc[2 * ks + 1][2], acc[2 * ks + 1][3]);
}

// Copies rows [row0, row0 + 64) of head h of batch b of a (B, N, H, 64)
// tensor into a 64 x kRS tile (cp.async, the block's threads together);
// rows >= N are zeroed with plain stores (visible after __syncthreads).
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int h, int N, int H, int row0) {
  for (int e = threadIdx.x; e < kTile * (kD / 8); e += kThreads) {
    const int r = e >> 3, c = (e & 7) * 8, row = row0 + r;
    if (row < N)
      cp_async16(smem_u32(dst + r * kRS + c), src + (((size_t)b * N + row) * H + h) * kD + c);
    else
      *reinterpret_cast<uint4*>(dst + r * kRS + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// the 16 x 64 A fragments (4 k-steps) of rows r0..r0+15 of a tile
__device__ __forceinline__ void load_a_rows(const __nv_bfloat16* tile, int r0, int lane,
                                            uint32_t (*a)[4]) {
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(smem_u32(tile + (r0 + a_row) * kRS + kk * 16 + a_col), a[kk]);
}

// acc[4][4] (16 x 32) = A (16 x 64, fragments a) times rows n0..n0+31 of a
// tile, transposed: the tile's rows are the n index, its columns the k index
__device__ __forceinline__ void mma_rows_nt(float (*acc)[4], uint32_t (*a)[4],
                                            const __nv_bfloat16* tile, int n0, int lane) {
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t b[4];
      ldsm_x4(smem_u32(tile + (n0 + np * 16 + b_row) * kRS + kk * 16 + b_col), b);
      mma_16816(acc[2 * np], a[kk], b[0], b[1]);
      mma_16816(acc[2 * np + 1], a[kk], b[2], b[3]);
    }
  }
}

// out[8][4] (16 x 64) += A (16 x 32: the two k-steps in a[2][4]) times rows
// k0..k0+31 of a tile (the k index), all 64 columns (the n index)
__device__ __forceinline__ void mma_rows_nn(float (*out)[4], uint32_t (*a)[4],
                                            const __nv_bfloat16* tile, int k0, int lane) {
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
#pragma unroll
    for (int dp = 0; dp < kD / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(smem_u32(tile + (k0 + ks * 16 + a_row) * kRS + dp * 16 + a_col), b);
      mma_16816(out[2 * dp], a[ks], b[0], b[1]);
      mma_16816(out[2 * dp + 1], a[ks], b[2], b[3]);
    }
  }
}

// rows r0 + g and r0 + g + 8 of a 16 x 64 accumulator, times `scale`, to
// head h of batch b of a (B, N, H, 64) tensor
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, float (*acc)[4], int b, int h,
                                           int N, int H, int r0, int lane, float scale) {
  const int g = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    __nv_bfloat16* row = dst + (((size_t)b * N + r0 + g + 8 * half) * H + h) * kD + tig * 2;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8) =
          pack_bf16(acc[nt][2 * half] * scale, acc[nt][2 * half + 1] * scale);
  }
}

// delta[(b H + h) Nq + q] = sum_d dO o, one thread per (b, q, h) row
__global__ void delta_kernel(const __nv_bfloat16* __restrict__ o,
                             const __nv_bfloat16* __restrict__ dout, float* __restrict__ delta,
                             int Nq, int H, int rows) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const uint4* po = reinterpret_cast<const uint4*>(o + (size_t)i * kD);
  const uint4* pd = reinterpret_cast<const uint4*>(dout + (size_t)i * kD);
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) {
    const uint4 uo = po[c], ud = pd[c];
    const __nv_bfloat162* ho = reinterpret_cast<const __nv_bfloat162*>(&uo);
    const __nv_bfloat162* hd = reinterpret_cast<const __nv_bfloat162*>(&ud);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(ho[j]), b = __bfloat1622float2(hd[j]);
      s = fmaf(a.x, b.x, s);
      s = fmaf(a.y, b.y, s);
    }
  }
  const int h = i % H, q = (i / H) % Nq, b = i / (H * Nq);
  delta[((size_t)b * H + h) * Nq + q] = s;
}

// grid (ceil(Nk / 64), H, B). Shared memory: the K and V tiles, then two
// stages of (q, dO) tiles, then two stages of (lse in log2 units, delta).
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Nq, int Nk, int H,
            float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kTileElems;
  __nv_bfloat16* sQ0 = sV + kTileElems;  // stage s: q at sQ0 + 2 s tile, dO after it
  float* sL = reinterpret_cast<float*>(sQ0 + 4 * kTileElems);  // [2][64] lse * log2 e
  float* sDl = sL + 2 * kTile;                                 // [2][64] delta

  const int key0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, tig = lane & 3;
  const size_t rows = ((size_t)b * H + h) * Nq;
  const bool active = key0 + warp * 16 < Nk;  // Nk % 16 == 0: all 16 keys or none

  auto load_q = [&](int t, int s) {
    __nv_bfloat16* dst = sQ0 + 2 * s * kTileElems;
    load_tile(dst, q, b, h, Nq, H, t * kTile);
    load_tile(dst + kTileElems, dout, b, h, Nq, H, t * kTile);
    for (int e = threadIdx.x; e < kTile; e += kThreads) {
      sL[s * kTile + e] = lse[rows + t * kTile + e] * kLog2e;
      sDl[s * kTile + e] = delta[rows + t * kTile + e];
    }
  };

  load_tile(sK, k, b, h, Nk, H, key0);
  load_tile(sV, v, b, h, Nk, H, key0);
  load_q(0, 0);
  cp_async_commit();

  uint32_t ka[4][4], va[4][4];
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int n_tiles = Nq / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    if (t + 1 < n_tiles) load_q(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this thread's copies of tile t (and of K, V) have landed
    __syncthreads();   // ... and every thread's
    if (active) {
      if (t == 0) {
        load_a_rows(sK, warp * 16, lane, ka);
        load_a_rows(sV, warp * 16, lane, va);
      }
      const __nv_bfloat16* tq = sQ0 + 2 * s * kTileElems;
      const __nv_bfloat16* tdo = tq + kTileElems;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int qb = half * 32;
        float st[4][4], dpt[4][4];  // S^T and dP^T: 16 keys x 32 queries
        mma_rows_nt(st, ka, tq, qb, lane);
        mma_rows_nt(dpt, va, tdo, qb, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = s * kTile + qb + nt * 8 + tig * 2 + (e & 1);
            const float p = ex2(fmaf(st[nt][e], scale_log2, -sL[qi]));
            st[nt][e] = p;
            dpt[nt][e] = p * (dpt[nt][e] - sDl[qi]);
          }
        }
        uint32_t pa[2][4], sa[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          acc_to_a(st, ks, pa[ks]);
          acc_to_a(dpt, ks, sa[ks]);
        }
        mma_rows_nn(dva, pa, tdo, qb, lane);
        mma_rows_nn(dka, sa, tq, qb, lane);
      }
    }
    __syncthreads();  // stage s is read out before iteration t + 1 refills it
  }
  cp_async_wait0();
  if (active) {
    store_rows(dk, dka, b, h, Nk, H, key0 + warp * 16, lane, scale);
    store_rows(dv, dva, b, h, Nk, H, key0 + warp * 16, lane, 1.f);
  }
}

// grid (Nq / 64, H, B). Shared memory: the q and dO tiles, then two stages
// of (K, V) tiles.
__global__ void __launch_bounds__(kThreads)
dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int Nq, int Nk, int H, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sdO = sQ + kTileElems;
  __nv_bfloat16* sK0 = sdO + kTileElems;  // stage s: K at sK0 + 2 s tile, V after it

  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const size_t rows = ((size_t)b * H + h) * Nq + q0 + warp * 16 + g;
  const float lse2[2] = {lse[rows] * kLog2e, lse[rows + 8] * kLog2e};
  const float dl[2] = {delta[rows], delta[rows + 8]};

  auto load_kv = [&](int t, int s) {
    __nv_bfloat16* dst = sK0 + 2 * s * kTileElems;
    load_tile(dst, k, b, h, Nk, H, t * kTile);
    load_tile(dst + kTileElems, v, b, h, Nk, H, t * kTile);
  };

  load_tile(sQ, q, b, h, Nq, H, q0);
  load_tile(sdO, dout, b, h, Nq, H, q0);
  load_kv(0, 0);
  cp_async_commit();

  uint32_t qa[4][4], da[4][4];
  float dqa[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) dqa[i][0] = dqa[i][1] = dqa[i][2] = dqa[i][3] = 0.f;

  const int n_tiles = (Nk + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t & 1;
    if (t + 1 < n_tiles) load_kv(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (t == 0) {
      load_a_rows(sQ, warp * 16, lane, qa);
      load_a_rows(sdO, warp * 16, lane, da);
    }
    const __nv_bfloat16* tk = sK0 + 2 * s * kTileElems;
    const __nv_bfloat16* tv = tk + kTileElems;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int kb = half * 32;
      if (t * kTile + kb < Nk) {  // the same for every warp of the block
        float sc[4][4], dp[4][4];  // S and dP: 16 queries x 32 keys
        mma_rows_nt(sc, qa, tk, kb, lane);
        mma_rows_nt(dp, da, tv, kb, lane);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = t * kTile + kb + nt * 8 + tig * 2 + (e & 1), r = e >> 1;
            const float p = key < Nk ? ex2(fmaf(sc[nt][e], scale_log2, -lse2[r])) : 0.f;
            sc[nt][e] = p * (dp[nt][e] - dl[r]);
          }
        }
        uint32_t sa[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) acc_to_a(sc, ks, sa[ks]);
        mma_rows_nn(dqa, sa, tk, kb, lane);
      }
    }
    __syncthreads();
  }
  cp_async_wait0();
  store_rows(dq, dqa, b, h, Nq, H, q0 + warp * 16, lane, scale);
}

constexpr int kDkdvSmem = 6 * kTileElems * 2 + 4 * kTile * 4;
constexpr int kDqSmem = 6 * kTileElems * 2;

}  // namespace

// K2b: delta, then dK and dV, then dQ, on the caller's stream. delta is a
// (B, H, Nq) f32 scratch buffer; lse is the forward's (B, H, Nq) output.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, int B, int Nq, int Nk, int H, float scale,
                                   void* stream) {
  if (B < 1 || H < 1 || Nq < kTile || Nq % kTile != 0 || Nk < 16 || Nk % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = scale * kLog2e;
  const int rows = B * Nq * H;
  delta_kernel<<<(rows + 255) / 256, 256, 0, st>>>((const __nv_bfloat16*)o,
                                                   (const __nv_bfloat16*)dout, (float*)delta, Nq,
                                                   H, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<<<dim3((Nk + kTile - 1) / kTile, H, B), kThreads, kDkdvSmem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, Nq, Nk, H, scale, scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDqSmem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<dim3(Nq / kTile, H, B), kThreads, kDqSmem, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (const float*)lse, (const float*)delta, (__nv_bfloat16*)dq, Nq,
      Nk, H, scale, scale_log2);
  return (int)cudaGetLastError();
}
