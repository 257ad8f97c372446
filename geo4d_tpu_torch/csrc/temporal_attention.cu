// Per-pixel temporal self-attention on the heads-packed layout: q, k, v and
// o are (P, N, C) bf16 with C = heads * Dh, straight off the QKV
// projections. Each (pixel, head) is an independent N x N attention, a "job"
// (N = 16 frames and Dh = 64 on the main path): f32 logits q.k * Dh^-1/2,
// f32 row max, exp and sum, weights e / sum rounded to bf16 (the JAX kernel
// divides, then casts), P.V accumulated in f32, bf16 output.
//
// Replaces the TPU kernel geo4d_tpu/ops/temporal_attention.py `_kernel`
// (launched by `_packed`). The TPU kernel packed 8 pixels into a
// block-diagonal 128 x 128 tile to fill the MXU; that trick is not needed
// here and is not carried over.
//
// Bound: device-memory bandwidth. The op moves 4 * P * N * C * 2 bytes (read
// q, k, v once, write o once; 94 MB at the UNet's finest level) against
// 4 * N * N * C flops (0.76 GFLOP there): 28 us of memory against under 1 us
// of bf16 tensor-core time. The arithmetic only has to stay out of the way
// of the copies. The design:
//   * one warp per job, with tensor cores through mma.sync.m16n8k16 (bf16 in,
//     f32 accumulate): S = Q K^T is 2 * ceil(N / 16) n8 key tiles x Dh / 16
//     k-steps per 16-row query tile, with Q and K fragments read once from
//     shared memory by ldmatrix. wgmma is not used: its 64-row tiles would
//     only stack four independent 16-row problems, and compute is not the
//     limit;
//   * the softmax runs on the S accumulator fragments in registers: a row
//     lives on the 4 lanes of a quad, so two shfl_xor steps give its max and
//     its sum, and the whole row (N <= 32 keys) is there, so no online
//     rescale is needed. Rounded to bf16 pairs, the m16n8 accumulator layout
//     is the A fragment of the next m16n8k16, so P never touches shared
//     memory. O = P V is Dh / 8 n8 tiles x ceil(N / 16) k-steps with V
//     fragments from ldmatrix.trans;
//   * each warp owns a ring of `stages` job slots (q, k, v tiles) in shared
//     memory and fills it with 16-byte cp.async copies (commit groups), so
//     the copies of its next stages - 1 jobs run while it computes one; the
//     warps of a block never wait for each other (no block-wide barrier).
//     A block takes one contiguous range of jobs, the warps interleaved in
//     it (neighbouring warps on neighbouring heads of one row), so blocks
//     differ by at most one job. The launch plan (warps, stages, grid) is
//     chosen in ops/temporal_attention.py (`plan`): at the main-path shapes
//     16 warps of 2 slots, one block per SM, so that each SM keeps about
//     100 KB of copies in flight;
//   * a tile row in shared memory is Dh bf16, padded to an odd number of
//     16-byte chunks, so the 8 rows one ldmatrix phase reads fall in 8
//     different bank groups (a stride of C * 2 bytes, a multiple of 128,
//     would put all 8 in the same banks);
//   * the output tile is staged through the job's own q tile (only this warp
//     reads it, and its Q fragments are in registers by then) and stored as
//     whole 16-byte chunks, 8 lanes on one 128-byte row segment.
// Edges: N < 16 (and 16 < N < 32) pads the tiles with zero rows, and keys
// j >= N are masked to -inf before the max; 16 < N <= 32 takes two query
// tiles, 4 n8 key tiles and two k-steps for P.V; Dh % 16 == 8 zeroes the
// upper half of the last k-step's fragments (its addresses are clamped into
// the head). Every sum is taken in one fixed order (no atomics): a launch on
// the same input gives the same bits.
//
// Limits: N <= 32, Dh <= 128, Dh % 8 == 0, C % Dh == 0, 16-byte aligned
// tensors. Instances: Dh <= 32, 64 or 128 (n8 tiles beyond Dh are skipped at
// run time) x one or two 16-row tiles.
//
// Backward (K3b, `temporal_attention_bwd`): dq, dk and dv of the same jobs
// for the cotangent dO, in the same layout. No TPU kernel had a backward
// (the JAX package differentiates its XLA path). Bound: memory again (read
// q, k, v, dO and write dq, dk, dv: 7 * P * N * C * 2 bytes against
// 10 * P * N * N * C flops, 11 flops a byte at N = 16), so, as in K3, the
// arithmetic only has to stay out of the way of the copies. K3's design:
//   * one warp per job; each warp a ring of `stages` slots of four tiles (q,
//     k, v, dO; rows padded as above) filled by cp.async, no block-wide
//     barrier. The plan is ops/temporal_attention.py `backward_plan`: 12
//     warps of 2 slots (221 KB), one block per SM, at N = 16, Dh = 64;
//   * the five products on mma.sync.m16n8k16, in the row orientation:
//     S = Q K^T and dP = dO V^T put a softmax row on the 4 lanes of a quad,
//     where two shfl_xor steps give its max, its sum and rowsum(dP P), as in
//     K3. P and dS = P (dP - rowsum(dP P)), rounded to bf16 pairs, are the A
//     fragments of dQ = dS K s as they stand, and movmatrix.trans turns their
//     8 x 8 blocks into the A fragments of dV = bf16(P)^T dO and
//     dK = dS^T Q s (8 movmatrix a job at N <= 16). The transposed
//     orientation (S^T = K Q^T, as K2b) would give dV and dK their A
//     fragments directly but reduce the softmax down accumulator columns
//     (across the 8 quads) and need the transposes for dQ instead. K, dO and
//     Q are B operands through ldmatrix.trans. Each pair of an output's n8
//     column tiles is summed over its k-steps and stored at once, so 8
//     accumulators are live; P and dS stay as 4 * KS^2 registers each, and
//     no fragment of the tiles is held across products (Dh = 128 fits);
//   * dV is staged in the v tile, dQ in the dO tile and dK in the k tile,
//     each once the tile it replaces has been read for the last time, then
//     stored as whole 16-byte chunks, 8 lanes on one 128-byte row segment.
// Rounding dS to bf16 puts the gradients about 3e-3 (relative L2) from the
// f32 plain backward. Edges as in K3 (pad rows give zero gradients). No
// atomics, one order for every sum: a launch repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 16;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on Hopper
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

// wait until at most `pending` of this thread's newest commit groups are in
// flight (the instruction takes an immediate)
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
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

// One job from its slot: q, k, v tiles of 16 * KS rows at a row stride of
// `rs` bf16 (rows >= N are zero). Leaves O, rows < N, in the q tile.
template <int DMAX, int KS>
__device__ __forceinline__ void attend(__nv_bfloat16* tile, int tensor, int rs, int N, int Dh,
                                       float scale_log2, int lane) {
  constexpr int kSteps = DMAX / 16;  // k-steps of Q K^T
  constexpr int kKeyTiles = 2 * KS;  // n8 key tiles
  constexpr int kOutTiles = DMAX / 8;
  const uint32_t sq = smem_u32(tile), sk = sq + tensor * 2, sv = sk + tensor * 2;
  const int g = lane >> 2, tig = lane & 3;
  // ldmatrix row addresses. A (Q) and V^T: matrices 0 / 1 are rows 0-7 /
  // 8-15, 2 / 3 the same rows 8 columns on. B (K, n = key): matrices 0 / 1
  // are keys 0-7 at columns +0 / +8, 2 / 3 keys 8-15.
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    float s[kKeyTiles][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 < Dh) {
        const bool half = Dh - kk * 16 == 8;  // columns kk*16+8.. lie outside the head
        uint32_t a[4];
        ldsm_x4(sq + ((mt * 16 + a_row) * rs + kk * 16 + (half ? 0 : a_col)) * 2, a);
        if (half) a[2] = a[3] = 0u;
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          uint32_t b[4];
          ldsm_x4(sk + ((np * 16 + b_row) * rs + kk * 16 + (half ? 0 : b_col)) * 2, b);
          if (half) b[1] = b[3] = 0u;
          mma_16816(s[2 * np], a, b[0], b[1]);
          mma_16816(s[2 * np + 1], a, b[2], b[3]);
        }
      }
    }

    // softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3), in log2 units
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool key = nt * 8 + tig * 2 + e < N;
        s[nt][e] = key ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][2 + e] = key ? s[nt][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = ex2(s[nt][e] - mx0);
        s[nt][2 + e] = ex2(s[nt][2 + e] - mx1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    // normalised weights in bf16: key tiles 2ks, 2ks + 1 form the A fragment
    // of P.V's k-step ks
    uint32_t p[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      p[ks][0] = pack_bf16(s[2 * ks][0] * inv0, s[2 * ks][1] * inv0);
      p[ks][1] = pack_bf16(s[2 * ks][2] * inv1, s[2 * ks][3] * inv1);
      p[ks][2] = pack_bf16(s[2 * ks + 1][0] * inv0, s[2 * ks + 1][1] * inv0);
      p[ks][3] = pack_bf16(s[2 * ks + 1][2] * inv1, s[2 * ks + 1][3] * inv1);
    }

    float o[kOutTiles][4] = {};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int dp = 0; dp < kOutTiles / 2; ++dp) {
        if (dp * 16 < Dh) {
          const bool half = Dh - dp * 16 == 8;
          uint32_t b[4];
          ldsm_x4_trans(sv + ((ks * 16 + a_row) * rs + dp * 16 + (half ? 0 : a_col)) * 2, b);
          mma_16816(o[2 * dp], p[ks], b[0], b[1]);
          if (!half) mma_16816(o[2 * dp + 1], p[ks], b[2], b[3]);
        }
      }
    }

    // O rows of this query tile into the q tile (its Q fragments are read)
    __syncwarp();
    const int r0 = mt * 16 + g, r1 = r0 + 8;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      if (nt * 8 < Dh) {
        const int col = nt * 8 + tig * 2;
        if (r0 < N) *reinterpret_cast<uint32_t*>(tile + r0 * rs + col) = pack_bf16(o[nt][0], o[nt][1]);
        if (r1 < N) *reinterpret_cast<uint32_t*>(tile + r1 * rs + col) = pack_bf16(o[nt][2], o[nt][3]);
      }
    }
  }
}

// grid: `gridDim.x` blocks of W warps; block b takes jobs
// [b * jobs / grid, (b + 1) * jobs / grid), warp w the jobs start + w + i * W.
// Dynamic shared memory: per warp, `stages` slots of three (16 * KS) x rs
// bf16 tiles (q, k, v).
template <int DMAX, int KS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
temporal_attn_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int N,
                     int C, int Dh, int heads, int jobs, int stages, int rs, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int tensor = 16 * KS * rs;  // bf16 of one tile
  const int slot = 3 * tensor;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + (size_t)warp * stages * slot;

  const int start = (int)((long long)blockIdx.x * jobs / gridDim.x);
  const int end = (int)(((long long)blockIdx.x + 1) * jobs / gridDim.x);
  const int first = start + warp;
  const int count = first < end ? (end - first + W - 1) / W : 0;
  if (count == 0) return;  // no block-wide barrier below

  if (N < 16 * KS) {  // the pad rows of every slot stay zero (copies write rows < N)
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = lane; i < stages * slot / 8; i += 32) z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // lane's 16-byte chunks of an N x Dh tile: (row, chunk) from lane, then
  // +32 chunks at a time
  const int dc = Dh / 8, lr = lane / dc, lc = lane % dc, step_r = 32 / dc, step_c = 32 % dc;
  const int chunks = N * dc;

  auto base = [&](int i) {
    const int job = first + i * W;
    return (size_t)(job / heads) * N * C + (size_t)(job % heads) * Dh;
  };
  auto load = [&](int i) {
    const size_t g = base(i);
    const uint32_t dst = smem_u32(ring + (size_t)(i % stages) * slot);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16* src = (t == 0 ? q : t == 1 ? k : v) + g;
      const uint32_t d = dst + t * tensor * 2;
      int r = lr, c = lc;
      for (int e = lane; e < chunks; e += 32) {
        cp_async16(d + (r * rs + c * 8) * 2, src + (size_t)r * C + c * 8);
        r += step_r;
        c += step_c;
        if (c >= dc) {
          c -= dc;
          ++r;
        }
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();  // one group per stage, empty or not, keeps the count
  }
  for (int i = 0; i < count; ++i) {
    if (i + stages - 1 < count) load(i + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);  // job i's copies have landed (this lane's)
    __syncwarp();               // ... and every lane's
    __nv_bfloat16* tile = ring + (size_t)(i % stages) * slot;
    attend<DMAX, KS>(tile, tensor, rs, N, Dh, scale_log2, lane);
    __syncwarp();
    __nv_bfloat16* out = o + base(i);
    int r = lr, c = lc;
    for (int e = lane; e < chunks; e += 32) {
      *reinterpret_cast<uint4*>(out + (size_t)r * C + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * rs + c * 8);
      r += step_r;
      c += step_c;
      if (c >= dc) {
        c -= dc;
        ++r;
      }
    }
    __syncwarp();  // the slot is read out before the next iteration refills it
  }
  cp_async_wait(0);
}

using KernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                          __nv_bfloat16*, int, int, int, int, int, int, int, float);

KernelFn pick(int Dh, int ks) {
  if (Dh <= 32) return ks == 1 ? temporal_attn_kernel<32, 1> : temporal_attn_kernel<32, 2>;
  if (Dh <= 64) return ks == 1 ? temporal_attn_kernel<64, 1> : temporal_attn_kernel<64, 2>;
  return ks == 1 ? temporal_attn_kernel<128, 1> : temporal_attn_kernel<128, 2>;
}

}  // namespace

// One launch on the plan of ops/temporal_attention.py `plan`: `warps` warps
// per block, `stages` job slots per warp, `grid` blocks. The shared memory is
// sized here by the same rule as there (row stride: Dh bf16 padded to an odd
// number of 16-byte chunks).
extern "C" int temporal_attention(const void* q, const void* k, const void* v, void* o, int P,
                                  int N, int C, int Dh, float scale, int warps, int stages,
                                  int grid, void* stream) {
  if (P < 1 || N < 1 || N > 32 || Dh < 8 || Dh > 128 || Dh % 8 != 0 || C % Dh != 0 ||
      (long long)P * (C / Dh) > 0x7fffffff || warps < 1 || warps > kMaxWarps || stages < 1 ||
      stages > kMaxStages || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int ks = N > 16 ? 2 : 1;
  const int dc = Dh / 8;
  const int rs = 8 * (dc % 2 ? dc : dc + 1);
  const size_t smem = (size_t)warps * stages * 3 * 16 * ks * rs * 2;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick(Dh, ks);
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, N, C, Dh, C / Dh, P * (C / Dh), stages, rs, scale * kLog2e);
  return (int)cudaGetLastError();
}


namespace {

// transpose of an 8 x 8 bf16 matrix held as one pair a lane (lane 4 g + c:
// row g, columns 2 c and 2 c + 1, the layout of ldmatrix and of a packed
// m16n8 accumulator half): the lane then holds row g, columns 2 c, 2 c + 1
// of the transpose
__device__ __forceinline__ uint32_t movtrans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// Rows m0 .. m0 + 15 of `dst` (those < N) = (A B) * mul in bf16. A is one
// 16-row tile, given as the A fragments a[ks] of its KS k-steps; B is the
// (16 KS) x Dh tile at shared address `src` (row-major, row stride rs), read
// by ldmatrix.trans as K3 reads V. Each pair of n8 column tiles is summed
// over the k-steps in order and stored at once, so 8 accumulators are live.
template <int DMAX, int KS>
__device__ __forceinline__ void product_rows(uint32_t (&a)[KS][4], uint32_t src,
                                             __nv_bfloat16* dst, int m0, int rs, int N, int Dh,
                                             float mul, int lane) {
  const int g = lane >> 2, tig = lane & 3;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;
  const int r0 = m0 + g, r1 = r0 + 8;
#pragma unroll
  for (int dp = 0; dp < DMAX / 16; ++dp) {
    if (dp * 16 < Dh) {
      const bool half = Dh - dp * 16 == 8;  // columns dp*16+8.. lie outside the head
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t b[4];
        ldsm_x4_trans(src + ((ks * 16 + t_row) * rs + dp * 16 + (half ? 0 : t_col)) * 2, b);
        mma_16816(acc[0], a[ks], b[0], b[1]);
        if (!half) mma_16816(acc[1], a[ks], b[2], b[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 0 || !half) {
          const int col = dp * 16 + t * 8 + tig * 2;
          if (r0 < N)
            *reinterpret_cast<uint32_t*>(dst + r0 * rs + col) =
                pack_bf16(acc[t][0] * mul, acc[t][1] * mul);
          if (r1 < N)
            *reinterpret_cast<uint32_t*>(dst + r1 * rs + col) =
                pack_bf16(acc[t][2] * mul, acc[t][3] * mul);
        }
      }
    }
  }
}

// One job's gradients from its slot: q, k, v and dO tiles of 16 * KS rows at
// a row stride of `rs` bf16 (rows >= N are zero). Leaves dV (rows < N) in
// the v tile, dQ in the dO tile and dK in the k tile.
template <int DMAX, int KS>
__device__ __forceinline__ void attend_bwd(__nv_bfloat16* tile, int tensor, int rs, int N, int Dh,
                                           float scale, float scale_log2, int lane) {
  constexpr int kSteps = DMAX / 16;  // k-steps of Q K^T and dO V^T
  constexpr int kKeyTiles = 2 * KS;  // n8 key tiles
  __nv_bfloat16 *tq = tile, *tk = tq + tensor, *tv = tk + tensor, *tdo = tv + tensor;
  const uint32_t sq = smem_u32(tq), sk = smem_u32(tk), sv = smem_u32(tv), sdo = smem_u32(tdo);
  const int tig = lane & 3;
  // ldmatrix row addresses, as in `attend`: A (Q, dO) matrices 0 / 1 rows
  // 0-7 / 8-15, 2 / 3 the same rows 8 columns on; B (K, V; n = key)
  // matrices 0 / 1 keys 0-7 at columns +0 / +8, 2 / 3 keys 8-15
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;

  // P and dS of every query tile as bf16 pairs: [mt][kb][h] holds row
  // 16 mt + 8 h + g (g = lane / 4), keys 8 kb + 2 tig and + 1
  uint32_t pp[KS][kKeyTiles][2], dsp[KS][kKeyTiles][2];
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
    float s[kKeyTiles][4] = {}, dp[kKeyTiles][4] = {};
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      if (kk * 16 < Dh) {
        const bool half = Dh - kk * 16 == 8;
        const int a_off = ((mt * 16 + a_row) * rs + kk * 16 + (half ? 0 : a_col)) * 2;
        uint32_t a[4], ad[4];
        ldsm_x4(sq + a_off, a);
        ldsm_x4(sdo + a_off, ad);
        if (half) a[2] = a[3] = ad[2] = ad[3] = 0u;
#pragma unroll
        for (int np = 0; np < KS; ++np) {
          const int b_off = ((np * 16 + b_row) * rs + kk * 16 + (half ? 0 : b_col)) * 2;
          uint32_t b[4], bv[4];
          ldsm_x4(sk + b_off, b);
          ldsm_x4(sv + b_off, bv);
          if (half) b[1] = b[3] = bv[1] = bv[3] = 0u;
          mma_16816(s[2 * np], a, b[0], b[1]);
          mma_16816(s[2 * np + 1], a, b[2], b[3]);
          mma_16816(dp[2 * np], ad, bv[0], bv[1]);
          mma_16816(dp[2 * np + 1], ad, bv[2], bv[3]);
        }
      }
    }

    // f32 softmax of rows g (elements 0, 1) and g + 8 (2, 3), as in `attend`
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool key = nt * 8 + tig * 2 + e < N;
        s[nt][e] = key ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][2 + e] = key ? s[nt][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[nt][e]);
        mx1 = fmaxf(mx1, s[nt][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = ex2(s[nt][e] - mx0);
        s[nt][2 + e] = ex2(s[nt][2 + e] - mx1);
        sum0 += s[nt][e];
        sum1 += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, x);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, x);
    }
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    // P, then rowsum(dP P) (masked keys have P = 0 and dP = 0)
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] *= inv0;
        s[nt][2 + e] *= inv1;
        r0 = fmaf(dp[nt][e], s[nt][e], r0);
        r1 = fmaf(dp[nt][2 + e], s[nt][2 + e], r1);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, x);
      r1 += __shfl_xor_sync(0xffffffffu, r1, x);
    }
    // dS = P (dP - rowsum(dP P)); both rounded to bf16 for the tensor cores
#pragma unroll
    for (int nt = 0; nt < kKeyTiles; ++nt) {
      pp[mt][nt][0] = pack_bf16(s[nt][0], s[nt][1]);
      pp[mt][nt][1] = pack_bf16(s[nt][2], s[nt][3]);
      dsp[mt][nt][0] = pack_bf16(s[nt][0] * (dp[nt][0] - r0), s[nt][1] * (dp[nt][1] - r0));
      dsp[mt][nt][1] = pack_bf16(s[nt][2] * (dp[nt][2] - r1), s[nt][3] * (dp[nt][3] - r1));
    }
  }

  uint32_t a[KS][4];
  __syncwarp();  // every lane has read the v tile: dV goes there
  // dV = bf16(P)^T dO, a 16-key tile at a time: the A fragment of keys mk,
  // queries ks is P's four 8 x 8 blocks (queries 16 ks.., keys 16 mk..)
  // transposed
#pragma unroll
  for (int mk = 0; mk < KS; ++mk) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][0] = movtrans(pp[ks][2 * mk][0]);
      a[ks][1] = movtrans(pp[ks][2 * mk + 1][0]);
      a[ks][2] = movtrans(pp[ks][2 * mk][1]);
      a[ks][3] = movtrans(pp[ks][2 * mk + 1][1]);
    }
    product_rows<DMAX, KS>(a, sdo, tv, mk * 16, rs, N, Dh, 1.f, lane);
  }
  __syncwarp();  // ... the dO tile: dQ goes there
  // dQ = dS K s: dS's pairs are the A fragments as they stand (K3's P)
#pragma unroll
  for (int mt = 0; mt < KS; ++mt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][0] = dsp[mt][2 * ks][0];
      a[ks][1] = dsp[mt][2 * ks][1];
      a[ks][2] = dsp[mt][2 * ks + 1][0];
      a[ks][3] = dsp[mt][2 * ks + 1][1];
    }
    product_rows<DMAX, KS>(a, sk, tdo, mt * 16, rs, N, Dh, scale, lane);
  }
  __syncwarp();  // ... the k tile: dK goes there
  // dK = dS^T Q s, dS^T as P^T for dV
#pragma unroll
  for (int mk = 0; mk < KS; ++mk) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      a[ks][0] = movtrans(dsp[ks][2 * mk][0]);
      a[ks][1] = movtrans(dsp[ks][2 * mk + 1][0]);
      a[ks][2] = movtrans(dsp[ks][2 * mk][1]);
      a[ks][3] = movtrans(dsp[ks][2 * mk + 1][1]);
    }
    product_rows<DMAX, KS>(a, sq, tk, mk * 16, rs, N, Dh, scale, lane);
  }
}

// K3b's grid and rings are K3's: `gridDim.x` blocks of W warps, block b the
// jobs [b * jobs / grid, (b + 1) * jobs / grid), warp w the jobs
// start + w + i * W, each warp a ring of `stages` slots of four (16 * KS) x rs
// bf16 tiles (q, k, v, dO).
template <int DMAX, int KS>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
temporal_attn_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                         __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int N, int C, int Dh, int heads, int jobs,
                         int stages, int rs, float scale, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, W = blockDim.x >> 5;
  const int tensor = 16 * KS * rs;  // bf16 of one tile
  const int slot = 4 * tensor;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem) + (size_t)warp * stages * slot;

  const int start = (int)((long long)blockIdx.x * jobs / gridDim.x);
  const int end = (int)(((long long)blockIdx.x + 1) * jobs / gridDim.x);
  const int first = start + warp;
  const int count = first < end ? (end - first + W - 1) / W : 0;
  if (count == 0) return;  // no block-wide barrier below

  if (N < 16 * KS) {  // the pad rows of every slot stay zero (copies and stages write rows < N)
    uint4* z = reinterpret_cast<uint4*>(ring);
    for (int i = lane; i < stages * slot / 8; i += 32) z[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncwarp();
  }

  // lane's 16-byte chunks of an N x Dh tile: (row, chunk) from lane, then
  // +32 chunks at a time
  const int dc = Dh / 8, lr = lane / dc, lc = lane % dc, step_r = 32 / dc, step_c = 32 % dc;
  const int chunks = N * dc;

  auto base = [&](int i) {
    const int job = first + i * W;
    return (size_t)(job / heads) * N * C + (size_t)(job % heads) * Dh;
  };
  auto load = [&](int i) {
    const size_t g = base(i);
    const uint32_t dst = smem_u32(ring + (size_t)(i % stages) * slot);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const __nv_bfloat16* src = (t == 0 ? q : t == 1 ? k : t == 2 ? v : dout) + g;
      const uint32_t d = dst + t * tensor * 2;
      int r = lr, c = lc;
      for (int e = lane; e < chunks; e += 32) {
        cp_async16(d + (r * rs + c * 8) * 2, src + (size_t)r * C + c * 8);
        r += step_r;
        c += step_c;
        if (c >= dc) {
          c -= dc;
          ++r;
        }
      }
    }
  };

  for (int i = 0; i < stages - 1; ++i) {
    if (i < count) load(i);
    cp_async_commit();  // one group per stage, empty or not, keeps the count
  }
  for (int i = 0; i < count; ++i) {
    if (i + stages - 1 < count) load(i + stages - 1);
    cp_async_commit();
    cp_async_wait(stages - 1);  // job i's copies have landed (this lane's)
    __syncwarp();               // ... and every lane's
    __nv_bfloat16* tile = ring + (size_t)(i % stages) * slot;
    attend_bwd<DMAX, KS>(tile, tensor, rs, N, Dh, scale, scale_log2, lane);
    __syncwarp();
    // whole 16-byte chunks: dV from the v tile, dQ from the dO tile, dK from
    // the k tile
    const size_t g = base(i);
#pragma unroll
    for (int t = 0; t < 3; ++t) {
      const __nv_bfloat16* from = tile + (t == 0 ? 2 : t == 1 ? 3 : 1) * tensor;
      __nv_bfloat16* out = (t == 0 ? dv : t == 1 ? dq : dk) + g;
      int r = lr, c = lc;
      for (int e = lane; e < chunks; e += 32) {
        *reinterpret_cast<uint4*>(out + (size_t)r * C + c * 8) =
            *reinterpret_cast<const uint4*>(from + r * rs + c * 8);
        r += step_r;
        c += step_c;
        if (c >= dc) {
          c -= dc;
          ++r;
        }
      }
    }
    __syncwarp();  // the slot is read out before the next iteration refills it
  }
  cp_async_wait(0);
}

using BwdKernelFn = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                             const __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*, __nv_bfloat16*,
                             int, int, int, int, int, int, int, float, float);

BwdKernelFn pick_bwd(int Dh, int ks) {
  if (Dh <= 32) return ks == 1 ? temporal_attn_bwd_kernel<32, 1> : temporal_attn_bwd_kernel<32, 2>;
  if (Dh <= 64) return ks == 1 ? temporal_attn_bwd_kernel<64, 1> : temporal_attn_bwd_kernel<64, 2>;
  return ks == 1 ? temporal_attn_bwd_kernel<128, 1> : temporal_attn_bwd_kernel<128, 2>;
}

}  // namespace

// K3b, one launch on the plan of ops/temporal_attention.py `backward_plan`:
// `warps` warps per block, `stages` job slots per warp (four tiles each),
// `grid` blocks; the shared memory sized by the same rule as there.
extern "C" int temporal_attention_bwd(const void* q, const void* k, const void* v,
                                      const void* dout, void* dq, void* dk, void* dv, int P,
                                      int N, int C, int Dh, float scale, int warps, int stages,
                                      int grid, void* stream) {
  if (P < 1 || N < 1 || N > 32 || Dh < 8 || Dh > 128 || Dh % 8 != 0 || C % Dh != 0 ||
      (long long)P * (C / Dh) > 0x7fffffff || warps < 1 || warps > kMaxWarps || stages < 1 ||
      stages > kMaxStages || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int ks = N > 16 ? 2 : 1;
  const int dc = Dh / 8;
  const int rs = 8 * (dc % 2 ? dc : dc + 1);
  const size_t smem = (size_t)warps * stages * 4 * 16 * ks * rs * 2;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const BwdKernelFn fn = pick_bwd(Dh, ks);
  const cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fn<<<grid, warps * 32, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const __nv_bfloat16*)dout, (__nv_bfloat16*)dq, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, N,
      C, Dh, C / Dh, P * (C / Dh), stages, rs, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}
