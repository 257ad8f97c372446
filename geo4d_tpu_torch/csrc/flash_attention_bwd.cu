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
// Bound: the products (five are needed, 10 * Nq * Nk * 64 flops per (b, h))
// at the self-attention shapes; the 16-key image stream moves q, dO and o
// through device memory and is bound by bytes. The design, for Hopper:
//   * `dq_kernel`, launched first: one block per (128-query tile, h, b), a
//     producer warpgroup whose one thread streams BK-key K/V tiles by TMA
//     through a ring of mbarrier stages (as the forward does), and two
//     consumer warpgroups of 64 queries. Each consumer holds its q and dO
//     rows as wgmma A fragments in registers (read once from device memory)
//     and computes delta for them from o on the way (a quad of lanes holds a
//     row), which it writes for the dK/dV kernel. Per tile: S = Q K^T and
//     dP = dO V^T (register A, K-major B in shared memory), P and dS on the
//     accumulator fragments, then dQ += bf16(dS) K with dS straight from the
//     accumulators as the A operand and K through the MN-major descriptor.
//     For the 16-key image stream (one K/V tile) thread 0 issues the tile's
//     TMA load and the block is the two consumer warpgroups alone, two
//     blocks an SM;
//   * `dkdv_kernel`: one block per (128-key tile, h, b), the same three
//     warpgroups; each consumer holds its 64 keys' K and V as A fragments
//     and streams 64-query tiles of q, dO (TMA, 128-byte swizzle), lse and
//     delta (1-D bulk copies). Per tile: S^T = K Q^T and dP^T = V dO^T, so
//     that P^T and dS^T leave the accumulators in the A layout of dV +=
//     bf16(P^T) dO and dK += bf16(dS^T) Q (dO and Q through the MN-major
//     descriptor); lse and delta are indexed by accumulator column. Every
//     product reads only its B operand from shared memory, once per
//     warpgroup, which keeps shared-memory traffic below the tensor cores'
//     rate;
//   * the 16-key image stream (Nk == 16) cannot fill a 64-row wgmma with
//     keys, and one block per key tile would leave the card nearly empty (80
//     or 160 blocks for 132 SMs), so `dkdv_image_kernel` splits the query
//     axis into chunks over enough blocks to fill the card. It stays on
//     mma.sync: each of its 4 warps takes 16 queries of every 64-query tile
//     against all 16 keys, the warps' sums are added in order in shared
//     memory, and each block writes f32 partials (chunk, B, H, 2, 16, 64);
//     `dkdv_fold_kernel` adds the chunks in order and writes dk and dv.
// dQ and dK/dV stay apart (seven products where a fused kernel needs five)
// so that no sum needs atomics: every sum runs in one fixed order, and a
// launch on the same inputs gives the same bits. Products take bf16
// operands (P, dS rounded) with f32 sums. Keys past Nk and queries past Nq
// arrive as zeros (TMA's fill, or guarded loads) and are neither weighted
// (P = 0 for keys past Nk) nor stored. Limits (the forward's gate): D = 64,
// Nq % 64 == 0, Nk % 16 == 0.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kRowBytes = kD * 2;   // one tile row: exactly one 128-byte swizzle span
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kBlockRows = 128;     // rows of a wgmma block: 64 per consumer warpgroup
constexpr int kQTile = 64;          // queries per streamed tile of dkdv_kernel
constexpr int kDqBK = 64;           // keys per streamed tile of dq_kernel (Nk > 16)
constexpr int kStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------- TMA, mbarrier and wgmma helpers (as csrc/flash_attention.cu) ----------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// TMA: box at (c0, c1, c2) of a 3-D tensor map into shared memory; completion
// is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// a contiguous run of `bytes` (a multiple of 16, 16-byte aligned) into shared
// memory; completion counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor of a tile whose rows are 128 bytes, stored
// with the 128-byte swizzle (as TMA writes it), 8-row groups 1024 bytes apart.
// The same descriptor serves a K-major operand (advance along K by 32 bytes
// a step: + 2) and an MN-major one with 64 columns (advance by 16 rows: +
// 128).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
constexpr uint64_t kKStepK = 2;                      // K-major: 16 columns = 32 bytes
constexpr uint64_t kKStepMN = (16 * kRowBytes) >> 4;  // MN-major: 16 rows

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of wgmma operand registers
// across the asynchronous issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A in registers (bf16 pairs, the
// mma.sync A layout per warp), B in shared memory, K-major (TRANS_B = 0) or
// MN-major (TRANS_B = 1); D is zeroed first when scale_d == 0
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], as wgmma_rs_n64 with B K-major
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x N] = A[64 x 64] B[64 x N], A in registers (4 k-steps of 4), B K-major
template <int N>
__device__ __forceinline__ void wgmma_rs_kmajor(float* d, const uint32_t* a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    if constexpr (N == 64) wgmma_rs_n64<0>(d, a + 4 * kk, desc_b + kk * kKStepK, kk > 0);
    else wgmma_rs_n16(d, a + 4 * kk, desc_b + kk * kKStepK, kk > 0);
  }
}

// D[64 x 64] += A[64 x 16 KS] B[16 KS x 64], A in registers, B MN-major
template <int KS>
__device__ __forceinline__ void wgmma_rs_mn_acc(float* d, const uint32_t* a, uint64_t desc_b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) wgmma_rs_n64<1>(d, a + 4 * kk, desc_b + kk * kKStepMN, 1);
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

// The A fragments (4 k-steps x 4 registers) of rows `row` and `row + 8` of
// head h of batch b of a (B, N, H, 64) tensor, read straight from device
// memory: register 4 kk + j holds row + 8 (j & 1), columns 16 kk + 8 (j >> 1)
// + 2 c and + 1. Rows >= N read as zeros.
__device__ __forceinline__ void load_a_frags(uint32_t* a, const __nv_bfloat16* src, int b, int h,
                                             int N, int H, int row, int c) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int r = row + 8 * (j & 1), col = 16 * (j >> 2) + 8 * ((j >> 1) & 1) + 2 * c;
    a[j] = r < N ? __ldg(reinterpret_cast<const unsigned int*>(
                       src + (((size_t)b * N + r) * H + h) * kD + col))
                 : 0u;
  }
}

// rows `row` and `row + 8` of a 64 x 64 accumulator (element i in row + 8
// ((i >> 1) & 1), column 8 (i / 4) + 2 c + (i & 1)) times `scale`, to head h
// of batch b of a (B, N, H, 64) tensor; rows >= N are skipped
__device__ __forceinline__ void store_acc_rows(__nv_bfloat16* dst, const float* acc, int b, int h,
                                               int N, int H, int row, int c, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= N) continue;
    __nv_bfloat16* p = dst + (((size_t)b * N + row + 8 * r) * H + h) * kD + 2 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// ---------------- dQ (and delta): one block per (128-query tile, h, b) ----------------

template <int BK>
struct DqCfg {
  // The 16-key image stream has one K/V tile: no producer warpgroup (thread
  // 0 issues its TMA load), 256 threads and two blocks an SM, so that the
  // latency of its few products overlaps another block's.
  static constexpr bool kProducer = BK > 16;
  static constexpr int kThreads = kProducer ? 384 : 256;
  static constexpr int kStages = kProducer ? ::kStages : 1;
  // 1024 bytes of slack to align the tiles to the swizzle pattern, the K and
  // V rings, then 2 * kStages mbarriers
  static constexpr int kSmem = 1024 + 2 * kStages * BK * kRowBytes + 8 * 2 * kStages;
};

template <int BK>
__global__ void __launch_bounds__(DqCfg<BK>::kThreads, DqCfg<BK>::kProducer ? 1 : 2)
dq_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
          const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ o,
          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int Nq, int Nk, int H,
          float scale, float scale_log2) {
  constexpr uint32_t kTileBytes = BK * kRowBytes;
  constexpr bool kProducer = DqCfg<BK>::kProducer;
  constexpr int kStages = DqCfg<BK>::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle-aligned
  const uint32_t sV = sK + kStages * kTileBytes;
  const uint32_t full0 = sV + kStages * kTileBytes, empty0 = full0 + 8 * kStages;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128 + (kProducer ? 0 : 1), tid = threadIdx.x % 128;
  const int n_tiles = (Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if constexpr (!kProducer) {
    if (threadIdx.x == 0) {  // the one tile (Nk == BK)
      mbar_expect_tx(full0, 2 * kTileBytes);
      tma_load_3d(sK, &tm_k, full0, h * kD, 0, b);
      tma_load_3d(sV, &tm_v, full0, h * kD, 0, b);
    }
  }

  if (wg == 0) {
    if constexpr (kProducer) {  // one thread keeps the K/V ring full
      asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
      if (tid == 0) {
        for (int t = 0; t < n_tiles; ++t) {
          const int s = t % kStages;
          if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, 2 * kTileBytes);
          tma_load_3d(sK + s * kTileBytes, &tm_k, full0 + 8 * s, h * kD, t * BK, b);
          tma_load_3d(sV + s * kTileBytes, &tm_v, full0 + 8 * s, h * kD, t * BK, b);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 queries; warp w owns rows 16w..16w+15, lane
    // (g, c) = (lane / 4, lane % 4) rows g and g + 8 of them
    if constexpr (kProducer) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int row = qt * kBlockRows + (wg - 1) * 64 + warp * 16 + g;
    uint32_t qa[16], da[16];
    load_a_frags(qa, q, b, h, Nq, H, row, c);
    load_a_frags(da, dout, b, h, Nq, H, row, c);
    float lse2[2], dl[2];
    {
      uint32_t oa[16];
      load_a_frags(oa, o, b, h, Nq, H, row, c);
      dl[0] = dl[1] = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&da[j]));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&oa[j]));
        dl[j & 1] = fmaf(x.y, y.y, fmaf(x.x, y.x, dl[j & 1]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 1);
        dl[r] += __shfl_xor_sync(0xffffffffu, dl[r], 2);
        const int qr = row + 8 * r;
        const size_t i = ((size_t)b * H + h) * Nq + qr;
        lse2[r] = qr < Nq ? lse[i] * kLog2e : 0.f;
        if (c == 0 && qr < Nq) delta[i] = dl[r];
      }
    }

    float dqa[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;
    float sacc[BK / 2], pacc[BK / 2];  // S and dP: 64 x BK
    uint32_t sa[BK / 4];               // dS in bf16 pairs, the A operand of dS K

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);
      const uint64_t desc_k = sw128_desc(sK + s * kTileBytes);
      const uint64_t desc_v = sw128_desc(sV + s * kTileBytes);

      // zeros where the first k-step discards them: the previous tile's
      // values are dead here, which frees their registers during dQ += dS K
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sacc[i] = pacc[i] = 0.f;
      wgmma_fence();
      wgmma_rs_kmajor<BK>(sacc, qa, desc_k);
      wgmma_rs_kmajor<BK>(pacc, da, desc_v);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sacc);
      fence_regs<BK / 2>(pacc);

      const bool ragged = (t + 1) * BK > Nk;  // keys >= Nk take no weight
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sacc[i], scale_log2, -lse2[r]));
        if (ragged && t * BK + 8 * (i / 4) + 2 * c + (i & 1) >= Nk) p = 0.f;
        sacc[i] = p * (pacc[i] - dl[r]);
      }
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) sa[i / 2] = pack_bf16(sacc[i], sacc[i + 1]);

      fence_regs<32>(dqa);
      fence_regs<BK / 4>(sa);
      wgmma_fence();
      wgmma_rs_mn_acc<BK / 16>(dqa, sa, desc_k);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(dqa);
      fence_regs<BK / 4>(sa);
      mbar_arrive(empty0 + 8 * s);
    }
    store_acc_rows(dq, dqa, b, h, Nq, H, row, c, scale);
  }
}

// ---------------- dK and dV: one block per (128-key tile, h, b) ----------------

// 1024 bytes of slack, the q and dO rings, kStages (lse, delta) pairs of 64
// floats each, then 2 * kStages mbarriers
constexpr uint32_t kQTileBytes = kQTile * kRowBytes;
constexpr uint32_t kRowStatBytes = 2 * kQTile * 4;
constexpr int kDkdvSmem = 1024 + 2 * kStages * kQTileBytes + kStages * kRowStatBytes + 8 * 2 * kStages;

__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
            const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Nq, int Nk, int H,
            float scale, float scale_log2) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  uint8_t* base = smem_raw + pad;                          // swizzle-aligned
  const uint32_t sQ = smem_u32(base);                      // kStages q tiles
  const uint32_t sDO = sQ + kStages * kQTileBytes;         // kStages dO tiles
  const uint32_t sStat = sDO + kStages * kQTileBytes;      // stage s: lse[64] | delta[64]
  const float* stat = reinterpret_cast<const float*>(base + 2 * kStages * kQTileBytes);
  const uint32_t full0 = sStat + kStages * kRowStatBytes, empty0 = full0 + 8 * kStages;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = Nq / kQTile;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      const size_t rows = ((size_t)b * H + h) * Nq;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
        const uint32_t bar = full0 + 8 * s;
        mbar_expect_tx(bar, 2 * kQTileBytes + kRowStatBytes);
        tma_load_3d(sQ + s * kQTileBytes, &tm_q, bar, h * kD, t * kQTile, b);
        tma_load_3d(sDO + s * kQTileBytes, &tm_do, bar, h * kD, t * kQTile, b);
        bulk_load(sStat + s * kRowStatBytes, lse + rows + t * kQTile, kQTile * 4, bar);
        bulk_load(sStat + s * kRowStatBytes + kQTile * 4, delta + rows + t * kQTile, kQTile * 4,
                  bar);
      }
    }
  } else {
    // consumer warpgroup: 64 keys; warp w owns keys 16w..16w+15, lane (g, c)
    // keys g and g + 8 of them; accumulator column j is query j of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const int row = kt * kBlockRows + (wg - 1) * 64 + warp * 16 + g;
    uint32_t ka[16], va[16];
    load_a_frags(ka, k, b, h, Nk, H, row, c);
    load_a_frags(va, v, b, h, Nk, H, row, c);
    float dka[32], dva[32], st[32], dpt[32];
    uint32_t pa[16], sa[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);
      const uint64_t desc_q = sw128_desc(sQ + s * kQTileBytes);
      const uint64_t desc_do = sw128_desc(sDO + s * kQTileBytes);

#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;  // as in dq_kernel
      wgmma_fence();
      wgmma_rs_kmajor<64>(st, ka, desc_q);
      wgmma_rs_kmajor<64>(dpt, va, desc_do);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(st);
      fence_regs<32>(dpt);

      // the lse (in log2 units) and delta of this thread's 16 query columns
      const float* sl = stat + s * (2 * kQTile);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(sl + 8 * j + 2 * c);
        const float2 dl = *reinterpret_cast<const float2*>(sl + kQTile + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          const float p = ex2(fmaf(st[i], scale_log2, -(e & 1 ? l.y : l.x) * kLog2e));
          st[i] = p;
          dpt[i] = p * (dpt[i] - (e & 1 ? dl.y : dl.x));
        }
      }
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        pa[i / 2] = pack_bf16(st[i], st[i + 1]);
        sa[i / 2] = pack_bf16(dpt[i], dpt[i + 1]);
      }

      fence_regs<32>(dva);
      fence_regs<32>(dka);
      fence_regs<16>(pa);
      fence_regs<16>(sa);
      wgmma_fence();
      wgmma_rs_mn_acc<kQTile / 16>(dva, pa, desc_do);
      wgmma_rs_mn_acc<kQTile / 16>(dka, sa, desc_q);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(dva);
      fence_regs<32>(dka);
      fence_regs<16>(pa);
      fence_regs<16>(sa);
      mbar_arrive(empty0 + 8 * s);
    }
    store_acc_rows(dk, dka, b, h, Nk, H, row, c, scale);
    store_acc_rows(dv, dva, b, h, Nk, H, row, c, 1.f);
  }
}

// ---------------- the 16-key image stream: mma.sync over query chunks ----------------

constexpr int kRS = 72;            // bf16 per tile row in shared memory (nine 16-byte chunks)
constexpr int kImgKeys = 16;
constexpr int kImgWarps = 4;       // 16 queries of every 64-query tile each
constexpr int kImgThreads = kImgWarps * 32;
constexpr int kImgTileElems = kQTile * kRS;
constexpr int kImgOut = 2 * kImgKeys * kD;  // dk | dv partial of one (chunk, b, h)

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

// Copies rows [row0, row0 + rows) of head h of batch b of a (B, N, H, 64)
// tensor into a rows x kRS tile (cp.async, the block's threads together)
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int b,
                                          int h, int N, int H, int row0, int rows) {
  for (int e = threadIdx.x; e < rows * (kD / 8); e += kImgThreads) {
    const int r = e >> 3, c = (e & 7) * 8;
    cp_async16(smem_u32(dst + r * kRS + c), src + (((size_t)b * N + row0 + r) * H + h) * kD + c);
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

// acc[2][4] (16 x 16) = A (16 x 64, fragments a) times rows n0..n0+15 of a
// tile, transposed: the tile's rows are the n index, its columns the k index
__device__ __forceinline__ void mma_rows_nt16(float (*acc)[4], uint32_t (*a)[4],
                                              const __nv_bfloat16* tile, int n0, int lane) {
  const int b_row = (lane & 7) + (lane >> 4) * 8, b_col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    uint32_t bf[4];
    ldsm_x4(smem_u32(tile + (n0 + b_row) * kRS + kk * 16 + b_col), bf);
    mma_16816(acc[0], a[kk], bf[0], bf[1]);
    mma_16816(acc[1], a[kk], bf[2], bf[3]);
  }
}

// out[8][4] (16 x 64) += A (16 x 16) times rows k0..k0+15 of a tile (the k
// index), all 64 columns (the n index)
__device__ __forceinline__ void mma_rows_nn16(float (*out)[4], const uint32_t* a,
                                              const __nv_bfloat16* tile, int k0, int lane) {
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8, a_col = (lane >> 4) * 8;
#pragma unroll
  for (int dp = 0; dp < kD / 16; ++dp) {
    uint32_t bf[4];
    ldsm_x4_trans(smem_u32(tile + (k0 + a_row) * kRS + dp * 16 + a_col), bf);
    mma_16816(out[2 * dp], a, bf[0], bf[1]);
    mma_16816(out[2 * dp + 1], a, bf[2], bf[3]);
  }
}

// the A fragment of two n8 accumulator tiles (one k-step)
__device__ __forceinline__ void acc_to_a(float (*acc)[4], uint32_t* a) {
  a[0] = pack_bf16(acc[0][0], acc[0][1]);
  a[1] = pack_bf16(acc[0][2], acc[0][3]);
  a[2] = pack_bf16(acc[1][0], acc[1][1]);
  a[3] = pack_bf16(acc[1][2], acc[1][3]);
}

// Shared memory of dkdv_image_kernel: K and V (16 rows each), two stages of
// (q, dO) tiles (the warps' sums reuse them at the end), two stages of (lse
// in log2 units, delta)
constexpr int kImgStageElems = 2 * kImgTileElems;
constexpr int kImgSmem = (2 * kImgKeys * kRS + 2 * kImgStageElems) * 2 + 4 * kQTile * 4;
static_assert(kImgWarps * kImgOut * 4 <= 2 * kImgStageElems * 2, "the warps' sums fit the stages");

// grid (chunks, H, B); block c takes the 64-query tiles [c tpc, (c + 1) tpc)
// and writes part[((c B + b) H + h) * kImgOut + (dk | dv, key, d)] in f32
__global__ void __launch_bounds__(kImgThreads)
dkdv_image_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ part, int B, int Nq, int H, int tiles_per_chunk,
                  float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kImgKeys * kRS;
  __nv_bfloat16* sQ0 = sV + kImgKeys * kRS;  // stage s: q at sQ0 + s stage, dO after it
  float* sL = reinterpret_cast<float*>(sQ0 + 2 * kImgStageElems);  // [2][64] lse * log2 e
  float* sDl = sL + 2 * kQTile;                                     // [2][64] delta

  const int chunk = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const size_t rows = ((size_t)b * H + h) * Nq;
  const int t0 = chunk * tiles_per_chunk, t1 = min(Nq / kQTile, t0 + tiles_per_chunk);

  auto load_q = [&](int t, int s) {
    __nv_bfloat16* dst = sQ0 + s * kImgStageElems;
    load_tile(dst, q, b, h, Nq, H, t * kQTile, kQTile);
    load_tile(dst + kImgTileElems, dout, b, h, Nq, H, t * kQTile, kQTile);
    for (int e = threadIdx.x; e < kQTile; e += kImgThreads) {
      sL[s * kQTile + e] = lse[rows + t * kQTile + e] * kLog2e;
      sDl[s * kQTile + e] = delta[rows + t * kQTile + e];
    }
  };

  load_tile(sK, k, b, h, kImgKeys, H, 0, kImgKeys);
  load_tile(sV, v, b, h, kImgKeys, H, 0, kImgKeys);
  load_q(t0, 0);
  cp_async_commit();

  uint32_t ka[4][4], va[4][4];
  float dka[8][4], dva[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  const int qb = warp * 16;  // this warp's 16 queries of every tile
  for (int t = t0; t < t1; ++t) {
    const int s = (t - t0) & 1;
    if (t + 1 < t1) load_q(t + 1, s ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this thread's copies of tile t (and of K, V) have landed
    __syncthreads();   // ... and every thread's
    if (t == t0) {
      load_a_rows(sK, 0, lane, ka);
      load_a_rows(sV, 0, lane, va);
    }
    const __nv_bfloat16* tq = sQ0 + s * kImgStageElems;
    const __nv_bfloat16* tdo = tq + kImgTileElems;
    float st[2][4], dpt[2][4];  // S^T and dP^T: 16 keys x 16 queries
    mma_rows_nt16(st, ka, tq, qb, lane);
    mma_rows_nt16(dpt, va, tdo, qb, lane);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = s * kQTile + qb + nt * 8 + tig * 2 + (e & 1);
        const float p = ex2(fmaf(st[nt][e], scale_log2, -sL[qi]));
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - sDl[qi]);
      }
    }
    uint32_t pa[4], sa[4];
    acc_to_a(st, pa);
    acc_to_a(dpt, sa);
    mma_rows_nn16(dva, pa, tdo, qb, lane);
    mma_rows_nn16(dka, sa, tq, qb, lane);
    __syncthreads();  // stage s is read out before iteration t + 1 refills it
  }
  cp_async_wait0();

  // the warps' sums, added in order w = 0..3 (the stages are free again)
  float* red = reinterpret_cast<float*>(sQ0);  // [warp][dk | dv][key][d]
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = g + 8 * (e >> 1), d = nt * 8 + tig * 2 + (e & 1);
      red[warp * kImgOut + key * kD + d] = dka[nt][e];
      red[warp * kImgOut + kImgKeys * kD + key * kD + d] = dva[nt][e];
    }
  __syncthreads();
  float* out = part + (((size_t)chunk * B + b) * H + h) * kImgOut;
  for (int e = threadIdx.x; e < kImgOut; e += kImgThreads) {
    float s = red[e];
#pragma unroll
    for (int w = 1; w < kImgWarps; ++w) s += red[w * kImgOut + e];
    out[e] = s;
  }
}

// dk[b, key, h, :] = scale * sum over chunks of the dk partials in order, dv
// likewise (no scale); one thread per two adjacent (key, d) elements
__global__ void dkdv_fold_kernel(const float* __restrict__ part, __nv_bfloat16* __restrict__ dk,
                                 __nv_bfloat16* __restrict__ dv, int B, int H, int chunks,
                                 float scale) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // (b h, dk | dv, key, d / 2)
  if (i >= B * H * kImgOut / 2) return;
  const int e = 2 * (i % (kImgOut / 2)), bh = i / (kImgOut / 2);
  float2 s = make_float2(0.f, 0.f);
  for (int c = 0; c < chunks; ++c) {
    const float2 p =
        *reinterpret_cast<const float2*>(part + ((size_t)c * B * H + bh) * kImgOut + e);
    s.x += p.x;
    s.y += p.y;
  }
  const bool is_dv = e >= kImgKeys * kD;
  const int key = (e % (kImgKeys * kD)) / kD, d = e % kD;
  const int b = bh / H, h = bh % H;
  const float m = is_dv ? 1.f : scale;
  *reinterpret_cast<__nv_bfloat162*>((is_dv ? dv : dk) +
                                     (((size_t)b * kImgKeys + key) * H + h) * kD + d) =
      __floats2bfloat162_rn(s.x * m, s.y * m);
}

// ---------------- launch ----------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda)
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (B, N, H, D) bf16 tensor seen as (H * D, N, B); box (D, rows, 1) with the
// 128-byte swizzle; rows past N read as zeros
bool make_map(CUtensorMap* map, const void* ptr, int B, int N, int H, int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)H * kD, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)H * kD * 2, (cuuint64_t)N * H * kD * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kD, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BK>
int launch_dq(const void* q, const void* k, const void* v, const void* o, const void* dout,
              const float* lse, float* delta, void* dq, int B, int Nq, int Nk, int H, float scale,
              cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  if (!make_map(&tm_k, k, B, Nk, H, BK) || !make_map(&tm_v, v, B, Nk, H, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = DqCfg<BK>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(dq_kernel<BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dq_kernel<BK><<<dim3((Nq + kBlockRows - 1) / kBlockRows, H, B), DqCfg<BK>::kThreads, smem,
                  stream>>>(
      tm_k, tm_v, (const __nv_bfloat16*)q, (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout,
      lse, delta, (__nv_bfloat16*)dq, Nq, Nk, H, scale, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

// K2b on the caller's stream: dq (which also writes delta, a (B, H, Nq) f32
// scratch buffer), then dk and dv. lse is the forward's (B, H, Nq) output.
// chunks > 0 takes the image-stream path (Nk == 16): `part` holds chunks * B
// * H * 2 * 16 * 64 floats, block c takes tiles_per_chunk query tiles, and a
// last launch folds the chunks; chunks == 0 takes the wgmma dK/dV kernel
// (ops/flash_attention.py `backward_plan`).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const void* lse, void* delta, void* part,
                                   void* dq, void* dk, void* dv, int B, int Nq, int Nk, int H,
                                   float scale, int chunks, int tiles_per_chunk, void* stream) {
  if (B < 1 || H < 1 || Nq < kQTile || Nq % kQTile != 0 || Nk < 16 || Nk % 16 != 0 ||
      (chunks > 0 && (Nk != kImgKeys || tiles_per_chunk < 1 ||
                      (long long)chunks * tiles_per_chunk < Nq / kQTile ||
                      (long long)(chunks - 1) * tiles_per_chunk >= Nq / kQTile)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float scale_log2 = scale * kLog2e;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  int err = Nk == kImgKeys
                ? launch_dq<16>(q, k, v, o, dout, l, dl, dq, B, Nq, Nk, H, scale, st)
                : launch_dq<kDqBK>(q, k, v, o, dout, l, dl, dq, B, Nq, Nk, H, scale, st);
  if (err != 0) return err;
  if (chunks > 0) {
    cudaError_t e = cudaFuncSetAttribute(dkdv_image_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kImgSmem);
    if (e != cudaSuccess) return (int)e;
    dkdv_image_kernel<<<dim3(chunks, H, B), kImgThreads, kImgSmem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const __nv_bfloat16*)dout, l, dl, (float*)part, B, Nq, H, tiles_per_chunk, scale_log2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int pairs = B * H * kImgOut / 2;
    dkdv_fold_kernel<<<(pairs + 255) / 256, 256, 0, st>>>(
        (const float*)part, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, B, H, chunks, scale);
    return (int)cudaGetLastError();
  }
  CUtensorMap tm_q, tm_do;
  if (!make_map(&tm_q, q, B, Nq, H, kQTile) || !make_map(&tm_do, dout, B, Nq, H, kQTile))
    return (int)cudaErrorInvalidValue;
  cudaError_t e =
      cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkdvSmem);
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<dim3((Nk + kBlockRows - 1) / kBlockRows, H, B), kThreads, kDkdvSmem, st>>>(
      tm_q, tm_do, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v, l, dl, (__nv_bfloat16*)dk,
      (__nv_bfloat16*)dv, Nq, Nk, H, scale, scale_log2);
  return (int)cudaGetLastError();
}
