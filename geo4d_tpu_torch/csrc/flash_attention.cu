// Unmasked multi-head attention softmax(q k^T / sqrt(D)) v over (B, N, H, D)
// bf16 tensors, D = 64: f32 logits and softmax statistics, bf16 P for the
// P.V product, bf16 output.
//
// Replaces the TPU kernel geo4d_tpu/ops/flash_attention.py `_attn_kernel`
// (launched by `_flash_bhnd`). That kernel held all of K and V for one
// (batch, head) in VMEM and took one exact softmax per q-block. On Hopper a
// block has at most 227 KB of shared memory, and K+V at N = 2304, D = 64 is
// 590 KB, so this kernel streams BK-key K/V tiles through shared memory with
// an online softmax (running max and sum, rescaling the accumulator). Its
// rounding therefore differs slightly from one exact softmax: P is rounded
// to bf16 before it is normalised, not after.
//
// Bound: at the UNet's spatial shapes (Nq = Nk = 2304 or 576) the two
// products (4 * Nq * Nk * D flops per (b, h)) and the Nq * Nk exponentials;
// the 16-key image stream moves q and o through device memory and is bound
// by bytes. The design, after FlashAttention-3:
//   * one block per (128-row q tile, h, b): a producer warpgroup, of which
//     one thread issues TMA loads, and two consumer warpgroups of 64 q rows
//     each; setmaxnreg moves registers from the producer to the consumers;
//   * TMA reads q/k/v in place through a 3-D tensor map over (H * D, N, B)
//     with box (64, rows, 1) and the 128-byte swizzle: no head transpose;
//     rows past N (a ragged q tile, the last K/V tile) arrive as zeros;
//   * K/V tiles go through a ring of buffers with full/empty mbarriers, so
//     the loads of later tiles overlap the products;
//   * S = Q K^T is a wgmma with both operands in shared memory (K-major);
//     the accumulator stays in registers, where the online softmax runs on
//     its fragment layout (row max and sum over the four lanes of a quad);
//   * O += P V is a wgmma with P, rounded to bf16, as the register A operand
//     (the S accumulator layout is the A fragment layout) and V read from
//     shared memory through the MN-major (transposed) descriptor;
//   * the epilogue divides by the row sum and writes bf16 straight into
//     (B, Nq, H, D), skipping rows >= Nq; when given a pointer it also
//     writes the row's log-sum-exp of the scaled logits (natural log, f32,
//     (B, H, Nq)), which the backward (csrc/flash_attention_bwd.cu) reads.
// Keys >= Nk in the last tile are masked to -inf. Every block sums its keys
// in one fixed order (no split over blocks, no atomics): a launch on the
// same input gives the same bits.
//
// Instances: BK = 128 or 64 keys per tile for the self-attention shapes, and
// BK = 16 for the 16-token image stream (one tile); the wrapper in
// ops/flash_attention.py picks BK from the shape (`plan`).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;              // head dim
constexpr int kBQ = 128;            // q rows per block: 64 per consumer warpgroup
constexpr int kThreads = 384;       // producer warpgroup + two consumer warpgroups
constexpr int kRowBytes = kD * 2;   // one tile row: exactly one 128-byte swizzle span
constexpr uint32_t kQBytes = kBQ * kRowBytes;

// The BK = 16 instance (one K/V tile, few registers) runs two blocks per SM,
// so its loads overlap another block's work, and moves no registers between
// warpgroups (setmaxnreg assumes a block owns its SM's register file); the
// others run one block per SM with a ring of 4 K/V tiles.
template <int BK>
struct Cfg {
  static constexpr bool kOwnsSM = BK > 16;
  static constexpr int kStages = kOwnsSM ? 4 : 2;
  // 1024 bytes of slack to align the tiles to the swizzle pattern, q, the
  // K and V rings, then 1 + 2 * kStages mbarriers
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * BK * kRowBytes + 8 * (1 + 2 * kStages);
};

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

// wgmma shared-memory descriptor of a tile whose rows are 128 bytes, stored
// with the 128-byte swizzle (as TMA writes it), 8-row groups 1024 bytes apart.
// The same descriptor serves the K-major Q/K tiles (leading offset unused)
// and the MN-major V tile (64 columns: one swizzle span, leading offset
// unused). Advance along K by adding bytes >> 4.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n16(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A in registers (bf16 pairs), B MN-major
// in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


template <int BK>
__device__ __forceinline__ void wgmma_qk(float* s, uint64_t desc_q, uint64_t desc_k) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {  // 16 columns = 32 bytes per step
    if constexpr (BK == 128) wgmma_ss_n128(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    else if constexpr (BK == 64) wgmma_ss_n64(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
    else wgmma_ss_n16(s, desc_q + 2 * kk, desc_k + 2 * kk, kk > 0);
  }
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

template <int BK>
__global__ void __launch_bounds__(kThreads, Cfg<BK>::kOwnsSM ? 1 : 2)
flash_attn_kernel(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                  float* __restrict__ lse, int Nq, int Nk, int H, float scale_log2) {
  constexpr uint32_t kTileBytes = BK * kRowBytes;
  constexpr int kStages = Cfg<BK>::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // swizzle-aligned
  const uint32_t sK = sQ + kQBytes;                            // kStages K tiles
  const uint32_t sV = sK + kStages * kTileBytes;               // kStages V tiles
  const uint32_t q_full = sV + kStages * kTileBytes;           // then full[s], empty[s]
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int n_tiles = (Nk + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 256);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the K/V ring full
    if constexpr (Cfg<BK>::kOwnsSM) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      mbar_expect_tx(q_full, kQBytes);
      tma_load_3d(sQ, &tm_q, q_full, h * kD, qt * kBQ, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(empty0 + 8 * s, ((t / kStages) - 1) & 1);
        mbar_expect_tx(full0 + 8 * s, 2 * kTileBytes);
        tma_load_3d(sK + s * kTileBytes, &tm_k, full0 + 8 * s, h * kD, t * BK, b);
        tma_load_3d(sV + s * kTileBytes, &tm_v, full0 + 8 * s, h * kD, t * BK, b);
      }
    }
  } else {
    // consumer warpgroup: 64 q rows; warp w owns rows 16w..16w+15, lane
    // (g, c) = (lane / 4, lane % 4) rows g and g + 8 of them
    if constexpr (Cfg<BK>::kOwnsSM) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int warp = tid / 32, lane = tid % 32, g = lane / 4, c = lane % 4;
    const uint64_t desc_q = sw128_desc(sQ + (wg - 1) * 64 * kRowBytes);
    float oacc[32];  // O: 64 x 64, n8 block j at [4j, 4j + 4)
    float sacc[BK / 2];  // S: 64 x BK
    uint32_t pa[BK / 4];  // P in bf16 pairs, the A operand of P V
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      mbar_wait(full0 + 8 * s, (t / kStages) & 1);

      fence_regs<BK / 2>(sacc);
      wgmma_fence();
      wgmma_qk<BK>(sacc, desc_q, sw128_desc(sK + s * kTileBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<BK / 2>(sacc);

      if ((t + 1) * BK > Nk) {  // ragged last tile: keys >= Nk take no weight
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          if (t * BK + 8 * (i / 4) + 2 * c + (i & 1) >= Nk) sacc[i] = -INFINITY;
      }
      // online softmax in the log2 domain; element i is in row g + 8 * ((i >> 1) & 1)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sacc[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);  // finite: the tile has a key
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const float p0 = ex2(fmaf(sacc[i], scale_log2, -m[r]));
        const float p1 = ex2(fmaf(sacc[i + 1], scale_log2, -m[r]));
        l[r] += p0 + p1;
        pa[i / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) oacc[i] *= alpha[(i >> 1) & 1];

      const uint64_t desc_v = sw128_desc(sV + s * kTileBytes);
      fence_regs<32>(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)  // 16 keys = 16 rows of 128 bytes per step
        wgmma_rs_n64(oacc, pa + 4 * kk, desc_v + kk * (16 * kRowBytes >> 4));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<32>(oacc);
      mbar_arrive(empty0 + 8 * s);
    }

    // epilogue: row sums over the quad, normalise, store rows < Nq
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int row = qt * kBQ + (wg - 1) * 64 + warp * 16 + g + 8 * r;
      if (row < Nq) {
        const float inv = 1.f / l[r];
        __nv_bfloat16* orow = o + ((size_t)(b * Nq + row) * H + h) * kD + 2 * c;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
              __floats2bfloat162_rn(oacc[4 * j + 2 * r] * inv, oacc[4 * j + 2 * r + 1] * inv);
        // m is the row max of the logits in log2 units: lse = (m + log2 l) ln 2
        if (lse != nullptr && c == 0)
          lse[((size_t)b * H + h) * Nq + row] = (m[r] + log2f(l[r])) * 0.6931471805599453f;
      }
    }
  }
}

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
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Nq,
           int Nk, int H, float scale_log2, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, Nq, H, kBQ) || !make_map(&tm_k, k, B, Nk, H, BK) ||
      !make_map(&tm_v, v, B, Nk, H, BK))
    return (int)cudaErrorInvalidValue;
  const int smem = Cfg<BK>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(flash_attn_kernel<BK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Nq + kBQ - 1) / kBQ, H, B);
  flash_attn_kernel<BK><<<grid, kThreads, smem, stream>>>(tm_q, tm_k, tm_v, (__nv_bfloat16*)o,
                                                          lse, Nq, Nk, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// bk: keys per K/V tile, 16, 64 or 128 (see ops/flash_attention.py `plan`);
// lse: (B, H, Nq) f32 log-sum-exp output, or null (inference)
extern "C" int flash_attention(const void* q, const void* k, const void* v, void* o, void* lse,
                               int B, int Nq, int Nk, int H, float scale, int bk, void* stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t st = (cudaStream_t)stream;
  float* l = (float*)lse;
  switch (bk) {
    case 16: return launch<16>(q, k, v, o, l, B, Nq, Nk, H, scale_log2, st);
    case 64: return launch<64>(q, k, v, o, l, B, Nq, Nk, H, scale_log2, st);
    case 128: return launch<128>(q, k, v, o, l, B, Nq, Nk, H, scale_log2, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
