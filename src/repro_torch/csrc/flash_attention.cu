// K4: blockwise online-softmax attention (flash), causal or not, with GQA.
//
// Replaces the TPU kernel `_flash_kernel` (entry
// `flash_attention_padded`, whose `pl.pallas_call` is at
// src/repro/kernels/flash_attention/kernel.py:117).
//
// q (B, Hq, Lq, D), k and v (B, Hkv, Lkv, D), all contiguous, in bf16 or
// f32; out (B, Hq, Lq, D) in q's type.  Query head h reads KV head
// h / (Hq / Hkv).  Columns at or past kv_len are masked, and with `causal`
// column c is masked for row r when c > r (global indices, Lq == Lkv as
// in the reference).  Scores, the running max m, the normaliser l and the
// accumulator are f32; the flush writes acc / max(l, 1e-30) rounded to
// the output type (to nearest even, as torch's .to()).  Ragged Lq and Lkv
// are handled in the kernel, so the caller pads nothing.
//
// bf16, `flash_wgmma_kernel` (the Zamba2 prefill's 9 launches).  What
// bounds it on an H100: at the Zamba2 shape (B 4, H 32, L 512, D 80,
// causal) the work is 5.37 GFLOP against 42 MB of q/k/v/o, 5.4 us on the
// bf16 tensor cores and 12.5 us of bytes, so bytes bound it; the first
// version ran every product as f32 FMAs on the CUDA cores (80 us floor,
// 0.47 ms measured), copied K and V with every thread and sent the score
// tile through shared memory.  This design:
// - one block per (64 query rows, query head, batch) with one consumer
//   warpgroup (threads 0-127) and one producer warp (128-159);
// - the producer's lane 0 loads Q once and then 64-row K and V tiles into
//   a 2-stage ring with TMA (3-D tensor maps over (D, L, B*H), 128-byte
//   swizzle), signalled by `full` mbarriers; the consumers free a stage
//   through its `empty` mbarrier;
// - S = Q K^T is `wgmma` m64n64k16 with both operands in shared memory
//   (K-major) and f32 accumulators in registers; the online softmax runs
//   on those registers (row max and sum by quad shuffles, m and l per row
//   in registers), in the exp2 domain; S and P never touch shared memory;
// - P stays in registers, where its accumulator layout is exactly the
//   register-A fragment of O += P V (`wgmma` m64nNk16, V the MN-major B
//   operand in shared memory), as two bf16 terms (below); O is rescaled
//   by alpha in registers;
// - the head dim is loaded as one or two 64-column TMA boxes (DH halves);
//   the hardware zero-fills columns D..64*DH-1 and KV rows past Lkv, and
//   Q K^T runs its k16 steps only up to D rounded up to 16.  Any D that is
//   a multiple of 8 up to 128 is taken (24, 64, 80, 112, 128 in the
//   configs).  Shared memory per block: (1 + 2 * 2 stages) * DH * 8 KB +
//   1 KB of alignment slack + 40 B of barriers = 42,024 B for DH 1 and
//   82,984 B for D = 128 (DH 2), under the 227 KB a block may use, so two
//   blocks share an SM;
// - masks (c >= kv_len, c > r) are applied in registers, on the tiles
//   that hold a masked column only; the KV sweep stops at the causal
//   limit and at kv_len; rows past Lq are not stored;
// - the grid is (Hq, B, query blocks) with the query-block index reversed,
//   so the blocks with the longest causal sweep start first.
// Rounding: P enters P V as hi = bf16(p) plus lo = bf16(p - hi), two
// wgmma steps per k16 slice against the same V tile, so P carries 16
// significant bits (relative error 2^-17) where one bf16 term carries 8
// (2^-9); the softmax sums stay f32.  One term is not enough: the TPU
// kernel's default-precision `jnp.dot` feeds its MXU bf16 P, but in the
// Zamba2 prefill |v| reaches ~50 and the softmax is nearly one-hot, so a
// 2^-9 error on a weight near 1/2 moves an output near 0 by 0.02-0.03,
// beyond the 1.6e-2 (atol and rtol) tolerance against the plain
// f32-softmax version at every one of the 9 attention sites.  With the
// lo term the error is the output's own bf16 rounding.  The second term
// doubles the P V steps; on an H100 it costs about 15% of the kernel's
// time at the Zamba2 shape (PERF.md).
//
// f32, `flash_kernel`: the plain CUDA-core kernel, picked by dtype
// (TF32 would change the f32 results the f32 LM route is held to).  One
// 256-thread block per (64-row query block, query head, batch); the query
// tile and one 64-row K and V tile at a time sit in shared memory; each
// thread computes a 4 x 4 patch of the 64 x 64 score tile, the 4 threads
// of a row run the online softmax with warp shuffles, and each thread
// accumulates a 4-row x D/16 patch of P.V in registers.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // KV rows per step
constexpr int THREADS = 256;
constexpr int DMAX = 128;
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// bf16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int WG_THREADS = 160;               // 4 consumer warps + 1 producer
constexpr int STAGES = 2;                     // K/V ring depth
constexpr int HALF_BYTES = 64 * 128;          // 64 rows x 64 bf16 columns
constexpr float LOG2E = 1.4426950408889634f;

// Q, then STAGES x (K, V), each DH halves; then 1 + 2 * STAGES barriers.
// Mirrored by flash_attention/ops.py:wgmma_geometry.
__host__ __device__ constexpr int wg_smem_bytes(int dh) {
  return (1 + 2 * STAGES) * dh * HALF_BYTES + 1024 + 8 * (1 + 2 * STAGES);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// returns once the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle.  K-major (Q, K): rows
// of 128 B, 8-row groups 1024 B apart (SBO), LBO unused (1).  MN-major
// (V): 64-column atoms `lbo` bytes apart (LBO), 8-row K groups 1024 B
// apart (SBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
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
// keeps the compiler from moving accesses of wgmma's registers across
// the async instructions
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_m64n64k16_ss(float* d, uint64_t da,
                                                   uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_m64n64k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128k16_rs(float* d, const uint32_t* a,
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DH>
__global__ void __launch_bounds__(WG_THREADS, DH == 1 ? 3 : 2)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ out, int Hq, int Hkv, int Lq,
                   int Lkv, int D, int kv_len, float scale_log2, int causal) {
  constexpr int NO = 32 * DH;                 // O accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ks = qs + DH * HALF_BYTES;         // [STAGES][DH][64][64]
  uint8_t* vs = ks + STAGES * DH * HALF_BYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * DH * HALF_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // heaviest first
  const int hk = h / (Hq / Hkv);
  int kv_end = min(Lkv, kv_len);
  if (causal) kv_end = min(kv_end, q0 + BM);
  const int ntiles = (kv_end + BN - 1) / BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {                             // producer
    if (lane == 0) {
      const int qz = b * Hq + h, kz = b * Hkv + hk;
      mbar_expect_tx(q_full, DH * HALF_BYTES);
      for (int c = 0; c < DH; ++c)
        tma_load_3d(qs + c * HALF_BYTES, &tq, q_full, 64 * c, q0, qz);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], 2 * DH * HALF_BYTES);
        for (int c = 0; c < DH; ++c) {
          tma_load_3d(ks + (s * DH + c) * HALF_BYTES, &tk, &full[s], 64 * c,
                      t * BN, kz);
          tma_load_3d(vs + (s * DH + c) * HALF_BYTES, &tv, &full[s], 64 * c,
                      t * BN, kz);
        }
      }
    }
    return;
  }

  // consumer warpgroup.  Accumulator layout of wgmma m64nN: this thread
  // holds rows r0 and r0 + 8, and in each 8-column block j the columns
  // 8j + 2*(lane%4) + {0, 1}: d[4j + {0,1}] on row r0, d[4j + {2,3}] on r0+8.
  const int r0 = q0 + warp * 16 + lane / 4;
  const int c_lane = 2 * (lane % 4);
  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};
  const int nk16 = (D + 15) / 16;
  const uint32_t q_addr = smem_u32(qs);

  mbar_wait(q_full, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    const uint32_t k_addr = smem_u32(ks + s * DH * HALF_BYTES);
    const uint32_t v_addr = smem_u32(vs + s * DH * HALF_BYTES);
    mbar_wait(&full[s], (t / STAGES) & 1);

    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.f;
    reg_fence<32>(sc);
    wgmma_fence();
    for (int kk = 0; kk < nk16; ++kk) {
      // k16 step kk: half kk/4, 32-byte column offset within the 128-byte row
      const uint32_t off = (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_m64n64k16_ss(sc, smem_desc(q_addr + off, 16),
                         smem_desc(k_addr + off, 16), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<32>(sc);

    // online softmax in the log2 domain
    const int c0 = t * BN + c_lane;
    const bool masked =
        t * BN + BN > kv_len || (causal && t * BN + BN - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e] * scale_log2;
        if (masked) {
          const int c = c0 + 8 * j + (e & 1), r = r0 + 8 * (e >> 1);
          if (c >= kv_len || (causal && c > r)) x = NEG_INF;
        }
        sc[4 * j + e] = x;
      }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[4 * j + e] - mx[e >> 1]);
        sc[4 * j + e] = p;
        sum[e >> 1] += p;
      }
    // l is kept per thread (its 16 columns) and reduced over the quad at
    // the end: alpha is the same for the 4 threads of a row
    l_run[0] = l_run[0] * alpha[0] + sum[0];
    l_run[1] = l_run[1] * alpha[1] + sum[1];
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }

    // P as two bf16 terms, hi = bf16(p) and lo = bf16(p - hi), in the
    // register-A fragments of the four k16 steps of P V
    uint32_t pa[16], pl[16];
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = sc[8 * k + 2 * i], y = sc[8 * k + 2 * i + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
        pa[4 * k + i] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[4 * k + i] = pack_bf16(x - __low2float(hi), y - __high2float(hi));
      }

    reg_fence<NO>(o);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // 16 KV rows of V: two 8-row groups of 128 B per 64-column atom
      const uint64_t dv = smem_desc(v_addr + k * 2048, HALF_BYTES);
      if constexpr (DH == 1) {
        wgmma_m64n64k16_rs(o, pa + 4 * k, dv);
        wgmma_m64n64k16_rs(o, pl + 4 * k, dv);
      } else {
        wgmma_m64n128k16_rs(o, pa + 4 * k, dv);
        wgmma_m64n128k16_rs(o, pl + 4 * k, dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<NO>(o);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  __nv_bfloat16* og = out + ((size_t)b * Hq + h) * Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int j = 0; j < NO / 4; ++j) {
      const int c = 8 * j + c_lane;
      if (8 * j < D)
        *reinterpret_cast<uint32_t*>(og + (size_t)r * D + c) =
            pack_bf16(o[4 * j + 2 * i] * inv[i], o[4 * j + 2 * i + 1] * inv[i]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, reached through the runtime so that the
// library needs no link against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B*H, L, D) bf16 as a 3-D map with 64 x 64 boxes, 128-byte swizzle; out
// of bounds reads as zeros
bool make_map(CUtensorMap* map, const void* base, int D, int L, int Z) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)Z};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)L * D * 2};
  cuuint32_t box[3] = {64, 64, 1};
  cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DH>
int launch_wgmma(const void* q, const void* k, const void* v, void* out, int B,
                 int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len,
                 float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, D, Lq, B * Hq) || !make_map(&tk, k, D, Lkv, B * Hkv) ||
      !make_map(&tv, v, D, Lkv, B * Hkv))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = wg_smem_bytes(DH);
  static bool configured = false;   // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(Hq, B, (Lq + BM - 1) / BM);
  flash_wgmma_kernel<DH><<<grid, WG_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), Hq, Hkv, Lq, Lkv, D,
      kv_len, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the plain CUDA-core kernel
// ---------------------------------------------------------------------------

// shared memory: qs[BM][D+1], ks[BN][D+1], vs[BN][D], ss[BM][BN+1],
// m[BM], l[BM], alpha[BM]
__host__ __device__ inline size_t smem_floats(int D) {
  return (size_t)BM * (D + 1) + (size_t)BN * (D + 1) + (size_t)BN * D +
         (size_t)BM * (BN + 1) + 3 * BM;
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int Hq,
             int Hkv, int Lq, int Lkv, int D, int kv_len, float scale,
             int causal) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* qs = smem;
  float* ks = qs + BM * ldq;
  float* vs = ks + BN * ldq;
  float* ss = vs + BN * D;
  float* m_s = ss + BM * (BN + 1);
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float* qg = q + ((size_t)b * Hq + h) * Lq * D;
  const float* kg = k + ((size_t)b * Hkv + hk) * Lkv * D;
  const float* vg = v + ((size_t)b * Hkv + hk) * Lkv * D;
  float* og = out + ((size_t)b * Hq + h) * Lq * D;

  for (int i = tid; i < BM * D; i += THREADS) {
    const int r = i / D, d = i % D;
    qs[r * ldq + d] = (q0 + r < Lq) ? qg[(size_t)(q0 + r) * D + d] : 0.f;
  }
  if (tid < BM) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // score patch: rows ty*4 + i, columns tx + 16*j
  const int ty = tid / 16, tx = tid % 16;
  // softmax: 4 threads per row, 16 columns each (part + 4*j)
  const int srow = tid / 4, spart = tid % 4;
  // accumulator patch: rows ty*4 + i, columns tx + 16*j (j < D/16)
  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;

  int kv_end = min(Lkv, kv_len);
  if (causal) kv_end = min(kv_end, q0 + BM);
  for (int k0 = 0; k0 < kv_end; k0 += BN) {
    __syncthreads();   // previous step's readers of ks/vs/ss are done
    for (int i = tid; i < BN * D; i += THREADS) {
      const int r = i / D, d = i % D;
      const bool in = k0 + r < Lkv;
      ks[r * ldq + d] = in ? kg[(size_t)(k0 + r) * D + d] : 0.f;
      vs[r * D + d] = in ? vg[(size_t)(k0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty * 4 + i) * ldq + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * ldq + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const bool keep = c < kv_len && (!causal || c <= r);
        ss[(ty * 4 + i) * (BN + 1) + tx + 16 * j] =
            keep ? s[i][j] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax over this block, 4 threads per row
    {
      float* row = ss + srow * (BN + 1);
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) mx = fmaxf(mx, row[spart + 4 * j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[srow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 4; ++j) {
        const float p = expf(row[spart + 4 * j] - m_new);
        row[spart + 4 * j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (spart == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[srow] = alpha;
        l_s[srow] = l_s[srow] * alpha + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P . V
    const int ncol = (D - tx + 15) / 16;   // columns tx + 16*j < D
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= al;
    }
    for (int c = 0; c < BN; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * (BN + 1) + c];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        if (j < ncol) {
          const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

  const int ncol = (D - tx + 15) / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= Lq) continue;
    const float inv_l = 1.f / fmaxf(l_s[ty * 4 + i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      if (j < ncol)
        og[(size_t)r * D + tx + 16 * j] = acc[i][j] * inv_l;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len,
               float scale, int causal, cudaStream_t stream) {
  const int smem = (int)(smem_floats(D) * sizeof(float));
  static int configured = 0;        // the largest size set so far
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid((Lq + BM - 1) / BM, Hq, B);
  flash_kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Lq,
      Lkv, D, kv_len, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma, D a multiple of 8)
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int Lq, int Lkv, int D,
                                   int kv_len, float scale, int causal,
                                   int dtype, cudaStream_t stream) {
  if (D < 1 || D > DMAX || Hkv < 1 || Hq % Hkv != 0 || kv_len < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_f32(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len, scale,
                      causal, stream);
  if (dtype == 1 && D % 8 == 0) {
    if (D <= 64)
      return launch_wgmma<1>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,
                             scale, causal, stream);
    return launch_wgmma<2>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,
                           scale, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}
