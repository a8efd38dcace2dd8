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
// - the head dim is loaded as one, two or four 64-column TMA boxes (DH);
//   the hardware zero-fills columns D..64*DH-1 and KV rows past Lkv, and
//   Q K^T runs its k16 steps only up to D rounded up to 16.  Any D that is
//   a multiple of 8 up to 256 is taken (24, 64, 80, 112, 128 and
//   Zamba2-7B's 224 in the configs).  Shared memory per block: (1 + 2 * 2
//   stages) * DH * 8 KB + 1 KB of alignment slack + 40 B of barriers =
//   42,024 B for DH 1, 82,984 B for D = 128 (DH 2), under the 227 KB a
//   block may use, so two blocks share an SM; 164,904 B for D = 224 (DH
//   4), one block an SM;
// - DH 4 (D 136-256): O is 128 f32 accumulators a thread, and P V runs
//   as two m64n128k16 products per k16 step and term, over the first and
//   the last two atoms of V.  At D = 224 the fourth box is half zeros, so
//   P V does 8/7 of the needed products (the stores skip those columns).
//   What bounds it on an H100 at the Zamba2-7B shape (B 8, H 32, L 3840,
//   D 224, causal): 2 x 2 x 8 x 32 x 3840^2 x 224 / 2 = 1.69 TFLOP for
//   Q K^T and P V, 1.71 ms at the bf16 peak, against 1.76 GB of
//   q/k/v/o, 0.53 ms, so operations bound it; the lo term of P adds half
//   again to the products the kernel issues;
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
// f32, `flash_tf32_kernel<DP>` (the f32 LM route).  What bounds it on an
// H100: at the Zamba2 shape the 5.37 GFLOP run three times over in
// 3xTF32 (below) take 32.5 us at 495 TFLOP/s, against 25 us for the 84
// MB of q/k/v/o, so operations bound it (the same products as f32 FMAs
// on the CUDA cores, at 67 TFLOP/s, would take 80 us).  The design:
// - one 128-thread block per (64 query rows, query head, batch), the
//   query-block index reversed as in the bf16 grid; each warp owns 16
//   query rows;
// - S = Q K^T and O += P V are `mma.sync` m16n8k8 in 3xTF32 (tf32x3.cuh):
//   Q, K, V and P are each split into hi + lo TF32 terms where their
//   fragments are read, and each product issues three mma; the softmax
//   sums and O stay f32.  One TF32 term would leave 2^-11 relative error
//   on each operand, which misses the 2e-3 the f32 route is held to at the
//   Zamba2 head's scale (tests/test_torch_kernels.py::TestTF32Premise).
//   The split is the truncating one of tf32x3.cuh (two ALU operations:
//   with `cvt.rna` the kernel took 1.7x as long at the Zamba2 shape,
//   PERF.md), and each of the three products runs over every column tile
//   before the next, so consecutive mma are independent;
// - S and P stay in registers: the online softmax runs on S's
//   accumulators (row max and sum by quad shuffles, m and l per row in
//   registers, the exp2 domain on `ex2.approx`), and P feeds P V as the A
//   operand with the k index permuted, as K5 feeds W (ssd_chunk.cu): the
//   accumulator holds columns 2q and 2q + 1 where A wants q and q + 4, so
//   B reads V rows 2q and 2q + 1;
// - K and V tiles of 64 rows arrive by `cp.async` (16-byte copies where
//   D is a multiple of 4 and the operands 16-byte aligned, else 4-byte)
//   into a two-stage ring: the next tile's copy is issued before this
//   tile's products; rows past Lkv and columns D..DP-1 are zero-filled,
//   where DP is D rounded up to 16 (the instance);
// - Q, K and V are staged raw, rows DP + 4 floats apart, and split by
//   each warp where it reads them: staging hi and lo would double the
//   ring and leave one block per SM at D = 80; raw, Q and the ring take
//   5 x 64 x 84 x 4 = 107,520 B, so two blocks share an SM.  A row of
//   DP + 4 floats puts both fragment reads (K's rows indexed by n, V's by
//   the permuted k) in 32 distinct banks;
// - masks apply in registers, on the tiles that hold a masked column
//   only; a warp skips the 8-column tiles masked for all its rows (their
//   P is 0), and the sweep stops at the causal limit and at kv_len; rows
//   past Lq are not stored.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int BM = 64;          // query rows per block
constexpr int BN = 64;          // KV rows per step
constexpr int DMAX = 128;       // the f32 kernel's largest head dim
constexpr int WG_DMAX = 256;    // the bf16 kernel's: four 64-column boxes
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
__global__ void __launch_bounds__(WG_THREADS, DH == 1 ? 3 : DH == 2 ? 2 : 1)
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
      } else if constexpr (DH == 2) {
        wgmma_m64n128k16_rs(o, pa + 4 * k, dv);
        wgmma_m64n128k16_rs(o, pl + 4 * k, dv);
      } else {
        // four atoms: columns 0-127 and 128-255 as two n128 products, the
        // second from the third atom on (its accumulators o[64..127] hold
        // columns 128 + 8j + c as o[0..63] hold 8j + c)
        const uint64_t dv2 =
            smem_desc(v_addr + k * 2048 + 2 * HALF_BYTES, HALF_BYTES);
        wgmma_m64n128k16_rs(o, pa + 4 * k, dv);
        wgmma_m64n128k16_rs(o, pl + 4 * k, dv);
        wgmma_m64n128k16_rs(o + 64, pa + 4 * k, dv2);
        wgmma_m64n128k16_rs(o + 64, pl + 4 * k, dv2);
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
// f32: 3xTF32 mma.sync
// ---------------------------------------------------------------------------

constexpr int F_THREADS = 128;                // four warps, 16 query rows each

// Q, then STAGES x (K, V): 64 rows of DP + 4 floats each
__host__ __device__ constexpr int f32_smem_bytes(int dp) {
  return (1 + 2 * STAGES) * BM * (dp + 4) * 4;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + 64) x columns [0, DP) of an (L, D) f32 matrix into dst
// (rows DP + 4 floats apart), zero past row `rows` and column D; 16-byte
// copies where `vec` (D a multiple of 4, 16-byte aligned), else 4-byte
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int r0,
                                          int rows, int D, bool vec,
                                          int tid) {
  constexpr int LD = DP + 4;
  if (vec) {
#pragma unroll 1
    for (int i = tid; i < BM * (DP / 4); i += F_THREADS) {
      const int r = i / (DP / 4), c = i % (DP / 4) * 4;
      const bool in = r0 + r < rows && c < D;
      tf32x3::cp_async16(dst + r * LD + c,
                         in ? src + (size_t)(r0 + r) * D + c : src,
                         in ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = tid; i < BM * DP; i += F_THREADS) {
      const int r = i / DP, c = i % DP;
      const bool in = r0 + r < rows && c < D;
      tf32x3::cp_async4(dst + r * LD + c,
                        in ? src + (size_t)(r0 + r) * D + c : src,
                        in ? 4 : 0);
    }
  }
}

// 2^x by the SFU (`ex2.approx`), without exp2f's range handling
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
__global__ void __launch_bounds__(F_THREADS, 2)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len,
                  float scale_log2, int causal, int vec) {
  using tf32x3::mma;
  using tf32x3::split;
  constexpr int LD = DP + 4, NT = DP / 8, TILE = BN * LD;
  extern __shared__ __align__(16) float fsm[];
  float* qs = fsm;                            // [BM][LD]
  float* ks = qs + TILE;                      // [STAGES][BN][LD]
  float* vs = ks + STAGES * TILE;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BM;   // heaviest first
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, qd = lane % 4;
  const float* kg = k + ((size_t)b * Hkv + hk) * Lkv * D;
  const float* vg = v + ((size_t)b * Hkv + hk) * Lkv * D;
  int kv_end = min(Lkv, kv_len);
  if (causal) kv_end = min(kv_end, q0 + BM);
  const int ntiles = (kv_end + BN - 1) / BN;

  load_tile<DP>(qs, q + ((size_t)b * Hq + h) * Lq * D, q0, Lq, D, vec, tid);
  load_tile<DP>(ks, kg, 0, Lkv, D, vec, tid);
  load_tile<DP>(vs, vg, 0, Lkv, D, vec, tid);
  tf32x3::cp_async_commit();

  // mma m16n8 accumulator layout: this thread holds rows r0 and r0 + 8,
  // and in each 8-column tile n the columns 8n + 2qd + {0, 1}:
  // x[n][0..1] on row r0, x[n][2..3] on r0 + 8
  const int r0 = q0 + warp * 16 + g;
  const float* qw = qs + (warp * 16 + g) * LD + qd;
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES, c0 = t * BN;
    if (t + 1 < ntiles) {       // the next tile's copy overlaps this one
      load_tile<DP>(ks + (s ^ 1) * TILE, kg, c0 + BN, Lkv, D, vec, tid);
      load_tile<DP>(vs + (s ^ 1) * TILE, vg, c0 + BN, Lkv, D, vec, tid);
      tf32x3::cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();            // tile t (and Q) landed for every thread
    const float* kt = ks + s * TILE;
    const float* vt = vs + s * TILE;
    // 8-column tiles of this warp that hold a column it may see: the
    // rest are masked for all its 16 rows, and skipped (P is 0 there)
    int jn = min(BN / 8, (kv_len - c0 + 7) / 8);
    if (causal) jn = min(jn, (q0 + warp * 16 + 15 - c0) / 8 + 1);

    // S = Q K^T: A = Q rows (k = head dim), B = K rows (n = KV row)
    float sc[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      uint32_t ahi[4], alo[4];
      split(qw[8 * kk], ahi[0], alo[0]);
      split(qw[8 * kk + 8 * LD], ahi[1], alo[1]);
      split(qw[8 * kk + 4], ahi[2], alo[2]);
      split(qw[8 * kk + 8 * LD + 4], ahi[3], alo[3]);
      const float* kr = kt + g * LD + 8 * kk + qd;
      uint32_t bhi[BN / 8][2], blo[BN / 8][2];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (j < jn) {
          split(kr[8 * j * LD], bhi[j][0], blo[j][0]);
          split(kr[8 * j * LD + 4], bhi[j][1], blo[j][1]);
        }
      // the three products of 3xTF32, each over all column tiles before
      // the next, so that consecutive mma are independent
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (j < jn) mma(sc[j], ahi, blo[j]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (j < jn) mma(sc[j], alo, bhi[j]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        if (j < jn) mma(sc[j], ahi, bhi[j]);
    }

    // online softmax in the log2 domain, on the accumulators
    const bool masked = c0 + BN > kv_len || (causal && c0 + BN - 1 > q0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale_log2;
        if (masked) {
          const int c = c0 + 8 * j + 2 * qd + (e & 1), r = r0 + 8 * (e >> 1);
          if (c >= kv_len || (causal && c > r)) x = NEG_INF;
        }
        sc[j][e] = x;
      }
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(sc[j][0], sc[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[j][2], sc[j][3]));
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2(m_run[i] - mx[i]);
      m_run[i] = mx[i];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(sc[j][e] - mx[e >> 1]);
        sc[j][e] = p;
        sum[e >> 1] += p;
      }
    // l is kept per thread (its 16 columns) and summed over the quad at
    // the end: alpha is the same for the 4 threads of a row
    l_run[0] = l_run[0] * alpha[0] + sum[0];
    l_run[1] = l_run[1] * alpha[1] + sum[1];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V, P from the accumulators as A with the k index permuted:
    // they hold columns 2qd, 2qd + 1 where A's k-slots qd, qd + 4 are
    // wanted, so slot qd takes column 2qd, slot qd + 4 column 2qd + 1,
    // and B reads V rows 8j + 2qd and 8j + 2qd + 1
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j < jn) {
        uint32_t ahi[4], alo[4];
        split(sc[j][0], ahi[0], alo[0]);
        split(sc[j][2], ahi[1], alo[1]);
        split(sc[j][1], ahi[2], alo[2]);
        split(sc[j][3], ahi[3], alo[3]);
        const float* vr = vt + (8 * j + 2 * qd) * LD + g;
        uint32_t bhi[NT][2], blo[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          split(vr[8 * n], bhi[n][0], blo[n][0]);
          split(vr[LD + 8 * n], bhi[n][1], blo[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(o[n], ahi, blo[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(o[n], alo, bhi[n]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma(o[n], ahi, bhi[n]);
      }
    }
    __syncthreads();            // every warp is done with stage s
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    inv[i] = 1.f / fmaxf(l, 1e-30f);
  }
  float* og = out + ((size_t)b * Hq + h) * Lq * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + 8 * i;
    if (r >= Lq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * qd;
      if (c < D) og[(size_t)r * D + c] = o[n][2 * i] * inv[i];
      if (c + 1 < D) og[(size_t)r * D + c + 1] = o[n][2 * i + 1] * inv[i];
    }
  }
}

template <int DP>
int launch_tf32(const void* q, const void* k, const void* v, void* out, int B,
                int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len,
                float scale, int causal, cudaStream_t stream) {
  constexpr int smem = f32_smem_bytes(DP);
  static bool configured = false;   // the attribute is set once per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tf32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int vec = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(q) |
                                  reinterpret_cast<uintptr_t>(k) |
                                  reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  dim3 grid(Hq, B, (Lq + BM - 1) / BM);
  flash_tf32_kernel<DP><<<grid, F_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Hq, Hkv, Lq,
      Lkv, D, kv_len, scale * LOG2E, causal, vec);
  return (int)cudaGetLastError();
}

// the head dim rounded up to 16 picks the instance
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int Hq, int Hkv, int Lq, int Lkv, int D, int kv_len,
               float scale, int causal, cudaStream_t stream) {
#define FLASH_TF32(DP)                                                       \
  case DP / 16:                                                              \
    return launch_tf32<DP>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,    \
                           scale, causal, stream);
  switch ((D + 15) / 16) {
    FLASH_TF32(16) FLASH_TF32(32) FLASH_TF32(48) FLASH_TF32(64)
    FLASH_TF32(80) FLASH_TF32(96) FLASH_TF32(112) FLASH_TF32(128)
  }
#undef FLASH_TF32
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32 (3xTF32 mma.sync, any D up to 128), 1 = bfloat16
// (wgmma, D a multiple of 8 up to 256)
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, int B, int Hq,
                                   int Hkv, int Lq, int Lkv, int D,
                                   int kv_len, float scale, int causal,
                                   int dtype, cudaStream_t stream) {
  if (D < 1 || Hkv < 1 || Hq % Hkv != 0 || kv_len < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D <= DMAX)
    return launch_f32(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len, scale,
                      causal, stream);
  if (dtype == 1 && D % 8 == 0 && D <= WG_DMAX) {
    if (D <= 64)
      return launch_wgmma<1>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,
                             scale, causal, stream);
    if (D <= 128)
      return launch_wgmma<2>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,
                             scale, causal, stream);
    return launch_wgmma<4>(q, k, v, out, B, Hq, Hkv, Lq, Lkv, D, kv_len,
                           scale, causal, stream);
  }
  return (int)cudaErrorInvalidValue;
}
