// K3: tile-local connected-component spread (phase 1 of the CC tail).
//
// Replaces the TPU kernel `_local_cc_kernel` (entry
// `local_spread_converge`) in src/repro/kernels/cc_label/kernel.py.
//
// Every (th, tw) tile of every image (th, tw <= 32) goes to the fixpoint
// of the PixelLink one-hop max-label spread: a positive pixel takes the
// max label of each 8-neighbour its link bit points to, and a
// non-positive pixel is 0.  Neighbours outside the tile read as 0, so a
// tile edge acts as an image edge; the cross-tile merge (phase 2) runs
// afterwards in torch ops.  The reference iterates Jacobi hops until the
// tile stops changing (at most th * tw, a limit never reached: each
// round that changes something moves the labels one pixel further).
//
// The labels are the reference's for any input, links that are not
// symmetric and labels on non-positive pixels included:
// - round 0 is one Jacobi hop exactly as the reference's first, since it
//   reads the initial labels of non-positive neighbours before they are
//   zeroed;
// - after it every update l[p] <- max(l[p], l[q]), for a positive p and a
//   link p -> q (q outside the tile reading 0), is monotone and never
//   exceeds the fixpoint, so any order of such updates reaches the
//   reference's labels; a round that ends with a complete 8-neighbour hop
//   and changes nothing is at the fixpoint.
//
// What bounds it on an H100: bytes (the links are eight int32 per pixel,
// 32 of the 44 bytes a pixel moves); a work-efficient spread needs a few
// operations per pixel and link.  Jacobi rounds move a label one pixel a
// round, so a tile would take as many rounds, each behind block
// barriers, as its longest component path (up to th * tw for a winding
// one).  The design:
// - one 1024-thread block per tile, one pixel per thread (warp y = tile
//   row y, lane x = column x), the labels in shared memory with a zero
//   border, the link bits and the positive flag in a register, read with
//   two 16-byte loads; device memory is touched once per tile;
// - after round 0, each round runs a row pass (a segmented max-scan left
//   to right and another right to left along each warp's row, five
//   shuffles each; a segment breaks where a pixel is non-positive or its
//   link toward the scan's source is clear, and its ends are found once
//   by ballot), the same column pass on the transposed plane (warp y =
//   column y, lane x = row x), one full 8-neighbour hop, and
//   `__syncthreads_or` on "anything changed": three barriers a round;
// - straight runs of any length cross in one round: text-shaped blobs
//   converge in a few rounds where Jacobi needs about the tile's
//   diameter; a diagonal staircase still takes one round per step, no
//   more rounds than Jacobi.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 32;
constexpr int LDL = T + 3;        // odd: column reads are conflict-free
constexpr unsigned FULL = 0xffffffffu;
// bits of a pixel's mask: link d (neighbour order as
// postprocess.NEIGHBORS) in bit d, the positive flag in bit 8
constexpr int UP = 1, LEFT = 3, RIGHT = 4, DOWN = 6, POS = 8;

// segmented max-scans along the lanes of a warp.  A lane whose flag is
// set takes the result of its neighbour toward the scan's source, so
// lane i's result is the max over its segment: from the nearest lane at
// or before it whose flag is clear (`lo`, scanning upward) or at or after
// it (`hi`, downward).  The flags never change, so the segment ends are
// found once, with a ballot; each step is then one shuffle.
__device__ __forceinline__ int seg_lo(bool take, int lane) {
  const unsigned stop = ~__ballot_sync(FULL, take) & (FULL >> (31 - lane));
  return 31 - __clz(stop | 1u);
}

__device__ __forceinline__ int seg_hi(bool take, int lane) {
  const unsigned stop = ~__ballot_sync(FULL, take) & (FULL << lane);
  return stop ? __ffs(stop) - 1 : 31;
}

__device__ __forceinline__ int scan_up(int v, int lo, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_up_sync(FULL, v, s);
    if (lane - s >= lo) v = max(v, u);
  }
  return v;
}

__device__ __forceinline__ int scan_down(int v, int hi, int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int u = __shfl_down_sync(FULL, v, s);
    if (lane + s <= hi) v = max(v, u);
  }
  return v;
}

// one Jacobi hop at pixel (y, x) of the bordered plane
__device__ __forceinline__ int hop(int (*lab)[LDL], int y, int x,
                                   int l, unsigned mask) {
  if (!((mask >> POS) & 1u)) return 0;
  const int DY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int DX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
#pragma unroll
  for (int d = 0; d < 8; ++d)
    if ((mask >> d) & 1u) l = max(l, lab[y + 1 + DY[d]][x + 1 + DX[d]]);
  return l;
}

__global__ void __launch_bounds__(T * T)
cc_local_kernel(const int* __restrict__ labels, const int* __restrict__ pos,
                const int* __restrict__ lnk, int* __restrict__ out, int H,
                int W, int th, int tw) {
  __shared__ int lab[T + 2][LDL];     // pixel (y, x) at [y + 1][x + 1]
  __shared__ unsigned msk[T][T + 1];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int n = blockIdx.z;
  const bool inside = x < tw && y < th;
  const size_t g = ((size_t)n * H + (size_t)blockIdx.y * th + y) * W +
                   (size_t)blockIdx.x * tw + x;
  int l = 0;
  unsigned mask = 0;
  if (inside) {
    l = labels[g];
    const int4* lp = reinterpret_cast<const int4*>(lnk + g * 8);
    const int4 a = lp[0], b = lp[1];
    mask = (a.x != 0) | (a.y != 0) << 1 | (a.z != 0) << 2 | (a.w != 0) << 3 |
           (b.x != 0) << 4 | (b.y != 0) << 5 | (b.z != 0) << 6 |
           (b.w != 0) << 7 | (pos[g] != 0) << POS;
  }
  lab[y + 1][x + 1] = l;
  if (y < 2) lab[y * (T + 1)][x + 1] = 0;         // top and bottom border
  if (x < 2) lab[y + 1][x * (T + 1)] = 0;         // left and right border
  if (x < 2 && y < 2) lab[y * (T + 1)][x * (T + 1)] = 0;
  msk[y][x] = mask;
  __syncthreads();

  // this thread's segments: along its row, and along column y for the
  // pixel (row x, column y) it holds in the column pass
  const bool p = (mask >> POS) & 1u;
  const int row_lo = seg_lo(p && ((mask >> LEFT) & 1u) && x > 0, x);
  const int row_hi = seg_hi(p && ((mask >> RIGHT) & 1u) && x + 1 < tw, x);
  const unsigned tmask = msk[x][y];
  const bool tp = (tmask >> POS) & 1u;
  const int col_lo = seg_lo(tp && ((tmask >> UP) & 1u) && x > 0, x);
  const int col_hi = seg_hi(tp && ((tmask >> DOWN) & 1u) && x + 1 < th, x);

  // round 0: one Jacobi hop on the initial labels
  int nl = hop(lab, y, x, l, mask);
  int changed = __syncthreads_or(nl != l);
  l = nl;

  // each round: the labels enter shared memory after the row pass (every
  // read of the previous round's hop finished at its closing barrier)
  while (changed) {
    const int l0 = l;
    l = scan_up(l, row_lo, x);
    l = scan_down(l, row_hi, x);
    lab[y + 1][x + 1] = l;
    __syncthreads();
    int c = lab[x + 1][y + 1];
    c = scan_up(c, col_lo, x);
    c = scan_down(c, col_hi, x);
    lab[x + 1][y + 1] = c;
    __syncthreads();
    l = lab[y + 1][x + 1];
    nl = hop(lab, y, x, l, mask);
    changed = __syncthreads_or(nl != l0);
    l = nl;
  }
  if (inside) out[g] = l;
}

}  // namespace

extern "C" int cc_local_spread(const int* labels, const int* pos,
                               const int* lnk, int* out, int N, int H, int W,
                               int th, int tw, cudaStream_t stream) {
  if (th < 1 || th > T || tw < 1 || tw > T || H % th || W % tw ||
      (reinterpret_cast<uintptr_t>(lnk) & 15))
    return (int)cudaErrorInvalidValue;
  dim3 grid(W / tw, H / th, N);
  dim3 block(T, T);
  cc_local_kernel<<<grid, block, 0, stream>>>(labels, pos, lnk, out, H, W,
                                              th, tw);
  return (int)cudaGetLastError();
}
