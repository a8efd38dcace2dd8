// K3: tile-local connected-component spread (phase 1 of the CC tail).
//
// Replaces the TPU kernel `_local_cc_kernel` (entry
// `local_spread_converge`) in src/repro/kernels/cc_label/kernel.py.
//
// Every (th, tw) tile of every image (th, tw <= 32) iterates the
// PixelLink one-hop max-label spread until it stops changing, at most
// th * tw rounds: a positive pixel takes the max label of each
// 8-neighbour it is linked to (symmetrized link AND positive), and a
// non-positive pixel is 0.  Neighbours outside the tile count as 0, so a
// tile edge acts as an image edge; the cross-tile merge (phase 2) runs
// afterwards in torch ops.  The rounds are Jacobi steps, exactly as in
// the reference, so the per-tile round count matches it too; it is
// written to `rounds` (one int per tile).
//
// What bounds it on an H100: bytes for typical maps (the links are eight
// int32 per pixel), but the work depends on the data: a tile with a long
// winding component needs up to th * tw rounds.  The design keeps the
// whole iteration on chip: one 1024-thread block per tile, one pixel per
// thread, the labels in shared memory, the eight link bits and the
// positive flag in a register, and `__syncthreads_or` to stop as soon as
// no pixel of the tile changed.  Device memory is touched once per tile
// however many rounds it needs.
#include <cuda_runtime.h>

namespace {

constexpr int T = 32;

__global__ void __launch_bounds__(T * T)
cc_local_kernel(const int* __restrict__ labels, const int* __restrict__ pos,
                const int* __restrict__ lnk, int* __restrict__ out,
                int* __restrict__ rounds, int H, int W, int th, int tw) {
  __shared__ int lab[T][T];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int n = blockIdx.z;
  const bool inside = x < tw && y < th;
  const size_t g = ((size_t)n * H + (size_t)blockIdx.y * th + y) * W +
                   (size_t)blockIdx.x * tw + x;
  int l = 0;
  bool p = false;
  unsigned mask = 0;
  if (inside) {
    l = labels[g];
    p = pos[g] != 0;
#pragma unroll
    for (int d = 0; d < 8; ++d)
      if (lnk[g * 8 + d] != 0) mask |= 1u << d;
  }
  lab[y][x] = l;
  __syncthreads();

  // neighbour order (dy, dx) as postprocess.NEIGHBORS
  const int DY[8] = {-1, -1, -1, 0, 0, 1, 1, 1};
  const int DX[8] = {-1, 0, 1, -1, 1, -1, 0, 1};
  const int limit = th * tw;
  int it = 0;
  int changed = 1;
  while (changed && it < limit) {
    int nl = 0;
    if (inside && p) {
      nl = l;
#pragma unroll
      for (int d = 0; d < 8; ++d) {
        const int yy = y + DY[d];
        const int xx = x + DX[d];
        if (((mask >> d) & 1u) && yy >= 0 && yy < th && xx >= 0 && xx < tw)
          nl = max(nl, lab[yy][xx]);
      }
    }
    __syncthreads();                   // every read of this round is done
    const int ch = inside && nl != l;
    l = inside ? nl : 0;
    lab[y][x] = l;
    ++it;
    changed = __syncthreads_or(ch);    // also publishes the writes
  }
  if (inside) out[g] = l;
  if (x == 0 && y == 0)
    rounds[((size_t)n * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] = it;
}

}  // namespace

extern "C" int cc_local_spread(const int* labels, const int* pos,
                               const int* lnk, int* out, int* rounds, int N,
                               int H, int W, int th, int tw,
                               cudaStream_t stream) {
  dim3 grid(W / tw, H / th, N);
  dim3 block(T, T);
  cc_local_kernel<<<grid, block, 0, stream>>>(labels, pos, lnk, out, rounds,
                                              H, W, th, tw);
  return (int)cudaGetLastError();
}
