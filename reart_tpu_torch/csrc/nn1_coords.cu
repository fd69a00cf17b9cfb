// Single-direction 1-NN with the winner's coordinates.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn1_coords_pallas / _nn1c_kernel. For
// query (B, N, 3) and ref (B, M, 3), float32:
//   out_d (B, N):    squared distance to the nearest reference point;
//   out_i (B, N):    its int64 index;
//   out_c (B, N, 3): its coordinates (what the Chamfer gradient needs, so
//                    the caller issues no gather afterwards).
// Ties go to the lowest index.
//
// What bounds it on an H100: float32 ALU throughput at cloud scale
// ((9, 4096, 4096): 151M pairs at 8 flops); at the graph stage's shape
// (P^2 <= 400 part pairs of 20 anchors each) the work is 160k pairs and the
// launch itself is the cost, so all pairs go in ONE launch.
//
// Design: the one-query-per-thread scan of nn_scan.cuh with K = 1 and the
// winner's coordinates kept in registers. The batch is folded into
// blockIdx.x, and the block shrinks to the next multiple of 32 above N when
// N < 128, so 400 pairs of 20 points run as 400 one-warp blocks.

#include "nn_scan.cuh"

namespace {

__global__ void __launch_bounds__(nn_scan::kMaxBlock)
nn1_coords_kernel(const float* __restrict__ query,
                  const float* __restrict__ ref, int n, int m, int nblk,
                  float* __restrict__ out_d, long long* __restrict__ out_i,
                  float* __restrict__ out_c) {
  const int b = blockIdx.x / nblk;
  const int i = (blockIdx.x % nblk) * blockDim.x + threadIdx.x;
  float bd[1], bc[3];
  int bj[1];
  nn_scan::scan<1, true>(query + (size_t)b * n * 3, ref + (size_t)b * m * 3,
                         i, n, m, bd, bj, bc);
  if (i >= n) return;

  const size_t o = (size_t)b * n + i;
  out_d[o] = bd[0];
  out_i[o] = bj[0];
  out_c[3 * o] = bc[0];
  out_c[3 * o + 1] = bc[1];
  out_c[3 * o + 2] = bc[2];
}

}  // namespace

extern "C" int reart_nn1_coords(const float* query, const float* ref,
                                int batch, int n, int m, float* out_d,
                                long long* out_i, float* out_c,
                                void* stream) {
  const int block = nn_scan::block_for(n);
  const int nblk = (n + block - 1) / block;
  nn1_coords_kernel<<<(unsigned)batch * nblk, block, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      query, ref, n, m, nblk, out_d, out_i, out_c);
  return static_cast<int>(cudaGetLastError());
}
