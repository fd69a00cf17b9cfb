// Bidirectional 1-NN without coordinates.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn_bidir_pallas / _bidir_kernel. For
// src (B, N, 3) and tgt (B, M, 3), float32:
//   forward (per src point): squared distance to and int64 index of its
//           nearest tgt point -> fd (B, N), fi (B, N);
//   reverse (per tgt point): the same against src -> bd (B, M), bi (B, M).
// Ties go to the lowest index. This is the Chamfer metric's search: both
// directions of compute_chamfer_list in one launch.
//
// What bounds it on an H100: float32 ALU throughput, 2 x B x N x M pairs at
// 8 flops each; the clouds and outputs are a few MB.
//
// Design: the TPU kernel reduces each distance tile along both axes and
// carries the column minima in scratch memory across a sequential grid; CUDA
// blocks run in no order, so the two directions are the two halves of one
// launch (blockIdx.y), each the one-query-per-thread scan of nn_scan.cuh
// with K = 1. No atomics, so the result is deterministic; each distance is
// computed twice. The batch is folded into blockIdx.x.

#include "nn_scan.cuh"

namespace {

__global__ void __launch_bounds__(nn_scan::kMaxBlock)
nn_bidir_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
                int n, int m, int nblk, float* __restrict__ fd,
                long long* __restrict__ fi, float* __restrict__ bd,
                long long* __restrict__ bi) {
  const bool rev = blockIdx.y == 1;
  const int nq = rev ? m : n;
  const int nr = rev ? n : m;
  const int blk = blockIdx.x % nblk;
  if (blk * blockDim.x >= nq) return;  // whole block past this direction
  const int b = blockIdx.x / nblk;
  const int i = blk * blockDim.x + threadIdx.x;
  float best[1], bc[3];
  int best_j[1];
  nn_scan::scan<1, false>((rev ? tgt : src) + (size_t)b * nq * 3,
                          (rev ? src : tgt) + (size_t)b * nr * 3, i, nq, nr,
                          best, best_j, bc);
  if (i >= nq) return;

  const size_t o = (size_t)b * nq + i;
  (rev ? bd : fd)[o] = best[0];
  (rev ? bi : fi)[o] = best_j[0];
}

}  // namespace

extern "C" int reart_nn_bidir(const float* src, const float* tgt, int batch,
                              int n, int m, float* fd, long long* fi,
                              float* bd, long long* bi, void* stream) {
  const int rows = n > m ? n : m;
  const int block = nn_scan::block_for(rows);
  const int nblk = (rows + block - 1) / block;
  const dim3 grid((unsigned)batch * nblk, 2);
  nn_bidir_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, n, m, nblk, fd, fi, bd, bi);
  return static_cast<int>(cudaGetLastError());
}
