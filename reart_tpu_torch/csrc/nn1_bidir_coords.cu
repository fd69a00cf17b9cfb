// Fused bidirectional 1-NN with the winners' coordinates, both ways.
//
// Replaces reart_tpu/ops/pallas_nn.py: nn1_bidir_coords_pallas /
// _nn1c_bidir_kernel. For src (B, N, 3) and tgt (B, M, 3), float32:
//   forward  (per src point): squared distance to, index of, and coords of
//            its nearest tgt point -> fd (B, N), fi (B, N), fc (B, N, 3);
//   reverse  (per tgt point): the same against src -> bd, bi, bc.
// Distances are channel-wise diff^2, summed (dx^2 + dy^2) + dz^2 (the
// Pallas kernel's _sqdist_tile order); ties go to the lowest index.
//
// What bounds it on an H100: float32 ALU throughput. At (9, 4096, 4096)
// there are 151M point pairs per direction at ~11 instructions each; the
// clouds themselves are 0.9 MB, so memory is not the limit.
//
// Design: the TPU kernel carries the reverse (column) minima across a
// sequential grid; CUDA blocks run in no order, so this kernel computes the
// two directions as two halves of one launch (blockIdx.z), each a plain
// "one query per thread, reference tiles staged in shared memory" 1-NN. Every
// thread walks the references in ascending index with a strict '<', so ties
// go to the lowest index with no cross-block merge and no atomics, and the
// result is deterministic. The price is computing each distance twice
// ((q - r)^2 == (r - q)^2 bit for bit); a single pass with a 64-bit
// atomicMin column merge is later work. Ragged N and M are masked, not
// padded. Built with -fmad=false so no sum is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 128;  // queries per block, one per thread
constexpr int kTile = 1024;  // reference points per shared-memory tile

__global__ void __launch_bounds__(kBlock)
nn1_dir_kernel(const float* __restrict__ src, const float* __restrict__ tgt,
               int n, int m, float* __restrict__ fd,
               long long* __restrict__ fi, float* __restrict__ fc,
               float* __restrict__ bd, long long* __restrict__ bi,
               float* __restrict__ bc) {
  __shared__ float4 tile[kTile];
  const bool rev = blockIdx.z == 1;
  const int nq = rev ? m : n;
  const int nr = rev ? n : m;
  if (blockIdx.x * kBlock >= nq) return;  // whole block past this direction
  const int b = blockIdx.y;
  const float* q = (rev ? tgt : src) + (size_t)b * nq * 3;
  const float* r = (rev ? src : tgt) + (size_t)b * nr * 3;
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool active = i < nq;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
  float best = INFINITY;
  int best_j = 0;
  for (int t0 = 0; t0 < nr; t0 += kTile) {
    const int cnt = min(kTile, nr - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += kBlock) {
      const float* p = r + 3 * (size_t)(t0 + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < cnt; ++k) {
      const float4 p = tile[k];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      float d = dx * dx + dy * dy;
      d = d + dz * dz;
      if (d < best) {
        best = d;
        best_j = t0 + k;
      }
    }
  }
  if (!active) return;

  const size_t o = (size_t)b * nq + i;
  float* od = rev ? bd : fd;
  long long* oi = rev ? bi : fi;
  float* oc = rev ? bc : fc;
  od[o] = best;
  oi[o] = best_j;
  const float* w = r + 3 * (size_t)best_j;
  oc[3 * o] = w[0];
  oc[3 * o + 1] = w[1];
  oc[3 * o + 2] = w[2];
}

}  // namespace

extern "C" int reart_nn1_bidir_coords(const float* src, const float* tgt,
                                      int batch, int n, int m, float* fd,
                                      long long* fi, float* fc, float* bd,
                                      long long* bi, float* bc,
                                      void* stream) {
  const int rows = n > m ? n : m;
  const dim3 grid((rows + kBlock - 1) / kBlock, batch, 2);
  nn1_dir_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      src, tgt, n, m, fd, fi, fc, bd, bi, bc);
  return static_cast<int>(cudaGetLastError());
}
