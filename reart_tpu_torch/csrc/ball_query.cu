// Ball query: for every centroid the first `nsample` points of its cloud that
// lie within `radius`, in point order.
//
// Replaces reart_tpu/ops/pallas_nn.py: ball_query_pallas / _bq_kernel (and
// the sort formulation of reart_tpu/ops/sampling.py: ball_query). For xyz
// (B, N, 3) and centroids new_xyz (B, S, 3), float32, writes out
// (B, S, nsample) int64: the indices j with
//   (dx^2 + dy^2) + dz^2 < r2        (strict, float32, no FMA)
// ascending in j, the first nsample of them; slots past the last hit hold the
// first hit; a centroid without a hit holds 0 in every slot. r2 is rounded to
// float32 by the caller, so the kernel and the plain version compare against
// the same number.
//
// What bounds it on an H100: float32 ALU throughput. Every (centroid, point)
// pair that is looked at costs 8 flops and a compare; the clouds and the
// output are a few MB. How many pairs are looked at depends on the data: a
// centroid stops at its nsample-th hit.
//
// Design: one warp per centroid. The TPU kernel's (TN, M) key tile with
// nsample min-passes over it is not carried over: a warp that walks the
// cloud in order, 32 points at a time, knows each hit's rank from a ballot
// (the hits of lower lanes plus the running count) and writes it straight to
// its slot, so the work is one pass that ends early. The eight warps of a
// block share the cloud through shared-memory tiles; the block leaves the
// loop when all of its warps are done. No limit on N. The batch and the
// centroid blocks are folded into blockIdx.x.

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;     // centroids per block, one per warp
constexpr int kTile = 1024;   // cloud points per shared-memory tile

__global__ void __launch_bounds__(kWarps * 32)
ball_query_kernel(const float* __restrict__ xyz,
                  const float* __restrict__ new_xyz, int n, int s, int sblk,
                  float r2, int nsample, long long* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.x / sblk;
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x % sblk) * kWarps + (threadIdx.x >> 5);
  const bool live = c < s;
  const unsigned lower = (1u << lane) - 1u;
  xyz += (size_t)b * n * 3;

  float cx = 0.f, cy = 0.f, cz = 0.f;
  long long* o = out;
  if (live) {
    const float* p = new_xyz + ((size_t)b * s + c) * 3;
    cx = p[0];
    cy = p[1];
    cz = p[2];
    o = out + ((size_t)b * s + c) * nsample;
  }
  int count = 0;   // hits written so far (warp-uniform)
  int first = 0;   // the first hit (warp-uniform), 0 while there is none
  bool done = !live;

  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int cnt = min(kTile, n - t0);
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const float* p = xyz + 3 * (size_t)(t0 + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (!done) {
      for (int k0 = 0; k0 < cnt; k0 += 32) {
        const int k = k0 + lane;
        bool hit = false;
        if (k < cnt) {
          const float4 p = tile[k];
          const float dx = cx - p.x;
          const float dy = cy - p.y;
          const float dz = cz - p.z;
          float d = dx * dx + dy * dy;
          d = d + dz * dz;
          hit = d < r2;
        }
        const unsigned ballot = __ballot_sync(0xffffffffu, hit);
        if (ballot) {
          if (count == 0) first = t0 + k0 + __ffs(ballot) - 1;
          const int slot = count + __popc(ballot & lower);
          if (hit && slot < nsample) o[slot] = t0 + k;
          count += __popc(ballot);
          if (count >= nsample) {
            done = true;
            break;
          }
        }
      }
    }
    // a barrier as well: the tile is free to be overwritten after it
    if (__syncthreads_and(done)) break;
  }
  if (live) {
    for (int k = min(count, nsample) + lane; k < nsample; k += 32)
      o[k] = first;
  }
}

}  // namespace

extern "C" int reart_ball_query(const float* xyz, const float* new_xyz,
                                int batch, int n, int s, float r2,
                                int nsample, long long* out, void* stream) {
  const int sblk = (s + kWarps - 1) / kWarps;
  ball_query_kernel<<<(unsigned)batch * sblk, kWarps * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      xyz, new_xyz, n, s, sblk, r2, nsample, out);
  return static_cast<int>(cudaGetLastError());
}
