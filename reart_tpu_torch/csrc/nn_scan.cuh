// The scan shared by nn_topk.cu, nn1_coords.cu and nn_bidir.cu: one query
// per thread against a whole reference cloud.
//
// The reference cloud goes through shared memory in tiles, walked in
// ascending index. Each thread keeps a sorted running top-K in registers (K
// is a template parameter so the arrays are fully unrolled) and inserts with
// strict '<', which equals K masked-argmin passes over the whole row: equal
// distances keep ascending index order, and no atomics are needed. Distances
// are channel-wise diff^2, summed (dx^2 + dy^2) + dz^2 (the order of the
// Pallas kernels' _sqdist_tile), which is never negative. With kCoords (K = 1
// only) the winner's coordinates are copied from the shared tile into
// registers at the moment it wins, so the caller issues no gather. Ragged
// sizes are masked, not padded. Built with -fmad=false so no sum is
// contracted into an FMA.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nn_scan {

constexpr int kMaxBlock = 128;  // queries per block, one per thread
constexpr int kTile = 1024;     // reference points per shared-memory tile

// Threads per block for n queries: a whole block, or the next multiple of 32
// above n for a small cloud (400 pairs of 20 points run as one-warp blocks).
inline int block_for(int n) {
  const int warps = ((n + 31) / 32) * 32;
  return warps < kMaxBlock ? warps : kMaxBlock;
}

// Query i of cloud `q` (n points; thread idle when i >= n, but it still
// helps to load the tiles) against cloud `r` (m points). Every thread of
// the block must call this. bd/bj come back ascending; slots past m hold
// (+inf, 0).
template <int K, bool kCoords>
__device__ __forceinline__ void scan(const float* __restrict__ q,
                                     const float* __restrict__ r, int i,
                                     int n, int m, float (&bd)[K],
                                     int (&bj)[K], float (&bc)[3]) {
  static_assert(!kCoords || K == 1, "coordinates are kept for K = 1 only");
  __shared__ float4 tile[kTile];
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (i < n) {
    qx = q[3 * i];
    qy = q[3 * i + 1];
    qz = q[3 * i + 2];
  }
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = INFINITY;
    bj[s] = 0;
  }
  bc[0] = bc[1] = bc[2] = 0.f;
  for (int t0 = 0; t0 < m; t0 += kTile) {
    const int cnt = min(kTile, m - t0);
    __syncthreads();
    for (int k = threadIdx.x; k < cnt; k += blockDim.x) {
      const float* p = r + 3 * (size_t)(t0 + k);
      tile[k] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
#pragma unroll(K == 1 ? 8 : 4)
    for (int k = 0; k < cnt; ++k) {
      const float4 p = tile[k];
      const float dx = qx - p.x;
      const float dy = qy - p.y;
      const float dz = qz - p.z;
      float d = dx * dx + dy * dy;
      d = d + dz * dz;
      if (d < bd[K - 1]) {
        bd[K - 1] = d;
        bj[K - 1] = t0 + k;
        if (kCoords) {
          bc[0] = p.x;
          bc[1] = p.y;
          bc[2] = p.z;
        }
#pragma unroll
        for (int s = K - 1; s > 0; --s) {
          if (bd[s] < bd[s - 1]) {  // strict: equal values keep index order
            const float td = bd[s];
            bd[s] = bd[s - 1];
            bd[s - 1] = td;
            const int tj = bj[s];
            bj[s] = bj[s - 1];
            bj[s - 1] = tj;
          }
        }
      }
    }
  }
}

}  // namespace nn_scan
