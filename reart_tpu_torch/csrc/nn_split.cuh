// The split-and-merge neighbour scan shared by blend3.cu and
// nn1_bidir_coords.cu.
//
// Serves reart_tpu/ops/pallas_nn.py: blend3_pallas / _blend3_kernel (the
// 3-NN flow blend) and nn1_bidir_coords_pallas / _nn1c_bidir_kernel (the
// bidirectional 1-NN with the winners' coordinates, the Chamfer forward).
//
// What bounds them on an H100: float32 issue rate. At the fit's (9, 4096,
// 4096) there are 151M (query, reference) pairs of a handful of float32
// operations each, while the clouds are under 2 MB. Built with -fmad=false
// no product is fused into an add, and the compare and select of a running
// minimum add 3-6 issue slots a pair, so 11-14 instructions a pair set the
// floor, not memory.
//
// What the design does about it: many independent scans in flight. The
// reference axis of a query is cut into contiguous pieces (blend3: S slices
// of one block; nn1_bidir_coords: column ranges of blocks and of threads)
// that are scanned in parallel, each with a strict '<' in ascending index,
// and the partial winners are merged in (distance, index) lexicographic
// order. That equals one strict '<' walk over the whole axis, which is the
// plain versions' masked-argmin rule: ties go to the lowest index, and the
// result does not depend on the order in which the pieces finish. Inside a
// block the merge goes through shared memory or warp shuffles; across blocks
// through one 64-bit atomicMin on key = (float bits of d) << 32 | index.
// Distances are never negative (clamped at 0, or sums of squares), so their
// bits order as unsigned integers and the smallest key is the smallest
// distance with the lowest index, whatever the order of arrival.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace nn_split {

typedef unsigned long long Key;

__device__ __forceinline__ float sqnorm(float x, float y, float z) {
  float s = x * x + y * y;
  return s + z * z;
}

// Channel-wise diff^2, summed (dx^2 + dy^2) + dz^2 (the order of the
// Pallas kernels' _sqdist_tile).
__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  float d = dx * dx + dy * dy;
  return d + dz * dz;
}

__device__ __forceinline__ Key make_key(float d, int j) {
  return (static_cast<Key>(__float_as_uint(d)) << 32) |
         static_cast<unsigned>(j);
}

__device__ __forceinline__ float key_dist(Key k) {
  return __uint_as_float(static_cast<unsigned>(k >> 32));
}

__device__ __forceinline__ int key_index(Key k) {
  return static_cast<int>(k & 0xffffffffu);
}

__device__ __forceinline__ Key key_min(Key a, Key b) { return a < b ? a : b; }

// The smallest key over the lanes whose ids differ only in the bits of
// `mask` (a power-of-two run of lanes), in every one of them.
template <int kMask>
__device__ __forceinline__ Key lane_min(Key k) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    if (kMask & off) k = key_min(k, __shfl_xor_sync(0xffffffffu, k, off));
  }
  return k;
}

// A running top-3 (d0 <= d1 <= d2) with its indices. Candidates come in
// ascending index among equal distances; strict '<' keeps the earlier one,
// so the list is the 3 smallest in (distance, index) order. Empty slots
// hold (+inf, 0).
struct Top3 {
  float d[3];
  int j[3];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      d[s] = INFINITY;
      j[s] = 0;
    }
  }

  __device__ __forceinline__ void insert(float x, int k) {
    if (x < d[2]) {
      if (x < d[1]) {
        d[2] = d[1];
        j[2] = j[1];
        if (x < d[0]) {
          d[1] = d[0];
          j[1] = j[0];
          d[0] = x;
          j[0] = k;
        } else {
          d[1] = x;
          j[1] = k;
        }
      } else {
        d[2] = x;
        j[2] = k;
      }
    }
  }
};

}  // namespace nn_split
