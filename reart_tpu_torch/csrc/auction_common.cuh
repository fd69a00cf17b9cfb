// Shared by auction.cu, auction_hbm.cu and auction_sweep.cu: the pieces of a
// Jacobi auction sweep that every kernel must do the same way, so that all
// of them and their plain PyTorch versions pick the same winners.
//
//   * bid keys: a bid and its row packed into 64 bits, (order-preserving bid
//     bits << 32) | ~row, so that one atomicMax per bid leaves on each
//     column the highest bid and, among equal bids, the lowest row,
//     whatever the order of arrival. 0 means "no bid";
//   * the warp-per-row top-2 of benefit - price: a lane walks its columns in
//     ascending order with strict '>' (the lowest column wins a tie inside a
//     lane), and the 32 lanes merge by shuffles under "larger value, then
//     lower column", which does not depend on the order of the merge.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace auction {

constexpr int kMaxEps = 8;

struct EpsList {
  float v[kMaxEps];
  int n;
};

// float -> uint32 that orders like the float
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(uint32_t o) {
  const uint32_t u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

__device__ __forceinline__ unsigned long long bid_key(float bid, int row) {
  return (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(row));
}

__device__ __forceinline__ float key_bid(unsigned long long k) {
  return from_ordered(static_cast<uint32_t>(k >> 32));
}

__device__ __forceinline__ int key_row(unsigned long long k) {
  return static_cast<int>(~static_cast<uint32_t>(k & 0xffffffffull));
}

// One more value of a lane's walk in ascending column order.
__device__ __forceinline__ void top2_take(float& b1, int& j1, float& b2,
                                          float v, int j) {
  if (v > b1) {
    b2 = b1;
    b1 = v;
    j1 = j;
  } else {
    b2 = fmaxf(b2, v);
  }
}

// (best value, its column, best value over the other columns) of another
// set of columns joins this one.
__device__ __forceinline__ void top2_merge(float& b1, int& j1, float& b2,
                                           float ob1, int oj1, float ob2) {
  if (ob1 > b1 || (ob1 == b1 && oj1 < j1)) {
    b2 = fmaxf(ob2, b1);
    b1 = ob1;
    j1 = oj1;
  } else {
    b2 = fmaxf(b2, ob1);
  }
}

// All 32 lanes hold a partial result; lane 0 ends with the row's.
__device__ __forceinline__ void top2_warp_merge(float& b1, int& j1,
                                                float& b2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob1 = __shfl_down_sync(0xffffffffu, b1, off);
    const int oj1 = __shfl_down_sync(0xffffffffu, j1, off);
    const float ob2 = __shfl_down_sync(0xffffffffu, b2, off);
    top2_merge(b1, j1, b2, ob1, oj1, ob2);
  }
}

// Top-2 of row[j] - price[j] over j < m by one warp; the result is lane 0's.
// j1 is INT_MAX when m == 0.
__device__ __forceinline__ void top2_row(const float* __restrict__ row,
                                         const float* price, int m, int lane,
                                         float& b1, int& j1, float& b2) {
  b1 = -INFINITY;
  b2 = -INFINITY;
  j1 = INT_MAX;
#pragma unroll 4
  for (int j = lane; j < m; j += 32) {
    top2_take(b1, j1, b2, row[j] - price[j], j);
  }
  top2_warp_merge(b1, j1, b2);
}

}  // namespace auction
